"""Time the GRU's grid design (``csrc/gru_grid.cuh``) on the card.

    python3 scripts/perf/gru_grid_probe.py [--at-2048 | --variants
                                            [D,B,T,H ...]]

With no option it runs ``chip_smoke.py``'s grid kernel checks alone
(``check_grid_kernels``: each pass against its plain version, its time,
cuDNN's and the bounds, and the GRU shapes no record had timed).
``--at-2048`` times the grid forward at (2, 32, 500, 2048) beside the
design of 16 blocks (``csrc/gru_cluster_wide.cuh``) that the wrappers
run there, kernels alone, on the same operands. ``--variants`` times the
grid forward at the shapes given (default (2, 32, 500, 2304) and (2, 32,
500, 4096)) in variants of ``gru.cu`` built from copies of ``csrc`` with
``gru_grid.cuh``'s text edited, each into its own library under
``build/probes/``, kernel alone (``torch.profiler``), beside the
unedited kernel: what a step spends on its parts.

- ``kernel``: the kernel as it is;
- ``no_sync``: no grid barrier (the blocks race: wrong outputs);
- ``no_b``: no B piece streamed (the products on stale shared memory);
- ``no_a``: no A piece copied (the same);
- ``no_mma``: no products;
- ``stages_3``, ``stages_8``: a ring of 3 or 8 stages, more or less
  resident (a plan that does not fit shared memory fails its launch:
  printed as the variant's error);
- ``no_epilogue``: no gate math (nothing stored);
- ``ring_only``: the ring's and the barrier's turn-around alone: no
  copies, products or gate math.

Run from the repository's root.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke  # noqa: E402
from pb_sed_tpu_torch.ops.kernels import build  # noqa: E402
from pb_sed_tpu_torch.ops.kernels import gru as K  # noqa: E402

def grid_as(xw16, w16, b32, h32):
    """The grid forward kernel on operands at a multiple of 64 (any H,
    2048 too)."""
    d, b, t, g3 = xw16.shape
    h = g3 // 3
    dev = xw16.device
    ws = K._grid_workspace(d, b, h, dev)
    wp = K.pack_grid(w16)
    y = torch.empty((d, b, t, h), dtype=torch.float32, device=dev)
    build.launch('gru_scan', 'pbsed_gru_scan_grid', dev, xw16.data_ptr(),
                 wp.data_ptr(), b32.data_ptr(), h32.data_ptr(), y.data_ptr(),
                 ws.data_ptr(), d, b, t, h)
    return y


def wide_as(xw16, w16, b32, h32):
    """The design of 16 blocks at H = 2048 (packed w_hh), kernel only."""
    d, b, t, g3 = xw16.shape
    h = g3 // 3
    y = torch.empty((d, b, t, h), dtype=torch.float32, device=xw16.device)
    wp = K.pack_wide(w16)
    build.launch('gru_scan', 'pbsed_gru_scan', xw16.device, xw16.data_ptr(),
                 wp.data_ptr(), b32.data_ptr(), h32.data_ptr(), y.data_ptr(),
                 d, b, t, h)
    return y


def at_2048(d=2, b=32, t=500):
    """Grid against the design of 16 blocks at H = 2048, kernels alone on
    the same operands, both within the ceiling of the plain version."""
    h = 2048
    gen = torch.Generator(device='cuda').manual_seed(27)
    xw = torch.randn(d, b, t, 3 * h, generator=gen,
                     device='cuda').to(torch.bfloat16)
    w16 = (torch.randn(d, h, 3 * h, generator=gen, device='cuda')
           * h ** -.5).to(torch.bfloat16)
    b32 = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
    h32 = torch.zeros(d, b, h, device='cuda')
    ref = K.gru_scan_plain(xw, w16, b32, h32)
    out = {'shape': (d, b, t, h)}
    for name, fn in (('grid', grid_as), ('cluster_of_16', wide_as)):
        err = float((fn(xw, w16, b32, h32) - ref).abs().max())
        assert err <= 5.3e-3, (name, err)
        out[f'{name}_kernel_ms'] = chip_smoke._kernel_alone(
            lambda: fn(xw, w16, b32, h32))
    return out


VARIANTS = {
    'kernel': [],
    'no_sync': [('  __syncthreads();\n  if (threadIdx.x == 0) {\n    '
                 '__threadfence();',
                 '  __syncthreads();\n  if (counter == nullptr) {\n    '
                 '__threadfence();')],
    'no_b': [('    const bool resident = cc * KC + kc < nres;',
              '    const bool resident = nres >= 0;')],
    'no_a': [('      wide_bar_expect(bar, L.off_b +',
              '      wide_bar_expect(bar, 0 * L.off_b +'),
             ('      tma_load_3d(st, a.map, bar, 64 * kc,',
              '      if (kc < 0) tma_load_3d(st, a.map, bar, 64 * kc,')],
    'no_mma': [('    grid_mma<MODE, NG>(acc, sa,',
                '    if (kc < 0) grid_mma<MODE, NG>(acc, sa,')],
    'stages_3': [('constexpr int kGridStages = 5;',
                  'constexpr int kGridStages = 3;')],
    'stages_8': [('constexpr int kGridStages = 5;',
                  'constexpr int kGridStages = 8;')],
    'no_epilogue': [('      epi(rt, cc, ct, acc);',
                     '      if (ct < 0) epi(rt, cc, ct, acc);')],
    'ring_only': [('      wide_bar_expect(bar, L.off_b +',
                   '      wide_bar_expect(bar, 0 * L.off_b +'),
                  ('      tma_load_3d(st, a.map, bar, 64 * kc,',
                   '      if (kc < 0) tma_load_3d(st, a.map, bar, 64 * kc,'),
                  ('    const bool resident = cc * KC + kc < nres;',
                   '    const bool resident = nres >= 0;'),
                  ('    grid_mma<MODE, NG>(acc, sa,',
                   '    if (kc < 0) grid_mma<MODE, NG>(acc, sa,'),
                  ('      epi(rt, cc, ct, acc);',
                   '      if (ct < 0) epi(rt, cc, ct, acc);')],
}
PROBES = Path(__file__).resolve().parents[2] / 'build' / 'probes'


def build_variants(names):
    """{variant: gru.cu built with gru_grid.cuh edited, loaded}, all
    compiled at once."""
    nvcc = build._nvcc()
    procs = {}
    for name in names:
        src = PROBES / f'gru_grid_{name}'
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        header = src / 'gru_grid.cuh'
        text = header.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f'{name}: the kernel text to edit is '
                                   f'gone:\n{old}')
            text = text.replace(old, new)
        header.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, '-shared', '-o', str(src / 'lib.so'),
             str(src / 'gru.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc failed\n{out[-3000:]}')
        lib = ctypes.CDLL(str(PROBES / f'gru_grid_{name}' / 'lib.so'))
        lib.pbsed_gru_scan_grid.argtypes = build._SIGNATURES[
            'pbsed_gru_scan_grid']
        libs[name] = lib
    return libs


def variants(shapes, names):
    """Each variant's forward kernel alone at each shape (the median of 3
    profiled calls), and its largest distance from the plain version."""
    libs = build_variants(names)
    out = []
    for shape in shapes:
        d, b, t, h = shape
        gen = torch.Generator(device='cuda').manual_seed(28)
        xw = torch.randn(d, b, t, 3 * h, generator=gen, device='cuda',
                         dtype=torch.bfloat16)
        w16 = (torch.randn(d, h, 3 * h, generator=gen, device='cuda')
               * h ** -.5).to(torch.bfloat16)
        b32 = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
        h32 = torch.zeros(d, b, h, device='cuda')
        wp = K.pack_grid(w16)
        ws = K._grid_workspace(d, b, h, xw.device)
        y = torch.empty((d, b, t, h), device='cuda')
        ref = K.gru_scan_plain(xw, w16, b32, h32)
        row = {'shape': shape}
        for name, lib in libs.items():
            def call():
                stream = torch.cuda.current_stream().cuda_stream
                rc = lib.pbsed_gru_scan_grid(
                    xw.data_ptr(), wp.data_ptr(), b32.data_ptr(),
                    h32.data_ptr(), y.data_ptr(), ws.data_ptr(), d, b, t, h,
                    stream)
                if rc:
                    raise RuntimeError(f'{name}: CUDA error {rc}')
            try:
                call()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                row[name] = {'error': str(exc)}
                continue
            err = float((y - ref).abs().nan_to_num(1e9).max())
            times = sorted(chip_smoke._kernel_alone(call) for _ in range(3))
            row[name] = {'kernel_ms': times[1],
                         'us_a_step': 1e3 * times[1] / t, 'max_err': err}
        print('gru grid variants (JSON): ' + json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv):
    card = chip_smoke.phase_card()
    shapes = [tuple(map(int, a.split(','))) for a in argv
              if not a.startswith('--')]
    if '--variants' in argv:
        variants(shapes or [(2, 32, 500, 2304), (2, 32, 500, 4096)],
                 list(VARIANTS))
    elif '--at-2048' in argv:
        print('gru grid at 2048 (JSON): ' + json.dumps(at_2048()), flush=True)
    else:
        chip_smoke.check_grid_kernels(
            {name: chip_smoke.new_record() for name in chip_smoke.KERNELS})
    print(card)


if __name__ == '__main__':
    main(sys.argv[1:])
