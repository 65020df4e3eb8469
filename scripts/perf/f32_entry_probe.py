"""What the f32 entry kernels spend their time on, on one CUDA card.

    python3 scripts/perf/f32_entry_probe.py [--variants a,b,...] [--json OUT]

The f32 conv's entry kernels (``csrc/conv2d_f32_entry.cuh``: the
forward-type GEMM, which runs the forward and the dx of a layer with
Cin < 16, and the dw pass) take each product of f32 operands as three
``mma.sync`` m16n8k8 .tf32 products on operands split into a TF32 hi and
lo part. This probe builds variants of ``conv2d_f32.cu`` from a copy of
``csrc`` with the header's text edited, each into its own library under
``build/probes/``, and at the recipes' three entry layers (B = 32, T =
500, F = 128: shallow 1 -> 16, deep 1 -> 32, BiCRNN 11 -> 16) times each
variant's forward, dx and dw (``torch.profiler`` device time of each
kernel, 5 calls after a warm-up; the dw with its reduce):

- ``kernel``: the kernels as they are;
- ``cvt_split``: the activations split by two ``cvt.rna.tf32`` (lo
  rounded too) in place of the kernels' integer operations (hi the f32
  bits + 0x1000 with the low 13 bits cleared, lo = v - hi left for the
  tensor cores to truncate);
- ``no_split``: the activations not split (hi the f32 value itself, lo
  zero): the split's three operations a value gone, the products kept;
- ``hi_hi``: one product a k8 step (hi*hi) in place of three;
- ``no_products``: no ``mma.sync`` (the operands kept live): the copies,
  loads, splits, sums and stores without products;
- ``no_copies``: no halo or gy copies after the first tile (the tiles
  computed from stale shared memory): the products without the stream.

Each variant's outputs are held against the plain versions (2e-5 of the
largest entry for forward and dx, 1e-4 for dw) and the fraction of the
gate printed beside its times (only ``kernel`` and ``cvt_split`` compute
the function). It prints the card's name and power limit, a line per
layer (and, for ``kernel``, each entry kernel's launch as the profiler's
trace records it: grid, block, registers, shared memory, estimated
occupancy) and one JSON line of them all.
"""
import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / 'build' / 'probes'
sys.path.insert(0, str(REPO))

from pb_sed_tpu_torch.ops.kernels import build  # noqa: E402
from pb_sed_tpu_torch.ops.kernels.conv import (  # noqa: E402
    conv2d_same_f32_bwd_plain, conv2d_same_f32_plain)

HEADER = 'conv2d_f32_entry.cuh'
INT_SPLIT = '''  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));'''
CVT_SPLIT = '''  tf32_split(v, hi, lo);'''
FIRST = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));'''
NEXT = '''  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
# the products' operands folded into the sums by integer ops, no mma.sync
FAKE_FIRST = '''  d[0] = __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) * 0.f;
  d[1] = d[2] = d[3] = 0.f;'''
FAKE_NEXT = '''  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) * 0.f;'''
FWD_NEXT_COPY = '''    if (tile + gridDim.x < tiles)
      stage(tile + gridDim.x, static_cast<int>((it + 1) & 1));'''
DW_NEXT_COPY = '''    if (tile + kF32eDwStages - 1 < t_end)
      stage_tile(tile + kF32eDwStages - 1,'''
LO_HI = '''              mma_tf32_next(d[h][j], alo[h], __float_as_uint(bw[h][j].x),
                            __float_as_uint(bw[h][j].y));'''
HI_LO_FIRST = '''              mma_tf32_first(d[h][j], ahi[h], __float_as_uint(bw[h][j].z),
                             __float_as_uint(bw[h][j].w));'''
DW_LO_HI = '''            mma_tf32_next(d[h][j][mt], alo[h][mt], bhi[h][j][0],
                          bhi[h][j][1]);'''
DW_FIRST = '''            mma_tf32_first(d[h][j][mt], ahi[h][mt], blo[h][j][0],
                           blo[h][j][1]);'''
VARIANTS = {
    'kernel': [],
    'cvt_split': [(INT_SPLIT, CVT_SPLIT)],
    'no_split': [(INT_SPLIT, '''  hi = __float_as_uint(v);
  lo = 0u;''')],
    # hi*hi alone: the first product takes hi and the other two are gone
    'hi_hi': [(HI_LO_FIRST, HI_LO_FIRST.replace('.z', '.x').replace(
                   '.w)', '.y)')),
              (LO_HI, '              ;'),
              ('''              mma_tf32_next(d[h][j], ahi[h], __float_as_uint(bw[h][j].x),
                            __float_as_uint(bw[h][j].y));''', '              ;'),
              (DW_FIRST, DW_FIRST.replace('blo[', 'bhi[')),
              (DW_LO_HI, '            ;'),
              ('''            mma_tf32_next(d[h][j][mt], ahi[h][mt], bhi[h][j][0],
                          bhi[h][j][1]);''', '            ;')],
    'no_products': [(FIRST, FAKE_FIRST), (NEXT, FAKE_NEXT)],
    'no_copies': [(FWD_NEXT_COPY, '    if (false)\n      stage(0, 0);'),
                  (DW_NEXT_COPY, '    if (false)\n      stage_tile(0,')],
}
LAYERS = [('shallow L0', 128, 1, 16), ('deep L0', 128, 1, 32),
          ('BiCRNN L0', 128, 11, 16)]
BATCH, FRAMES = 32, 500


def build_variants(names):
    """{variant: loaded library}, all compiled at once."""
    nvcc = build._nvcc()
    procs = {}
    for name in names:
        src = BUILD / f'f32_entry_{name}'
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        header = src / HEADER
        text = header.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f'{name}: the kernel text to edit is gone:'
                                   f'\n{old}')
            text = text.replace(old, new)
        header.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, '-shared', '-o', str(src / 'lib.so'),
             str(src / 'conv2d_f32.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'{name}: nvcc failed\n{out[-3000:]}')
        lib = ctypes.CDLL(str(BUILD / f'f32_entry_{name}' / 'lib.so'))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pbsed_conv2d_same_f32.argtypes = (p,) * 5 + (i,) * 8 + (p,)
        lib.pbsed_conv2d_same_f32_bwd.argtypes = (p,) * 7 + (i,) * 8 + (p,)
        lib.pbsed_conv2d_f32_dw_chunks.argtypes = (i,) * 8
        lib.pbsed_conv2d_f32_split_floats.argtypes = (i,) * 7
        lib.pbsed_conv2d_f32_split_floats.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def launch_args(trace):
    """{kernel: its launch's grid, block, registers, shared memory and the
    profiler's estimated occupancy} of the entry kernels in a chrome
    trace."""
    found = {}
    for event in json.loads(Path(trace).read_text()).get('traceEvents', []):
        name = event.get('name', '')
        if event.get('cat') == 'kernel' and 'entry' in name:
            args = event.get('args', {})
            found[name.replace('void (anonymous namespace)::', '')[:60]] = {
                key: args.get(key) for key in (
                    'grid', 'block', 'registers per thread',
                    'shared memory', 'blocks per SM', 'warps per SM',
                    'est. achieved occupancy %')}
    return found


def device_ms(fn, reps=5, trace=None):
    """{kernel family: device ms a call} (torch.profiler); with ``trace``
    the profile is also written there as a chrome trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = {}
        for event in prof.key_averages():
            if event.device_type != DeviceType.CUDA:
                continue
            us = getattr(event, 'self_device_time_total', None)
            if us is None:
                us = getattr(event, 'self_cuda_time_total', 0.)
            key = event.key
            part = ('dw' if 'dw_entry' in key or 'dw_reduce' in key
                    else 'gemm' if 'f32_entry_kernel' in key
                    else 'split' if 'split' in key else 'other')
            parts[part] = parts.get(part, 0.) + us / 1e3 / reps
        if parts:
            if trace:
                prof.export_chrome_trace(str(trace))
            return parts
    raise RuntimeError('the profiler recorded no device kernel')


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--variants', default=','.join(VARIANTS))
    parser.add_argument('--json')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('f32_entry_probe.py needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(args.variants.split(','))
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for layer, f, cin, cout in LAYERS:
        x = torch.randn(BATCH, FRAMES, f, cin, generator=gen, device=dev)
        w = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * (
            9 * cin) ** -.5
        w_flip = w.flip(0, 1).transpose(2, 3).contiguous()
        gy = torch.randn(BATCH, FRAMES, f, cout, generator=gen, device=dev)
        y = torch.empty(BATCH, FRAMES, f, cout, device=dev)
        dx = torch.empty_like(x)
        dw = torch.empty(3, 3, cin, cout, device=dev)
        ref_y = conv2d_same_f32_plain(x, w, None)
        ref_dx, ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)
        row = {}
        for name, lib in libs.items():
            chunks = lib.pbsed_conv2d_f32_dw_chunks(BATCH, FRAMES, f, cin,
                                                    cout, 3, 3, sms)
            ws = torch.empty(chunks * 9 * cin * cout, device=dev)
            split = torch.empty(max(
                lib.pbsed_conv2d_f32_split_floats(p, f, cin, cout, 3, 3, 1)
                for p in (0, 1)), device=dev)

            def fwd():
                if lib.pbsed_conv2d_same_f32(
                        x.data_ptr(), w.data_ptr(), None, y.data_ptr(),
                        split.data_ptr(), 1, BATCH, FRAMES, f, cin, cout, 3,
                        3, stream):
                    raise RuntimeError(f'{name}: forward failed')

            def bwd():
                if lib.pbsed_conv2d_same_f32_bwd(
                        x.data_ptr(), gy.data_ptr(), w_flip.data_ptr(),
                        dx.data_ptr(), dw.data_ptr(), ws.data_ptr(),
                        split.data_ptr(), BATCH, FRAMES, f, cin, cout, 3, 3,
                        sms, stream):
                    raise RuntimeError(f'{name}: backward failed')

            fwd()
            bwd()
            torch.cuda.synchronize()
            trace = BUILD / f'f32_entry_{name}' / 'trace.json'
            fwd_parts = device_ms(fwd, trace=trace)
            launches = launch_args(trace)
            bwd_parts = device_ms(bwd, trace=trace)
            launches.update(launch_args(trace))
            if name == 'kernel':
                print(f'{layer} launches: {json.dumps(launches)}',
                      flush=True)
            row[name] = {
                'fwd_ms': fwd_parts.get('gemm', 0.),
                'dx_ms': bwd_parts.get('gemm', 0.),
                'dw_ms': bwd_parts.get('dw', 0.),
                'fwd_gate': float((y - ref_y).abs().max())
                / (2e-5 * float(ref_y.abs().max())),
                'dx_gate': float((dx - ref_dx).abs().max())
                / (2e-5 * float(ref_dx.abs().max())),
                'dw_gate': float((dw - ref_dw).abs().max())
                / (1e-4 * float(ref_dw.abs().max()))}
        results[layer] = row
        print(f'{layer} ({f}, {cin} -> {cout}): ' + '; '.join(
            f'{name} fwd {v["fwd_ms"]:.4f} dx {v["dx_ms"]:.4f} dw '
            f'{v["dw_ms"]:.4f} ms (gates {v["fwd_gate"]:.3f} / '
            f'{v["dx_gate"]:.3f} / {v["dw_gate"]:.4f})'
            for name, v in row.items()), flush=True)
        del x, gy, dx, ref_y, ref_dx, ref_dw
        torch.cuda.empty_cache()
    print(json.dumps(results))
    if args.json:
        Path(args.json).write_text(json.dumps(results, indent=1))


if __name__ == '__main__':
    main()
