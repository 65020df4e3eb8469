"""What the 3xTF32 f32 conv kernels spend their time on, on one CUDA card.

    python3 scripts/perf/f32_conv_probe.py [--json OUT]

The forward (and dx) kernel and the dw kernel of
``csrc/conv2d_f32_wgmma.cuh`` take a product of f32 operands as three TF32
wgmmas a k8 step (hi*lo, lo*hi, hi*hi) on A fragments each thread loads
from the staged halo tile and splits in registers. This probe builds
variants of ``conv2d_f32.cu`` from a copy of ``csrc`` with the kernels'
text edited, each into its own library under ``build/probes/``, and at
the shallow tower's 3x3 layers L1-L8 (B = 32, T = 500) times each
variant's forward and its dw pass (``pbsed_conv2d_same_f32_bwd`` without
dx; median of 5 CUDA-event times after 2 warm-up calls):

- ``kernel``: the kernels as they are;
- ``no_products``: no wgmma (the split A values kept live): the loads,
  the split, the rings, the waits and the epilogue, without products;
- ``hi_hi``: one wgmma a k8 step (hi*hi) in place of three;
- ``one_run``: the forward with one tensor-core sum a K slice at every
  BN (the kernel keeps the even and the odd k8 steps apart at BN <= 64);
- ``cvt_split``: the activations split by two ``cvt.rna.tf32`` (lo
  rounded too; the weights' split as it is) in place of
  ``tf32_split_act``'s integer operations.

Each variant's forward and dw are held against the plain versions
(``conv2d_same_f32_plain``, ``conv2d_same_f32_bwd_plain``, TF32 off): the
largest error as a fraction of its gate (2e-5 and 1e-4 of the largest
entry) is printed beside its times (only ``kernel``, ``one_run`` and
``cvt_split`` compute the function). It prints the card's name and power limit, a line
per layer and one JSON line of them all.
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

FWD_PRODUCTS = '''      wgmma_tf32<BN>(part[SET % PARTS], ahi[SET], dlo, fresh ? 0 : 1);
      wgmma_tf32<BN>(part[SET % PARTS], alo[SET], dhi, 1);
      wgmma_tf32<BN>(part[SET % PARTS], ahi[SET], dhi, 1);
'''
DW_PRODUCTS = '''      wgmma_tf32<BN>(part, ahi[SET], dlo, s == 0 ? 0 : 1);
      wgmma_tf32<BN>(part, alo[SET], dhi, 1);
      wgmma_tf32<BN>(part, ahi[SET], dhi, 1);
'''
KEEP = ('      asm volatile("" :: "r"(ahi[SET][0]), "r"(ahi[SET][1]), '
        '"r"(ahi[SET][2]), "r"(ahi[SET][3]), "r"(alo[SET][0]), '
        '"r"(alo[SET][1]), "r"(alo[SET][2]), "r"(alo[SET][3]));\n')
INT_SPLIT = '''  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));'''
VARIANTS = {
    'kernel': [],
    'no_products': [(FWD_PRODUCTS, KEEP), (DW_PRODUCTS, KEEP)],
    'hi_hi': [(FWD_PRODUCTS, '      wgmma_tf32<BN>(part[SET % PARTS], '
                             'ahi[SET], dhi, fresh ? 0 : 1);\n' + KEEP),
              (DW_PRODUCTS, '      wgmma_tf32<BN>(part, ahi[SET], dhi, '
                            's == 0 ? 0 : 1);\n' + KEEP)],
    'one_run': [('constexpr int PARTS = BN <= 64 ? 2 : 1;',
                 'constexpr int PARTS = 1;')],
    'cvt_split': [(INT_SPLIT, '  tf32_split(v, hi, lo);')],
}
LAYERS = [('L1', 128, 16, 16), ('L2', 64, 16, 32), ('L3', 64, 32, 32),
          ('L4', 32, 32, 64), ('L5', 32, 64, 64), ('L6', 16, 64, 128),
          ('L7', 16, 128, 128), ('L8', 8, 128, 256)]
BATCH, FRAMES = 32, 500


def build_variants():
    """{variant: loaded library}, all compiled at once."""
    nvcc = build._nvcc()
    procs = {}
    for name, edits in VARIANTS.items():
        src = BUILD / f'f32_conv_{name}'
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        header = src / 'conv2d_f32_wgmma.cuh'
        text = header.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f'{name}: the kernel text to edit is gone')
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
        lib = ctypes.CDLL(str(BUILD / f'f32_conv_{name}' / 'lib.so'))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pbsed_conv2d_same_f32.argtypes = (p,) * 5 + (i,) * 8 + (p,)
        lib.pbsed_conv2d_same_f32_bwd.argtypes = (p,) * 8 + (i,) * 9 + (p,)
        lib.pbsed_conv2d_f32_dw_chunks.argtypes = (i,) * 8
        libs[name] = lib
    return libs


def cuda_ms(fn, reps=5, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--json')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('f32_conv_probe.py needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for layer, f, cin, cout in LAYERS:
        x = torch.randn(BATCH, FRAMES, f, cin, generator=gen, device=dev)
        w = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * (
            9 * cin) ** -.5
        gy = torch.randn(BATCH, FRAMES, f, cout, generator=gen, device=dev)
        y = torch.empty(BATCH, FRAMES, f, cout, device=dev)
        dw = torch.empty(3, 3, cin, cout, device=dev)
        split = torch.empty(2 * 9 * cin * cout, device=dev)
        ref_y = conv2d_same_f32_plain(x, w, None)
        ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)[1]
        row = {}
        for name, lib in libs.items():
            chunks = lib.pbsed_conv2d_f32_dw_chunks(BATCH, FRAMES, f, cin,
                                                    cout, 3, 3, sms)
            ws = torch.empty(chunks * 9 * cin * cout, device=dev)

            def fwd():
                if lib.pbsed_conv2d_same_f32(
                        x.data_ptr(), w.data_ptr(), None, y.data_ptr(),
                        split.data_ptr(), 1, BATCH, FRAMES, f, cin, cout, 3,
                        3, stream):
                    raise RuntimeError(f'{name}: forward failed')

            def dw_pass():
                if lib.pbsed_conv2d_same_f32_bwd(
                        x.data_ptr(), gy.data_ptr(), None, None, None,
                        dw.data_ptr(), ws.data_ptr(), None, BATCH, FRAMES,
                        f, cin, cout, cout, 3, 3, sms, stream):
                    raise RuntimeError(f'{name}: dw failed')

            fwd()
            dw_pass()
            torch.cuda.synchronize()
            row[name] = {
                'fwd_ms': cuda_ms(fwd), 'dw_ms': cuda_ms(dw_pass),
                'fwd_gate': float((y - ref_y).abs().max())
                / (2e-5 * float(ref_y.abs().max())),
                'dw_gate': float((dw - ref_dw).abs().max())
                / (1e-4 * float(ref_dw.abs().max()))}
        results[layer] = row
        print(f'{layer} ({f}, {cin} -> {cout}): ' + ', '.join(
            f'{name} fwd {v["fwd_ms"]:.3f} ms dw {v["dw_ms"]:.3f} ms '
            f'(gates {v["fwd_gate"]:.3f} / {v["dw_gate"]:.4f})'
            for name, v in row.items()), flush=True)
        del x, gy, ref_y, ref_dw
        torch.cuda.empty_cache()
    sums = {name: {key: sum(results[layer][name][key] for layer in results)
                   for key in ('fwd_ms', 'dw_ms')} for name in VARIANTS}
    print('sums ' + json.dumps(sums), flush=True)
    out = {'layers': results, 'sums': sums}
    print(json.dumps(out))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
