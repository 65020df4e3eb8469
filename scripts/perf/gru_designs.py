"""The GRU forward's two designs timed against each other at chosen shapes,
on one CUDA card.

    python3 scripts/perf/gru_designs.py [D,B,T,H ...] [--json OUT]

The port's kernel (``csrc/gru.cu``) picks its design by shape
(``gru_cluster_takes`` in ``csrc/gru_cluster.cuh``): the thread-block
cluster design or the row-tiled kernel. This probe compiles ``gru.cu``
with one more entry point, ``probe_gru_scan_as``, which runs the forward
under the design it is told, into a library of its own under
``build/probes/``; the port's library has no such entry point. At every
shape (H = 256 by default over a sweep of row tiles of 16 around the
rule's limit, at T = 500, 51 and 11) it times both designs (median of 5
CUDA-event times after 2 warm-up calls), names the design the rule takes
(``gru_designs``) and the faster one, and prints one JSON line of the
rows; ``--json`` also writes them to a file. The card's name and power
limit come first. ``chip_smoke.py`` uses :func:`scan_as` to hold both
designs against the plain version.
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / 'build' / 'probes'

SOURCE = r'''
#include "gru.cu"

// pbsed_gru_scan under the design named (cluster != 0: the cluster
// design, H = 256 or 512; 0: row-tiled), whatever gru_cluster_takes says
extern "C" int probe_gru_scan_as(const void* xw, const void* w_hh,
                                 const void* b_hh, const void* h0, void* y,
                                 int D, int B, int T, int H, int cluster,
                                 void* stream) {
  if (H % 32 != 0 || H < 32 || H > 512 || D < 1 || D > 65535 ||
      (cluster != 0 && H != 256 && H != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  return static_cast<int>(gru_scan_design(xw, w_hh, b_hh, h0, y, D, B, T, H,
                                          cluster != 0,
                                          static_cast<cudaStream_t>(stream)));
}
'''

# (D, B, T, H): row tiles of 16 (D * ceil(B / 16)) from 64 to 2 500 at
# T = 500 (tagging), 51 and 11 (sliding-window SED), densest where the
# two designs cross (160-256 tiles)
SWEEP = [(20, 64, 500, 256), (20, 96, 500, 256), (40, 48, 500, 256),
         (2, 1024, 500, 256), (20, 128, 500, 256), (40, 64, 500, 256),
         (20, 144, 500, 256), (2, 1536, 500, 256), (12, 256, 500, 256),
         (20, 160, 500, 256), (20, 176, 500, 256), (2, 1792, 500, 256),
         (20, 192, 500, 256), (2, 2048, 500, 256), (20, 256, 500, 256),
         (2, 512, 51, 256), (20, 64, 51, 256), (20, 96, 51, 256),
         (2, 1024, 51, 256), (20, 128, 51, 256), (2, 1280, 51, 256),
         (2, 1536, 51, 256), (4, 768, 51, 256), (2, 1792, 51, 256),
         (4, 896, 51, 256), (2, 2048, 51, 256), (4, 1024, 51, 256),
         (2, 4096, 51, 256), (4, 4000, 51, 256), (20, 2000, 51, 256),
         (4, 512, 11, 256), (2, 1536, 11, 256), (2, 1792, 11, 256),
         (4, 4000, 11, 256)]

_lib = None


def library():
    """The probe's library, built at first use (named by a hash of the
    probe's source, the port's sources and the flags)."""
    global _lib
    if _lib is not None:
        return _lib
    from pb_sed_tpu_torch.ops.kernels import build
    digest = hashlib.sha256(SOURCE.encode())
    digest.update(' '.join(build.NVCC_FLAGS).encode())
    for src in sorted(build.CSRC_DIR.glob('gru*')):
        digest.update(src.read_bytes())
    path = BUILD / f'gru_designs_{digest.hexdigest()[:16]}.so'
    if not path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        src = path.with_suffix('.cu')
        src.write_text(SOURCE)
        tmp = path.with_suffix('.tmp')
        run = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, '-I', str(build.CSRC_DIR),
             '-shared', '-o', str(tmp), str(src)],
            capture_output=True, text=True, check=False)
        if run.returncode:
            raise RuntimeError(f'nvcc failed ({run.returncode}):\n'
                               f'{run.stdout}{run.stderr}')
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_gru_scan_as.argtypes = (p,) * 5 + (i,) * 5 + (p,)
    lib.probe_gru_scan_as.restype = i
    _lib = lib
    return lib


def scan_as(design, xw, w_hh, b_hh, h0):
    """``gru_scan(xw, w_hh, b_hh, h0)`` on the card under ``design``
    ('cluster' or 'row_tiled'); not counted in ``build.LAUNCHES``."""
    if design not in ('cluster', 'row_tiled'):
        raise ValueError(f'design {design!r}: cluster or row_tiled')
    d, b, t, g = xw.shape
    xw16 = xw.to(torch.bfloat16).contiguous()
    w16 = w_hh.to(torch.bfloat16).contiguous()
    b32 = b_hh.float().contiguous()
    h32 = h0.float().contiguous()
    y = torch.empty((d, b, t, g // 3), dtype=torch.float32, device=xw.device)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    rc = library().probe_gru_scan_as(
        xw16.data_ptr(), w16.data_ptr(), b32.data_ptr(), h32.data_ptr(),
        y.data_ptr(), d, b, t, g // 3, int(design == 'cluster'), stream)
    if rc:
        raise RuntimeError(f'probe_gru_scan_as ({design}) at {(d, b, t)}: '
                           f'CUDA error {rc}')
    return y


def cuda_ms(fn, reps=5, warmup=2):
    """Median ms of ``fn()`` (CUDA events)."""
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


def time_designs(d, b, t, h, seed=0):
    """{design: ms} of both designs at (D, B, T, H), with ``takes`` (the
    rule's design) and ``tiles16`` (D * ceil(B / 16))."""
    from pb_sed_tpu_torch.ops.kernels.gru import gru_designs
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
        torch.bfloat16)
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device=dev) * h ** -.5
    b_hh = torch.randn(d, 3 * h, generator=gen, device=dev) * .1
    h0 = torch.zeros(d, b, h, device=dev)
    row = {'shape': [d, b, t, h], 'tiles16': d * -(-b // 16),
           'takes': gru_designs(d, b, t, h)['fwd']['design']}
    for design in ('cluster', 'row_tiled'):
        row[f'{design}_ms'] = cuda_ms(
            lambda: scan_as(design, xw, w_hh, b_hh, h0))
    row['faster'] = min(('cluster', 'row_tiled'),
                        key=lambda k: row[f'{k}_ms'])
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('shapes', nargs='*',
                        help='D,B,T,H each (default: the sweep)')
    parser.add_argument('--json', type=Path)
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f'card: {card}', flush=True)
    shapes = ([tuple(map(int, s.split(','))) for s in args.shapes]
              or SWEEP)
    rows = []
    for shape in shapes:
        rows.append(time_designs(*shape))
        r = rows[-1]
        print(f'{tuple(shape)} ({r["tiles16"]} tiles of 16): cluster '
              f'{r["cluster_ms"]:.3f} ms, row-tiled {r["row_tiled_ms"]:.3f}'
              f' ms; the rule takes {r["takes"]}, the faster is '
              f'{r["faster"]}', flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({'card': card, 'rows': rows}), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({'card': card, 'rows': rows}))


if __name__ == '__main__':
    main()
