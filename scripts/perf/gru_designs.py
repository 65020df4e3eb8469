"""The GRU forward's two designs up to H = 512 timed against each other at
chosen shapes, on one CUDA card.

    python3 scripts/perf/gru_designs.py [D,B,T,H ...] [--phases]
                                        [--json OUT]

The port's kernel (``csrc/gru.cu``) picks its design by shape
(``gru_fwd_cluster_takes`` in ``csrc/gru_cluster.cuh``): the thread-block
cluster design (H = 256 and 512) or the wgmma rows design
(``csrc/gru_rows.cuh``). This probe compiles ``gru.cu`` with one more
entry point, ``probe_gru_scan_as``, which runs the forward under the
design it is told, into a library of its own under ``build/probes/``; the
port's library has no such entry point. At every shape (by default a
sweep of row tiles of 16 around the crossing at H = 256 and 512, T = 500,
51 and 11) it times both designs (median of 5 CUDA-event times after 2
warm-up calls), names the design the rule takes (``gru_designs``) and the
faster one, and prints one JSON line of the rows; ``--phases`` also
prints the rows design's SM cycles a step by phase (block (0, 0)'s first
thread, ``clock64``: the wait for the peers' chunks of the state, the
product, the wait for xw, the gate math, the barriers before the
exchange, the exchange's bulk copies, the stores of y; from a library of
its own built with ``GRU_ROWS_TIMING``); ``--json`` also writes them to
a file. The card's name and power limit come first. ``chip_smoke.py``
uses :func:`scan_as` to hold both designs against the plain version.
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

// pbsed_gru_scan under the design named (1: the cluster design, H = 256
// or 512; 0: the wgmma rows design), whatever gru_fwd_cluster_takes says
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

# the same with the rows design's steps timed by phase (GRU_ROWS_TIMING in
# csrc/gru_rows.cuh), into a library of its own
PHASES_SOURCE = '#define GRU_ROWS_TIMING\n' + SOURCE + r'''
// cycles of block (0, 0)'s thread 0 in each phase of the rows design's
// steps since the last call (then reset)
extern "C" int probe_rows_phases(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_rows_phase, sizeof(g_rows_phase));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long zero[kRowsPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_rows_phase, zero, sizeof(zero)));
}
'''
# the phases, in the order of csrc/gru_rows.cuh's ROWS_STAMP
PHASES = ('h_wait', 'product', 'xw_wait', 'gates', 'sync', 'push', 'y')

# the designs probe_gru_scan_as runs, by its code
DESIGNS = {'wgmma_rows': 0, 'cluster': 1}


# (D, B, T, H): row tiles of 16 (D * ceil(B / 16)) from 4 to 2 500 at
# T = 500 (tagging), 51 and 11 (sliding-window SED) at H = 256, and from
# 4 to 2 000 at H = 512
SWEEP = [(2, 32, 500, 256), (2, 64, 500, 256), (2, 128, 500, 256),
         (20, 32, 500, 256), (20, 64, 500, 256), (20, 96, 500, 256),
         (20, 144, 500, 256), (20, 192, 500, 256), (2, 2048, 500, 256),
         (2, 32, 51, 256), (2, 128, 51, 256), (2, 256, 51, 256),
         (2, 512, 51, 256), (2, 1024, 51, 256), (2, 1536, 51, 256),
         (2, 1792, 51, 256), (2, 4096, 51, 256), (20, 2000, 51, 256),
         (2, 16000, 51, 256), (2, 32, 11, 256), (2, 256, 11, 256),
         (2, 512, 11, 256), (2, 1536, 11, 256), (2, 8000, 11, 256),
         (2, 32, 500, 512), (2, 64, 500, 512), (6, 32, 500, 512),
         (2, 256, 500, 512), (2, 32, 51, 512), (2, 256, 51, 512),
         (2, 1024, 51, 512), (2, 4096, 51, 512), (2, 16000, 51, 512)]

_libs = {}


def library(phases=False):
    """The probe's library (with ``phases`` the one whose rows design
    times its steps by phase), built at first use (named by a hash of the
    probe's source, the port's sources and the flags)."""
    if phases in _libs:
        return _libs[phases]
    from pb_sed_tpu_torch.ops.kernels import build
    source = PHASES_SOURCE if phases else SOURCE
    digest = hashlib.sha256(source.encode())
    digest.update(' '.join(build.NVCC_FLAGS).encode())
    for src in sorted(build.CSRC_DIR.glob('*.cu*')):
        digest.update(src.read_bytes())
    path = BUILD / f'gru_designs_{digest.hexdigest()[:16]}.so'
    if not path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        src = path.with_suffix('.cu')
        src.write_text(source)
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
    if phases:
        lib.probe_rows_phases.argtypes = (p,)
        lib.probe_rows_phases.restype = i
    _libs[phases] = lib
    return lib


def scan_as(design, xw, w_hh, b_hh, h0, phases=False):
    """``gru_scan(xw, w_hh, b_hh, h0)`` on the card under ``design`` (a
    key of ``DESIGNS``; with ``phases`` on the library that times the
    rows design's steps); not counted in ``build.LAUNCHES``."""
    if design not in DESIGNS:
        raise ValueError(f'design {design!r}: one of {sorted(DESIGNS)}')
    d, b, t, g = xw.shape
    xw16 = xw.to(torch.bfloat16).contiguous()
    w16 = w_hh.to(torch.bfloat16).contiguous()
    b32 = b_hh.float().contiguous()
    h32 = h0.float().contiguous()
    y = torch.empty((d, b, t, g // 3), dtype=torch.float32, device=xw.device)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    rc = library(phases).probe_gru_scan_as(
        xw16.data_ptr(), w16.data_ptr(), b32.data_ptr(), h32.data_ptr(),
        y.data_ptr(), d, b, t, g // 3, DESIGNS[design], stream)
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


def rows_phases(d, b, t, h, seed=0):
    """{phase: SM cycles a step} of the rows design at (D, B, T, H):
    block (0, 0)'s thread 0, clock64 at the ends of the phases of every
    step (``PHASES``), after a warm-up run."""
    import numpy as np
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = (torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
                torch.bfloat16),
            torch.randn(d, h, 3 * h, generator=gen, device=dev) * h ** -.5,
            torch.randn(d, 3 * h, generator=gen, device=dev) * .1,
            torch.zeros(d, b, h, device=dev))
    out = np.zeros(len(PHASES), np.int64)
    for _ in range(2):
        scan_as('wgmma_rows', *args, phases=True)
        torch.cuda.synchronize()
        rc = library(True).probe_rows_phases(out.ctypes.data)
        if rc:
            raise RuntimeError(f'probe_rows_phases: CUDA error {rc}')
    return {name: float(v) / t for name, v in zip(PHASES, out)}


def time_designs(d, b, t, h, seed=0):
    """{design_ms: ms} of both designs at (D, B, T, H) (the cluster design
    only at H = 256 and 512), with ``takes`` (the rule's design),
    ``tiles16`` (D * ceil(B / 16)) and ``faster``."""
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
    names = ['wgmma_rows'] + (['cluster'] if h in (256, 512) else [])
    for design in names:
        row[f'{design}_ms'] = cuda_ms(
            lambda: scan_as(design, xw, w_hh, b_hh, h0))
    row['faster'] = min(names, key=lambda k: row[f'{k}_ms'])
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('shapes', nargs='*',
                        help='D,B,T,H each (default: the sweep)')
    parser.add_argument('--json', type=Path)
    parser.add_argument('--phases', action='store_true',
                        help="also print the rows design's SM cycles a step"
                             ' by phase (a library of its own)')
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
        times = ', '.join(f'{k[:-3]} {v:.3f} ms' for k, v in r.items()
                          if k.endswith('_ms'))
        print(f'{tuple(shape)} ({r["tiles16"]} tiles of 16): {times}; the '
              f'rule takes {r["takes"]}, the faster is {r["faster"]}',
              flush=True)
        if args.phases:
            r['rows_phases'] = rows_phases(*shape)
            print(f'{tuple(shape)} rows design, SM cycles a step by phase: '
                  + json.dumps({k: round(v) for k, v in
                                r['rows_phases'].items()}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({'card': card, 'rows': rows}), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({'card': card, 'rows': rows}))


if __name__ == '__main__':
    main()
