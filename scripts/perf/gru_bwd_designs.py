"""The GRU backward's two designs up to H = 256 timed against each other
at chosen shapes, on one CUDA card.

    python3 scripts/perf/gru_bwd_designs.py [D,B,T,H ...] [--phases]
                                            [--dgates] [--json OUT]

The port's split backward (``csrc/gru_bwd.cu``) picks its design by shape
(``gru_cluster_takes`` in ``csrc/gru_cluster.cuh``): the thread-block
cluster design (``csrc/gru_bwd_cluster.cuh``, H = 256 and 512) or the
wgmma rows design (``csrc/gru_bwd_rows.cuh``, H up to 256). This probe
compiles ``gru_bwd.cu`` with one more entry point,
``probe_gru_bwd_as``, which runs the sweep (without the wrapper's
weight-gradient contraction) under the design it is told, into a library
of its own under ``build/probes/``; the port's library has no such entry
point. At every shape (by default row tiles of 16 from 4 to 64 at
(2, B, 500, 256), and the training shape at H = 64 to 224) it times the
rows design, the cluster design where H = 256, and below 256 the
cluster design at 256 on the operands padded with zero units (what the
wrapper runs where ``kernel_hidden`` pads to 256): the median of 5
CUDA-event times after 2 warm-up calls, with the rule's design
(``gru_designs``) and the faster one, and prints one JSON line of the
rows; ``--phases`` also prints the rows design's SM cycles a step by
phase (block (0, 0)'s first thread, ``clock64``, from a library of its
own built with ``GRU_ROWS_BWD_TIMING``: the wait for the peers' partials
of dh, their sum and the cluster barrier's arrive, the gate math on the
chain, the cluster barrier's wait and the dh product into the send slots,
the block barrier, the bulk copies and the TMA stores of dxw and r, the
wait for h_prev, the gate recompute, the wait for xw, the next step's
gate factors, the closing barrier); ``--dgates`` also times, up to H = 192, the
exchange of bf16 dgates in place of f32 partials of dh
(``gru_bwd_dgates.cuh`` beside this script, built into the probe's
library only), after holding its dxw, r and dh0 against the rows
design's (5.3e-3 of each one's largest entry); ``--json`` also writes
them to a file. The card's
name and power limit come first.
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
BUILD = REPO / 'build' / 'probes'

SOURCE = r'''
#include "gru_bwd.cu"
#include "gru_bwd_dgates.cuh"

// pbsed_gru_scan_bwd under the design named (1: the cluster design,
// H = 256 or 512; 2: the wgmma rows design, H up to 256; 3: the rows
// design exchanging bf16 dgates, H up to 192), whatever gru_cluster_takes
// says
extern "C" int probe_gru_bwd_as(const void* xw, const void* h_prev,
                                const void* w_hh, const void* b_hh,
                                const void* g, void* dxw, void* r, void* dh0,
                                int D, int B, int T, int H, int design,
                                void* stream) {
  if (H % 32 != 0 || H < 32 || D < 1 || D > 65535 || B < 1 || T < 1 ||
      (design == 1 && H != 256 && H != 512) || (design == 2 && H > 256) ||
      design < 1 || design > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 3)
    return static_cast<int>(
        gru_bwd_dgx(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, D, B, T, H, s));
  int rows = 0;
  if (design == 1)
    return static_cast<int>(bwd_cluster<false>(
        xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, nullptr, nullptr, nullptr, D,
        B, T, H, s, &rows));
  return static_cast<int>(gru_bwd_rows<false>(xw, h_prev, w_hh, b_hh, g, dxw,
                                              r, dh0, nullptr, nullptr,
                                              nullptr, D, B, T, H, s));
}
'''

# the same with the rows design's steps timed by phase
# (GRU_ROWS_BWD_TIMING in csrc/gru_bwd_rows.cuh), into a library of its own
PHASES_SOURCE = '#define GRU_ROWS_BWD_TIMING\n' + SOURCE + r'''
// cycles of block (0, 0)'s thread 0 in each phase of the rows design's
// steps since the last call (then reset)
extern "C" int probe_rows_bwd_phases(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_rows_bwd_phase,
                                         sizeof(g_rows_bwd_phase));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long zero[kRowsBwdPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(g_rows_bwd_phase, zero, sizeof(zero)));
}
'''
# the phases, in the order of csrc/gru_bwd_rows.cuh's ROWS_BWD_STAMP
PHASES = ('dh_wait', 'dh_sum', 'gates', 'product', 'push', 'h_wait',
          'recompute', 'xw_wait', 'factors', 'sync')

# the designs probe_gru_bwd_as runs, by its code (3: the dgates exchange)
DESIGNS = {'cluster': 1, 'wgmma_rows': 2, 'dgates': 3}

# (D, B, T, H): the training shape at H = 256 and past it, 4 to 64 row
# tiles of 16 (around the cluster design's limit, kClMaxTiles16), and the
# training shape below 256
SWEEP = [(2, 32, 500, 256), (2, 64, 500, 256), (2, 96, 500, 256),
         (2, 128, 500, 256), (2, 240, 500, 256), (2, 256, 500, 256),
         (2, 288, 500, 256), (2, 512, 500, 256),
         (2, 32, 500, 64), (2, 32, 500, 96), (2, 32, 500, 128),
         (2, 32, 500, 160), (2, 32, 500, 192), (2, 32, 500, 224)]

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
    for src in (sorted(build.CSRC_DIR.glob('*.cu*'))
                + [HERE / 'gru_bwd_dgates.cuh']):
        digest.update(src.read_bytes())
    path = BUILD / f'gru_bwd_designs_{digest.hexdigest()[:16]}.so'
    if not path.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        src = path.with_suffix('.cu')
        src.write_text(source)
        tmp = path.with_suffix('.tmp')
        run = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, '-I', str(build.CSRC_DIR),
             '-I', str(HERE), '-shared', '-o', str(tmp), str(src)],
            capture_output=True, text=True, check=False)
        if run.returncode:
            raise RuntimeError(f'nvcc failed ({run.returncode}):\n'
                               f'{run.stdout}{run.stderr}')
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_gru_bwd_as.argtypes = (p,) * 8 + (i,) * 5 + (p,)
    lib.probe_gru_bwd_as.restype = i
    if phases:
        lib.probe_rows_bwd_phases.argtypes = (p,)
        lib.probe_rows_bwd_phases.restype = i
    _libs[phases] = lib
    return lib


def operands(d, b, t, h, hp=None, seed=0):
    """The sweep's operands at (D, B, T, H) as the wrapper hands them to
    the kernel (bf16 xw, w_hh and h_prev, f32 b_hh and g), padded with
    zero units to ``hp``, and empty outputs (dxw, r, dh0)."""
    from pb_sed_tpu_torch.ops.kernels import gru as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
        torch.bfloat16)
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device=dev) * h ** -.5
    b_hh = torch.randn(d, 3 * h, generator=gen, device=dev) * .1
    h0 = torch.zeros(d, b, h, device=dev)
    # states in the range a GRU's take; the sweep's time does not depend
    # on them
    y = .5 * torch.tanh(torch.randn(d, b, t, h, generator=gen, device=dev))
    g = 1e-2 * torch.randn(d, b, t, h, generator=gen, device=dev)
    hp = hp or h
    xw, w16, b32, h0, y, g = (a.contiguous() for a in K.pad_hidden(
        xw, w_hh.to(torch.bfloat16), b_hh, h0, y, g, hp=hp))
    h_prev = K._h_prev(h0, y)
    dxw = torch.empty_like(xw)
    r = torch.empty_like(h_prev)
    dh0 = torch.empty(d, b, hp, device=dev)
    return (xw, h_prev, w16, b32, g), (dxw, r, dh0)


def bwd_as(design, inputs, outputs, phases=False):
    """The sweep under ``design`` (a key of ``DESIGNS``) on prepared
    operands (:func:`operands`; with ``phases`` on the library that times
    the rows design's steps); not counted in ``build.LAUNCHES``."""
    xw = inputs[0]
    d, b, t, g3 = xw.shape
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    rc = library(phases).probe_gru_bwd_as(
        *(a.data_ptr() for a in (*inputs, *outputs)), d, b, t, g3 // 3,
        DESIGNS[design], stream)
    if rc:
        raise RuntimeError(f'probe_gru_bwd_as ({design}) at {(d, b, t)}: '
                           f'CUDA error {rc}')


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
    inputs, outputs = operands(d, b, t, h, seed=seed)
    out = np.zeros(len(PHASES), np.int64)
    for _ in range(2):
        bwd_as('wgmma_rows', inputs, outputs, phases=True)
        torch.cuda.synchronize()
        rc = library(True).probe_rows_bwd_phases(out.ctypes.data)
        if rc:
            raise RuntimeError(f'probe_rows_bwd_phases: CUDA error {rc}')
    return {name: float(v) / t for name, v in zip(PHASES, out)}


def time_designs(d, b, t, h, seed=0, dgates=False):
    """{design_ms: ms} at (D, B, T, H): the rows design, the cluster
    design at H = 256 (``cluster_ms``) or below it at 256 on padded
    operands (``cluster_256_ms``), with ``dgates`` up to H = 192 the
    dgates exchange (``dgates_ms``, and ``dgates_err``: its largest
    difference from the rows design in dxw, r and dh0, each as a share of
    that output's largest entry), with ``takes`` (the rule's design and
    width for the split backward), ``tiles16`` and ``faster``."""
    from pb_sed_tpu_torch.ops.kernels.gru import gru_designs
    bwd = gru_designs(d, b, t, h)['bwd']
    row = {'shape': [d, b, t, h], 'tiles16': d * -(-b // 16),
           'takes': f'{bwd["design"]} at {bwd["hidden"]}'}
    inputs, outputs = operands(d, b, t, h, seed=seed)
    row['wgmma_rows_ms'] = cuda_ms(
        lambda: bwd_as('wgmma_rows', inputs, outputs))
    if dgates and h <= 192:
        bwd_as('wgmma_rows', inputs, outputs)
        want = [o.float().clone() for o in outputs]
        bwd_as('dgates', inputs, outputs)
        row['dgates_err'] = max(
            float((o.float() - w).abs().max() / w.abs().max().clamp_min(
                1e-30)) for o, w in zip(outputs, want))
        if not row['dgates_err'] <= 5.3e-3:
            raise AssertionError(f'the dgates exchange at {(d, b, t, h)} '
                                 f'differs by {row["dgates_err"]}')
        row['dgates_ms'] = cuda_ms(lambda: bwd_as('dgates', inputs, outputs))
    if h == 256:
        row['cluster_ms'] = cuda_ms(lambda: bwd_as('cluster', inputs,
                                                   outputs))
    elif h < 256:
        del inputs, outputs
        inputs, outputs = operands(d, b, t, h, hp=256, seed=seed)
        row['cluster_256_ms'] = cuda_ms(
            lambda: bwd_as('cluster', inputs, outputs))
    row['faster'] = min((k for k in row if k.endswith('_ms')),
                        key=row.get)[:-3]
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('shapes', nargs='*',
                        help='D,B,T,H each (default: the sweep)')
    parser.add_argument('--json', type=Path)
    parser.add_argument('--dgates', action='store_true',
                        help='also time the dgates exchange (H <= 192)')
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
        rows.append(time_designs(*shape, dgates=args.dgates))
        r = rows[-1]
        times = ', '.join(f'{k[:-3]} {v:.3f} ms' for k, v in r.items()
                          if k.endswith('_ms'))
        print(f'{tuple(shape)} ({r["tiles16"]} tiles of 16): {times} '
              f'({1e3 * r["wgmma_rows_ms"] / shape[2]:.2f} us a step on '
              f'the rows design); the rule takes {r["takes"]}, the faster '
              f'is {r["faster"]}', flush=True)
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
