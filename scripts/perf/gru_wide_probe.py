"""What a step of the GRU's cluster design above H = 512 spends its time on,
on one CUDA card.

    python3 scripts/perf/gru_wide_probe.py [--json OUT]

The design (``csrc/gru_cluster_wide.cuh``) keeps the first k-tiles of each
block's slice of w_hh in shared memory and streams the rest from L2 every
step through a ring of ``ring_tiles`` k-tiles filled by bulk copies. This probe
compiles ``gru.cu`` with entry points of its own into a library under
``build/probes/`` and, at (2, 32, T, H) for H = 768, 1024 and 2048, times
(median of 5 CUDA-event times after 2 warm-up calls, per serial step):

- ``fwd``: the forward kernel at rings of 4 to 16 k-tiles (the port's
  layout takes 4), each held against the plain version;
- ``fwd_no_product``: the same with no warp multiplying (its output is
  not used): the step less its gate product;
- ``ring``: the forward's ring alone, the same fetches, waits and block
  barriers a step without products, gate math or exchange;
- ``ring_barrier``: the ring and the step's cluster barrier;
- ``barrier``: the cluster barrier alone, T of them.

It prints the card's name and power limit, a line per measurement and one
JSON line of them all.
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
sys.path.insert(0, str(REPO))

SOURCE = r'''
#include "gru.cu"

namespace {

// the forward's ring alone: per step NCH stages through wide_next, and
// with `barrier` the step's cluster barrier; with stages 0 only barriers
__global__ void __launch_bounds__(kClThreads, 1)
probe_ring_kernel(const __nv_bfloat16* __restrict__ w_hh, int T, int H,
                  const WideLayout L, int stages, int barrier) {
  extern __shared__ __align__(128) unsigned char smem[];
  const __nv_bfloat16* wp =
      w_hh + (static_cast<size_t>(blockIdx.y) * kWideBlocks + cl_rank()) *
                 H * L.lds;
  const WideA no_a = {nullptr, 0, 0};
  WideRing ring;
  wide_ring_init(smem, L);
  __syncthreads();
  if (stages) wide_ring_start(smem, ring, wp, L, H, 16, no_a);
  cl_arrive();
  cl_wait();
  for (int t = 0; t < T; ++t) {
    if (stages)
      for (int c = 0; c < L.NCH; ++c)
        wide_next(smem, ring, wp, L, H, 16, no_a);
    if (barrier) {
      cl_arrive();
      cl_wait();
    }
  }
  if (stages) wide_ring_drain(smem, ring, L);
}

}  // namespace

// the forward (16 rows a cluster) with a ring of at most ring_tiles k-tiles;
// with no_product set, no warp multiplies (NT = 0: wrong results, the rest
// of the step's time)
extern "C" int probe_wide_fwd(const void* xw, const void* w_hh,
                              const void* b_hh, const void* h0, void* y,
                              int D, int B, int T, int H, int ring_tiles,
                              int no_product, void* stream) {
  WideLayout L = wide_layout(H, 16, false, ring_tiles);
  if (no_product) L.NT = 0;
  if (!gru_wide_takes(H) || L.smem > kWideSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kWideBlocks * ((B + 15) / 16), D);
  cudaError_t err;
#define PROBE_LAUNCH(UPL)                                                    \
  err = gru_cluster_config(gru_scan_wide_cluster_kernel<1, UPL>, kWideBlocks, \
                           L.smem, grid, s, &cfg, &attr);                    \
  if (err == cudaSuccess)                                                    \
    err = cudaLaunchKernelEx(&cfg, gru_scan_wide_cluster_kernel<1, UPL>,     \
                             static_cast<const __nv_bfloat16*>(xw),          \
                             static_cast<const __nv_bfloat16*>(w_hh),        \
                             static_cast<const float*>(b_hh),                \
                             static_cast<const float*>(h0),                  \
                             static_cast<float*>(y), B, T, H, L);
  switch (wide_units_a_lane(H)) {
    case 2: PROBE_LAUNCH(2) break;
    case 3: PROBE_LAUNCH(3) break;
    default: PROBE_LAUNCH(4) break;
  }
#undef PROBE_LAUNCH
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int probe_wide_ring(const void* w_hh, int D, int B, int T, int H,
                               int ring_tiles, int stages, int barrier,
                               void* stream) {
  const WideLayout L = wide_layout(H, 16, false, ring_tiles);
  if (!gru_wide_takes(H) || L.smem > kWideSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = gru_cluster_config(
      probe_ring_kernel, kWideBlocks, L.smem,
      dim3(kWideBlocks * ((B + 15) / 16), D), static_cast<cudaStream_t>(stream),
      &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, probe_ring_kernel,
                             static_cast<const __nv_bfloat16*>(w_hh), T, H, L,
                             stages, barrier);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
'''

RINGS = (4, 8, 12)
SHAPES = [(2, 32, 200, 768), (2, 32, 200, 1024), (2, 32, 50, 2048)]

_lib = None


def library():
    """The probe's library, built at first use (named by a hash of the
    probe's source, the port's GRU sources and the flags)."""
    global _lib
    if _lib is not None:
        return _lib
    from pb_sed_tpu_torch.ops.kernels import build
    digest = hashlib.sha256(SOURCE.encode())
    digest.update(' '.join(build.NVCC_FLAGS).encode())
    for src in sorted(build.CSRC_DIR.glob('gru*')):
        digest.update(src.read_bytes())
    path = BUILD / f'gru_wide_probe_{digest.hexdigest()[:16]}.so'
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
    lib.probe_wide_fwd.argtypes = (p,) * 5 + (i,) * 6 + (p,)
    lib.probe_wide_ring.argtypes = (p,) + (i,) * 7 + (p,)
    lib.probe_wide_fwd.restype = lib.probe_wide_ring.restype = i
    _lib = lib
    return lib


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


def _call(fn, *args):
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f'{fn.__name__} {args[-6:]}: CUDA error {rc}')


def probe(d, b, t, h, rings=RINGS, seed=0):
    """{measurement: us a step} at (D, B, T, H)."""
    from pb_sed_tpu_torch.ops.kernels.gru import gru_scan_plain, pack_wide
    lib = library()
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(seed)
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
        torch.bfloat16)
    w_hh = (torch.randn(d, h, 3 * h, generator=gen, device=dev)
            * h ** -.5).to(torch.bfloat16)
    b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device=dev)
    h0 = torch.zeros(d, b, h, device=dev)
    y = torch.empty(d, b, t, h, device=dev)
    ref = gru_scan_plain(xw, w_hh, b_hh, h0)
    w_hh = pack_wide(w_hh)
    out = {}
    for ring in rings:
        args = (xw.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                h0.data_ptr(), y.data_ptr(), d, b, t, h, ring, 0)
        try:
            _call(lib.probe_wide_fwd, *args)
        except RuntimeError as err:
            print(f'{(d, b, t, h)} ring {ring}: {err}', flush=True)
            continue
        torch.cuda.synchronize()
        errmax = float((y - ref).abs().max())
        if not errmax <= 5.3e-3:
            raise AssertionError(f'ring {ring} at {(d, b, t, h)}: {errmax}')
        us = {'fwd': cuda_ms(lambda: _call(lib.probe_wide_fwd, *args)),
              'fwd_no_product': cuda_ms(lambda: _call(
                  lib.probe_wide_fwd, *args[:-1], 1))}
        for name, stages, barrier in (('ring', 1, 0), ('ring_barrier', 1, 1)):
            us[name] = cuda_ms(lambda: _call(
                lib.probe_wide_ring, w_hh.data_ptr(), d, b, t, h, ring,
                stages, barrier))
        us = {key: 1e3 * ms / t for key, ms in us.items()}
        out[f'ring {ring}'] = us
        print(f'{(d, b, t, h)} ring {ring}: ' + ', '.join(
            f'{key} {v:.2f} us' for key, v in us.items()), flush=True)
    barrier = 1e3 * cuda_ms(lambda: _call(
        lib.probe_wide_ring, w_hh.data_ptr(), d, b, t, h, 12, 0, 1)) / t
    out['barrier'] = barrier
    print(f'{(d, b, t, h)} cluster barrier alone: {barrier:.2f} us',
          flush=True)
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--json')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('gru_wide_probe.py needs a CUDA card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f'card: {card}', flush=True)
    found = {str(shape): probe(*shape) for shape in SHAPES}
    line = json.dumps({'card': card, 'us_a_step': found})
    print(line)
    if args.json:
        Path(args.json).write_text(line + '\n')


if __name__ == '__main__':
    main()
