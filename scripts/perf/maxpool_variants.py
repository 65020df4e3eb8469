"""Designs of the (2, 1) max-pool forward, timed against each other on one
CUDA card.

    python3 scripts/perf/maxpool_variants.py [--rounds 3]

Compiles the CUDA source below with ``nvcc`` into ``build/probes/`` and
times each design at the 8 pools of the shallow and deep towers (B = 32,
T = 500) by replaying a CUDA graph of 20 launches (the device's time
without the host's), the designs in a shuffled order, ``--rounds`` times
each; it reports the best time per pool and design, the sums over the 8
pools and their share of the bound (bytes at 3.35 TB/s). Every design is
checked bit-exact against ``torch.maximum`` first. The designs:

- ``grid_stride``: one 16-byte vector of each row a thread, 64-bit
  positions, a grid of one block per 256 vectors, default caching (the
  port's earlier kernel);
- ``vec32`` / ``vec32_hints``: the same with 32-bit positions, without or
  with streaming cache hints (``__ldcs`` / ``__stcs``; ``vec32_hints`` is
  the port's kernel, ``csrc/maxpool.cu``);
- ``vec32_u2`` / ``vec32_u4``: 2 or 4 vectors of each row a thread, all
  loads before the compares;
- ``wave_u4`` / ``wave_u4_nohints`` / ``wave_u8``: a grid of one wave of
  the blocks the card holds at once, each thread looping over 4 or 8
  vectors of each row with 32-bit positions advanced without a divide;
- ``halves``: not a pool, the same traffic as one plain stream (read the
  two halves of the input, write one): what the card gives it.
"""
import argparse
import random
import subprocess
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
BUILD = REPO / 'build' / 'probes'
POOLS = [(128, 16), (64, 32), (32, 64), (16, 128), (128, 32), (64, 64),
         (32, 128), (16, 256)]
HBM_BYTES_PER_S = 3.35e12

SOURCE = r'''
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ __nv_bfloat16 max_bf16(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  const float fa = __bfloat162float(a), fb = __bfloat162float(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fa < fb ? b : a;
}

__device__ __forceinline__ uint4 max8(uint4 a, uint4 b) {
  const __nv_bfloat16* pa = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* pb = reinterpret_cast<const __nv_bfloat16*>(&b);
  uint4 out;
  __nv_bfloat16* po = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) po[i] = max_bf16(pa[i], pb[i]);
  return out;
}

__global__ void __launch_bounds__(256)
grid_stride(const uint4* __restrict__ x, uint4* __restrict__ y,
            long long rows, int V) {
  const long long n = rows * V;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * 256) {
    const long long r = e / V;
    const int v = static_cast<int>(e % V);
    y[e] = max8(x[2 * r * V + v], x[(2 * r + 1) * V + v]);
  }
}

template <int U, bool HINTS>
__global__ void __launch_bounds__(256)
vec32(const uint4* __restrict__ x, uint4* __restrict__ y, int n, int V) {
  const int base = blockIdx.x * 256 * U + threadIdx.x;
  uint4 a[U], b[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int e = base + j * 256;
    if (e < n) {
      const uint4* p = x + e + (e / V) * V;
      a[j] = HINTS ? __ldcs(p) : p[0];
      b[j] = HINTS ? __ldcs(p + V) : p[V];
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int e = base + j * 256;
    if (e < n) {
      const uint4 o = max8(a[j], b[j]);
      if (HINTS)
        __stcs(y + e, o);
      else
        y[e] = o;
    }
  }
}

template <int U, bool HINTS>
__global__ void __launch_bounds__(256)
wave(const uint4* __restrict__ x, uint4* __restrict__ y, int rows, int V) {
  const int stride = gridDim.x * 256;
  const int dr = stride / V, dv = stride - dr * V;
  const int e0 = blockIdx.x * 256 + threadIdx.x;
  int r = e0 / V, v = e0 - r * V;
  while (r < rows) {
    uint4 a[U], b[U];
    int at[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      at[j] = -1;
      if (r < rows) {
        const uint4* p = x + 2 * r * V + v;
        a[j] = HINTS ? __ldcs(p) : p[0];
        b[j] = HINTS ? __ldcs(p + V) : p[V];
        at[j] = r * V + v;
      }
      r += dr;
      v += dv;
      if (v >= V) {
        v -= V;
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (at[j] >= 0) {
        const uint4 o = max8(a[j], b[j]);
        if (HINTS)
          __stcs(y + at[j], o);
        else
          y[at[j]] = o;
      }
    }
  }
}

__global__ void __launch_bounds__(256)
halves(const uint4* __restrict__ x, uint4* __restrict__ y, int n) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < n) __stcs(y + e, max8(__ldcs(x + e), __ldcs(x + e + n)));
}

template <typename K>
static int one_wave(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, 0);
  return sms * per_sm;
}

// design: the index in DESIGNS (maxpool_variants.py); x (rows, 2, V) and
// y (rows, V) vectors of 16 bytes, 2 rows V < 2^31
extern "C" int pool_design(int design, const void* xp, void* yp, int rows,
                           int V, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* x = static_cast<const uint4*>(xp);
  uint4* y = static_cast<uint4*>(yp);
  const int n = rows * V;
  const int blocks = (n + 255) / 256;
  switch (design) {
    case 0: grid_stride<<<blocks, 256, 0, s>>>(x, y, rows, V); break;
    case 1: vec32<1, false><<<blocks, 256, 0, s>>>(x, y, n, V); break;
    case 2: vec32<1, true><<<blocks, 256, 0, s>>>(x, y, n, V); break;
    case 3: vec32<2, true><<<(n + 511) / 512, 256, 0, s>>>(x, y, n, V); break;
    case 4: vec32<4, true><<<(n + 1023) / 1024, 256, 0, s>>>(x, y, n, V); break;
    case 5: {
      const int w = one_wave(wave<4, true>);
      wave<4, true><<<blocks < w ? blocks : w, 256, 0, s>>>(x, y, rows, V);
      break;
    }
    case 6: {
      const int w = one_wave(wave<4, false>);
      wave<4, false><<<blocks < w ? blocks : w, 256, 0, s>>>(x, y, rows, V);
      break;
    }
    case 7: {
      const int w = one_wave(wave<8, true>);
      wave<8, true><<<blocks < w ? blocks : w, 256, 0, s>>>(x, y, rows, V);
      break;
    }
    case 8: halves<<<blocks, 256, 0, s>>>(x, y, n); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
'''
DESIGNS = ['grid_stride', 'vec32', 'vec32_hints', 'vec32_u2', 'vec32_u4',
           'wave_u4', 'wave_u4_nohints', 'wave_u8', 'halves']


def build():
    import ctypes
    BUILD.mkdir(parents=True, exist_ok=True)
    src = BUILD / 'maxpool_variants.cu'
    lib = BUILD / 'libmaxpool_variants.so'
    src.write_text(SOURCE)
    subprocess.run(['/usr/local/cuda/bin/nvcc', '-gencode',
                    'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
                    '-shared', '-Xcompiler', '-fPIC', '-o', str(lib),
                    str(src)], check=True)
    loaded = ctypes.CDLL(str(lib))
    loaded.pool_design.argtypes = (ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p)
    loaded.pool_design.restype = ctypes.c_int
    return loaded


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--rounds', type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError('maxpool_variants.py needs a CUDA card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f'card: {card}', flush=True)
    lib = build()
    rng = random.Random(0)
    gen = torch.Generator(device='cuda').manual_seed(0)
    sums = dict.fromkeys(DESIGNS, 0.)
    bound_sum = 0.
    for f, c in POOLS:
        x = torch.randn(32, 500, f, c, generator=gen, device='cuda').to(
            torch.bfloat16)
        y = torch.empty(32, 500, f // 2, c, dtype=x.dtype, device='cuda')
        ref = torch.maximum(x[:, :, 0::2], x[:, :, 1::2])
        rows, vecs = 32 * 500 * f // 2, c // 8
        bound = 1e3 * 3 * x.numel() / HBM_BYTES_PER_S
        bound_sum += bound
        graphs = {}
        for d, name in enumerate(DESIGNS):
            def launch(d=d):
                rc = lib.pool_design(d, x.data_ptr(), y.data_ptr(), rows,
                                     vecs, torch.cuda.current_stream()
                                     .cuda_stream)
                if rc:
                    raise RuntimeError(f'{name}: CUDA error {rc}')
            launch()
            torch.cuda.synchronize()
            if name != 'halves' and not torch.equal(y.nan_to_num(),
                                                    ref.nan_to_num()):
                raise AssertionError(f'{name} differs from torch.maximum')
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(20):
                    launch()
            graphs[name] = graph
        times = {name: [] for name in DESIGNS}
        order = DESIGNS * args.rounds
        rng.shuffle(order)
        for name in order:
            graphs[name].replay()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[name].replay()
            stop.record()
            stop.synchronize()
            times[name].append(start.elapsed_time(stop) / 20)
        cells = []
        for name in DESIGNS:
            sums[name] += min(times[name])
            cells.append(f'{name} {min(times[name]):.4f}')
        print(f'(32, 500, {f}, {c}) bound {bound:.4f} ms: ' + ', '.join(cells),
              flush=True)
        del graphs
    print(f'summed over the 8 pools (bound {bound_sum:.4f} ms):')
    for name in DESIGNS:
        print(f'  {name}: {sums[name]:.4f} ms, share of the bound '
              f'{bound_sum / sums[name]:.3f}')


if __name__ == '__main__':
    main()
