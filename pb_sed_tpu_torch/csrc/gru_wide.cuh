// The wide design of the GRU recurrence, forward (gru.cu) and split
// backward (gru_bwd.cu), for hidden sizes above 512: the JAX package runs
// no Pallas kernel there but a lax.scan (pb_sed_tpu/ops/rnn.py:122-138,
// 188-205), with the same math and the port's rounding points (xw, h and
// w_hh into the product in bf16; gates, state and dh in f32).
//
// What stops the other two designs above H = 512: the cluster design keeps
// w_hh in the shared memory of at most 16 blocks (1.5 MiB at H = 512,
// 3.4 MiB of bf16 a direction at H = 768); the row-tiled one runs one
// thread per hidden unit (blockDim = H, 1024 at most) and keeps a row
// tile's f32 gates in shared memory (16 rows x 3H f32 is 96 KiB at
// H = 512, 384 KiB at H = 2048).
//
// What this design does: one block of 16 warps per (direction, tile of 16
// batch rows), whatever H. The hidden units are cut into chunks of 16;
// warp w takes chunks w, w + 16, ..., and for each runs the chunk's three
// 16-column gate tiles (r, z and n of the same units) as wmma products
// over K = H, with w_hh's fragments read from global memory (resident in
// L2 after the first step: 3.4 MiB a direction at H = 768, 24 MiB at
// H = 2048), then does the gate math of those 16 units x 16 rows from a
// small per-warp staging tile. So a thread touches only the units of its
// own chunks, at every step: the f32 state it needs is the one it wrote
// itself (y[t - 1], read back from global memory), and the backward's
// carried dh lives in dh0, read and written by the same thread. Only the
// bf16 state crosses warps: the forward keeps it double-buffered in
// shared memory (one barrier a step); the backward stages h_prev[t] rows
// there and writes the step's bf16 dgates to a global workspace of the
// block, which the dh product reads after a barrier (three barriers a
// step). Shared memory: 2 x 16 x (H + 8) bf16 + 48 KiB forward (177 KiB
// at H = 2048), 16 x (H + 8) bf16 + 48 KiB backward.
//
// What bounds it: every step each block reads all of w_hh from L2 (three
// times in the backward: the gate product and the dh product), so with
// few rows (B = 32: four blocks at D = 2) a step costs w_hh's bytes at
// the rate one SM's warps fetch wmma fragments, and the card's other SMs
// idle: ~19 GB/s, 179 us a step at H = 768 on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md). At H = 2048 two directions' w_hh (48 MiB) no longer
// sit in the 50 MB L2 with the rest, and a step reads part of it from
// device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kWideRows = 16;    // batch rows a block
constexpr int kWideWarps = 16;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideUnits = 16;   // hidden units a chunk
constexpr int kWidePad = 8;      // bf16 padding of a state row
constexpr int kWideLds = 3 * kWideUnits;  // f32 row stride of the staging
constexpr int kWideMinH = 512;   // the design takes H above this
constexpr int kWideMaxH = 2048;  // and up to this (H % 32 == 0)

using WideFragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                         __nv_bfloat16,
                                         nvcuda::wmma::row_major>;
using WideFragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                         __nv_bfloat16,
                                         nvcuda::wmma::row_major>;
using WideFragBT = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                          __nv_bfloat16,
                                          nvcuda::wmma::col_major>;
using WideFragC =
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float wide_sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

inline bool gru_wide_takes(int H) {
  return H > kWideMinH && H <= kWideMaxH && H % 32 == 0;
}

// The gate product of one chunk: st (16, 48) f32 <- a (16 rows, ld lda,
// K = H) @ w[:, {0, H, 2H} + u0 + [0, 16)], the r, z and n columns of the
// chunk's units side by side.
__device__ __forceinline__ void wide_gate_product(
    const __nv_bfloat16* a, int lda, const __nv_bfloat16* __restrict__ w,
    int H, int u0, float* st) {
  const int G = 3 * H;
  WideFragC acc[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) nvcuda::wmma::fill_fragment(acc[g], 0.f);
#pragma unroll 4
  for (int k = 0; k < H / 16; ++k) {
    WideFragA a_frag;
    nvcuda::wmma::load_matrix_sync(a_frag, a + k * 16, lda);
    const __nv_bfloat16* w_k = w + static_cast<size_t>(k) * 16 * G + u0;
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      WideFragB b_frag;
      nvcuda::wmma::load_matrix_sync(b_frag, w_k + g * H, G);
      nvcuda::wmma::mma_sync(acc[g], a_frag, b_frag, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
    nvcuda::wmma::store_matrix_sync(st + g * kWideUnits, acc[g], kWideLds,
                                    nvcuda::wmma::mem_row_major);
}

// Forward. grid (ceil(B / 16), D), kWideThreads threads. y is also the f32
// state: a thread reads back the y[t - 1] it wrote (so not __restrict__).
__global__ void __launch_bounds__(kWideThreads, 1)
gru_wide_fwd_kernel(const __nv_bfloat16* __restrict__ xw,    // (D, B, T, 3H)
                    const __nv_bfloat16* __restrict__ w_hh,  // (D, H, 3H)
                    const float* __restrict__ b_hh,          // (D, 3H)
                    const float* __restrict__ h0,            // (D, B, H)
                    float* y,                                // (D, B, T, H)
                    int B, int T, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  const int ldh = H + kWidePad;
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem);  // (2, 16, ldh)
  float* stage = reinterpret_cast<float*>(hb + 2 * kWideRows * ldh);
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kWideRows;
  const int rows = min(kWideRows, B - b0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* w = w_hh + static_cast<size_t>(d) * H * G;
  const float* bias = b_hh + static_cast<size_t>(d) * G;
  float* st = stage + warp * kWideRows * kWideLds;

  // copy 0 of the bf16 state: bf16(h0); rows past the batch (and all of
  // copy 1) zero, and they stay zero
  for (int e = threadIdx.x; e < kWideRows * ldh; e += kWideThreads) {
    const int r = e / ldh;
    const int k = e - r * ldh;
    const float v = (r < rows && k < H)
                        ? h0[(static_cast<size_t>(d) * B + b0 + r) * H + k]
                        : 0.f;
    hb[e] = __float2bfloat16(v);
    hb[kWideRows * ldh + e] = __float2bfloat16(0.f);
  }
  __syncthreads();

  const int chunks = H / kWideUnits;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* h_cur = hb + (t & 1) * kWideRows * ldh;
    __nv_bfloat16* h_next = hb + ((t & 1) ^ 1) * kWideRows * ldh;
    for (int c = warp; c < chunks; c += kWideWarps) {
      const int u0 = c * kWideUnits;
      wide_gate_product(h_cur, ldh, w, H, u0, st);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kWideRows * kWideUnits / 32; ++i) {
        const int e = lane + 32 * i;
        const int r = e / kWideUnits;
        const int u = e % kWideUnits;
        if (r < rows) {
          const int j = u0 + u;
          const size_t row = static_cast<size_t>(d) * B + b0 + r;
          const __nv_bfloat16* x_t = xw + (row * T + t) * G;
          const float hp = t == 0 ? h0[row * H + j] : y[(row * T + t - 1) * H + j];
          const float* s = st + r * kWideLds + u;
          const float rr =
              wide_sigmoid(__bfloat162float(x_t[j]) + (s[0] + bias[j]));
          const float zz = wide_sigmoid(__bfloat162float(x_t[H + j]) +
                                        (s[kWideUnits] + bias[H + j]));
          const float nn =
              tanhf(__bfloat162float(x_t[2 * H + j]) +
                    rr * (s[2 * kWideUnits] + bias[2 * H + j]));
          const float h = (1.f - zz) * nn + zz * hp;
          y[(row * T + t) * H + j] = h;
          h_next[r * ldh + j] = __float2bfloat16(h);
        }
      }
      __syncwarp();
    }
    // the new state is complete, and every warp is done with the old one
    __syncthreads();
  }
}

// Split backward, the reverse sweep (gru_bwd.cu's formulas). grid
// (ceil(B / 16), D), kWideThreads threads. dh0 carries dh through the
// sweep (each element read and written by one thread) and holds dh after
// t = 0 at the end. dg: this launch's workspace, (D * gridDim.x, 16, 3H)
// bf16, the step's dgates of each block's rows (written, then read as the
// dh product's A operand after a barrier: so not __restrict__).
__global__ void __launch_bounds__(kWideThreads, 1)
gru_wide_bwd_kernel(const __nv_bfloat16* __restrict__ xw,      // (D, B, T, 3H)
                    const __nv_bfloat16* __restrict__ h_prev,  // (D, B, T, H)
                    const __nv_bfloat16* __restrict__ w_hh,    // (D, H, 3H)
                    const float* __restrict__ b_hh,            // (D, 3H)
                    const float* __restrict__ g,               // (D, B, T, H)
                    __nv_bfloat16* __restrict__ dxw,           // (D, B, T, 3H)
                    __nv_bfloat16* __restrict__ r_out,         // (D, B, T, H)
                    float* dh0,                                // (D, B, H)
                    __nv_bfloat16* dg, int B, int T, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  const int ldh = H + kWidePad;
  __nv_bfloat16* hp = reinterpret_cast<__nv_bfloat16*>(smem);  // (16, ldh)
  float* stage = reinterpret_cast<float*>(hp + kWideRows * ldh);
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * kWideRows;
  const int rows = min(kWideRows, B - b0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* w = w_hh + static_cast<size_t>(d) * H * G;
  const float* bias = b_hh + static_cast<size_t>(d) * G;
  float* st = stage + warp * kWideRows * kWideLds;
  __nv_bfloat16* dgs =
      dg + (static_cast<size_t>(d) * gridDim.x + blockIdx.x) * kWideRows * G;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // rows past the batch stay zero in both products' A operands
  for (int e = threadIdx.x; e < kWideRows * ldh; e += kWideThreads)
    hp[e] = zero;
  for (int e = rows * G + threadIdx.x; e < kWideRows * G; e += kWideThreads)
    dgs[e] = zero;
  if (T == 0) {
    for (int e = threadIdx.x; e < rows * H; e += kWideThreads)
      dh0[(static_cast<size_t>(d) * B + b0) * H + e] = 0.f;
    return;
  }
  const int chunks = H / kWideUnits;
  const int row_chunks = H / 8;  // 16-byte chunks of one h_prev row
  for (int t = T - 1; t >= 0; --t) {
    for (int q = threadIdx.x; q < rows * row_chunks; q += kWideThreads) {
      const int r = q / row_chunks;
      const int k = q - r * row_chunks;
      const size_t src = ((static_cast<size_t>(d) * B + b0 + r) * T + t) * H;
      __pipeline_memcpy_async(hp + r * ldh + k * 8, h_prev + src + k * 8, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // the gates, recomputed from bf16 h_prev, and dxw, r, dgates, dh * z
    for (int c = warp; c < chunks; c += kWideWarps) {
      const int u0 = c * kWideUnits;
      wide_gate_product(hp, ldh, w, H, u0, st);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kWideRows * kWideUnits / 32; ++i) {
        const int e = lane + 32 * i;
        const int r = e / kWideUnits;
        const int u = e % kWideUnits;
        if (r < rows) {
          const int j = u0 + u;
          const size_t row = static_cast<size_t>(d) * B + b0 + r;
          const size_t idx = row * T + t;
          const __nv_bfloat16* x_t = xw + idx * G;
          const float* s = st + r * kWideLds + u;
          const float hn = s[2 * kWideUnits] + bias[2 * H + j];
          const float rr =
              wide_sigmoid(__bfloat162float(x_t[j]) + (s[0] + bias[j]));
          const float zz = wide_sigmoid(__bfloat162float(x_t[H + j]) +
                                        (s[kWideUnits] + bias[H + j]));
          const float nn = tanhf(__bfloat162float(x_t[2 * H + j]) + rr * hn);
          const float h_p = __bfloat162float(hp[r * ldh + j]);
          const float dht = g[idx * H + j] + (t == T - 1 ? 0.f : dh0[row * H + j]);
          const float dz = dht * (h_p - nn) * zz * (1.f - zz);
          const float dpn = dht * (1.f - zz) * (1.f - nn * nn);
          const float dpr = dpn * hn * rr * (1.f - rr);
          __nv_bfloat16* dx_t = dxw + idx * G;
          dx_t[j] = __float2bfloat16(dpr);
          dx_t[H + j] = __float2bfloat16(dz);
          dx_t[2 * H + j] = __float2bfloat16(dpn);
          r_out[idx * H + j] = __float2bfloat16(rr);
          dgs[r * G + j] = __float2bfloat16(dpr);
          dgs[r * G + H + j] = __float2bfloat16(dz);
          dgs[r * G + 2 * H + j] = __float2bfloat16(dpn * rr);
          dh0[row * H + j] = dht * zz;
        }
      }
      __syncwarp();
    }
    // the step's dgates are complete in the workspace
    __syncthreads();

    // dh += bf16(dgates) @ bf16(w_hh)^T: the chunk's 16 columns of dh,
    // w_hh^T read column-major straight from w_hh (H, 3H)
    for (int c = warp; c < chunks; c += kWideWarps) {
      const int u0 = c * kWideUnits;
      WideFragC acc;
      nvcuda::wmma::fill_fragment(acc, 0.f);
      const __nv_bfloat16* w_u = w + static_cast<size_t>(u0) * G;
#pragma unroll 4
      for (int k = 0; k < G / 16; ++k) {
        WideFragA a_frag;
        WideFragBT b_frag;
        nvcuda::wmma::load_matrix_sync(a_frag, dgs + k * 16, G);
        nvcuda::wmma::load_matrix_sync(b_frag, w_u + k * 16, G);
        nvcuda::wmma::mma_sync(acc, a_frag, b_frag, acc);
      }
      nvcuda::wmma::store_matrix_sync(st, acc, kWideLds,
                                      nvcuda::wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kWideRows * kWideUnits / 32; ++i) {
        const int e = lane + 32 * i;
        const int r = e / kWideUnits;
        const int u = e % kWideUnits;
        if (r < rows) {
          const size_t row = static_cast<size_t>(d) * B + b0 + r;
          dh0[row * H + u0 + u] += st[r * kWideLds + u];
        }
      }
      __syncwarp();
    }
    // every warp is done with the workspace and the staged h_prev
    __syncthreads();
  }
}

inline size_t gru_wide_fwd_smem(int H) {
  return 2 * sizeof(__nv_bfloat16) * kWideRows * (H + kWidePad) +
         sizeof(float) * kWideWarps * kWideRows * kWideLds;
}

inline size_t gru_wide_bwd_smem(int H) {
  return sizeof(__nv_bfloat16) * kWideRows * (H + kWidePad) +
         sizeof(float) * kWideWarps * kWideRows * kWideLds;
}

inline int gru_wide_tiles(int B) { return (B + kWideRows - 1) / kWideRows; }

// Bytes of the backward's workspace (dg) for (D, B, H).
inline size_t gru_wide_bwd_workspace(int D, int B, int H) {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(D) * gru_wide_tiles(B) *
         kWideRows * 3 * H;
}

cudaError_t gru_wide_fwd(const void* xw, const void* w_hh, const void* b_hh,
                         const void* h0, void* y, int D, int B, int T, int H,
                         cudaStream_t stream) {
  const size_t smem = gru_wide_fwd_smem(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_wide_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gru_wide_fwd_kernel<<<dim3(gru_wide_tiles(B), D), kWideThreads, smem,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(h0), static_cast<float*>(y), B, T, H);
  return cudaGetLastError();
}

cudaError_t gru_wide_bwd(const void* xw, const void* h_prev, const void* w_hh,
                         const void* b_hh, const void* g, void* dxw, void* r,
                         void* dh0, void* dg, int D, int B, int T, int H,
                         cudaStream_t stream) {
  const size_t smem = gru_wide_bwd_smem(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_wide_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gru_wide_bwd_kernel<<<dim3(gru_wide_tiles(B), D), kWideThreads, smem,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(h_prev),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dxw),
      static_cast<__nv_bfloat16*>(r), static_cast<float*>(dh0),
      static_cast<__nv_bfloat16*>(dg), B, T, H);
  return cudaGetLastError();
}

// The design query's answer for the wide design (2), as pbsed_gru_design
// (gru.cu) reports it.
inline int gru_wide_design(int H, bool backward, int* cluster, int* rows,
                           int* smem, int* coresident) {
  *cluster = 1;
  *rows = kWideRows;
  *smem = static_cast<int>(backward ? gru_wide_bwd_smem(H)
                                    : gru_wide_fwd_smem(H));
  *coresident = 0;
  return 2;
}

}  // namespace
