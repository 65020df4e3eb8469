// The reverse sweep of the GRU backward, shared by the split variant
// (gru_bwd.cu, the training default) and the fused one
// (gru_bwd_fused.cu): one templated kernel, torch gate order (r, z, n),
// D independent directions at once.
//
//   hw    = bf16(h_prev) @ bf16(w_hh) (f32 accumulate) + b_hh
//   r, z  = sigmoid(xw_{r,z} + hw_{r,z});  n = tanh(xw_n + r * hw_n)
//   dh_t  = g[t] + dh
//   dz    = dh_t * (h_prev - n) * z * (1 - z)
//   dpn   = dh_t * (1 - z) * (1 - n^2);  dpr = dpn * hw_n * r * (1 - r)
//   dxw[t] = bf16([dpr, dz, dpn]);  dgates = [dpr, dz, dpn * r]
//   dh    = dh_t * z + bf16(dgates) @ bf16(w_hh)^T (f32 acc)
//   dh0   = dh after t = 0
//
// The layout and what bounds it: see gru_bwd.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kColsPerWarp = 96;  // matmul 1: 6 wmma column fragments
constexpr int kFragsPerWarp = kColsPerWarp / 16;
constexpr int kDhFragsPerWarp = 2;  // matmul 2: 32 columns of dh
constexpr int kRowGroup = 8;        // rows whose loads are issued together
constexpr int kDwSteps = 16;        // FUSED: steps per dw_hh accumulation

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// Rows past the batch stay zero in the staged h_prev and dgates, so
// they add nothing to dh, dw_hh or db_hh. Split (FUSED false): writes
// r_out, leaves dw_hh/db_hh to the caller. FUSED: no r_out; each block
// accumulates h_prev^T @ bf16(dgates) over its rows and steps into its
// own f32 slice of dw_part ((D * blocks, H, 3H), zeroed by the caller)
// every kDwSteps steps, from the bf16 h_prev/dgates rows of those steps
// copied to its slice of `scratch` ((kDwSteps * rows, H) then
// (kDwSteps * rows, 3H)), and the f32 dgates row sums into db_part
// ((D * blocks, 3H)). dw_part/db_part are reduced over the blocks in a
// fixed order afterwards (gru_bwd_fused.cu).
template <int MT, bool FUSED>
__global__ void __launch_bounds__(MT == 2 ? 256 : 512)
gru_bwd_kernel(const __nv_bfloat16* __restrict__ xw,      // (D, B, T, 3H)
               const __nv_bfloat16* __restrict__ h_prev,  // (D, B, T, H)
               const __nv_bfloat16* __restrict__ w_hh,    // (D, H, 3H)
               const float* __restrict__ b_hh,            // (D, 3H)
               const float* __restrict__ g,               // (D, B, T, H)
               __nv_bfloat16* __restrict__ dxw,           // (D, B, T, 3H)
               __nv_bfloat16* __restrict__ r_out,         // split only
               float* __restrict__ dh0,                   // (D, B, H)
               float* dw_part, float* db_part,            // FUSED only
               __nv_bfloat16* scratch,                    // FUSED only
               int B, int T, int H) {
  constexpr int BT = 16 * MT;  // batch rows per block
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
  using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                wmma::col_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  float* hw = reinterpret_cast<float*>(smem);  // (BT, 3H); (BT, H) for dh
  __nv_bfloat16* hp = reinterpret_cast<__nv_bfloat16*>(hw + BT * G);  // (BT, H)
  __nv_bfloat16* dg = hp + BT * H;                                    // (BT, 3H)

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;
  const int warp = j / 32;
  const __nv_bfloat16* w = w_hh + static_cast<size_t>(d) * H * G;
  const float br = b_hh[static_cast<size_t>(d) * G + j];
  const float bz = b_hh[static_cast<size_t>(d) * G + H + j];
  const float bn = b_hh[static_cast<size_t>(d) * G + 2 * H + j];
  const int rows = min(BT, B - b0);
  const int chunks = H / 8;  // 16-byte chunks of one h_prev row
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  // rows past the batch stay zero in both matmul operands
  for (int e = j; e < BT * H; e += blockDim.x) hp[e] = zero;
  for (int e = j; e < BT * G; e += blockDim.x) dg[e] = zero;
  float dh[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) dh[r] = 0.f;
  // FUSED: this block's db_hh sums for hidden unit j, its dw_hh slice and
  // its h_prev / dgates scratch rows
  float db_r = 0.f, db_z = 0.f, db_n = 0.f;
  const size_t part = static_cast<size_t>(d) * gridDim.x + blockIdx.x;
  float* dw_blk = FUSED ? dw_part + part * H * G : nullptr;
  __nv_bfloat16* hs =
      FUSED ? scratch + part * kDwSteps * BT * (H + G) : nullptr;
  __nv_bfloat16* gs = FUSED ? hs + kDwSteps * BT * H : nullptr;
  __syncthreads();

  const int col0 = warp * kColsPerWarp;
  const int dcol0 = warp * 16 * kDhFragsPerWarp;
  const int nk = H / 16;  // even: H % 32 == 0
  for (int t = T - 1; t >= 0; --t) {
    for (int c = j; c < rows * chunks; c += blockDim.x) {
      const int r = c / chunks;
      const int q = c - r * chunks;
      const size_t row = (static_cast<size_t>(d) * B + b0 + r) * T + t;
      __pipeline_memcpy_async(hp + r * H + q * 8, h_prev + row * H + q * 8, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // hw = h_prev @ w_hh: warp w -> gate columns [96w, 96w + 96)
    {
      FragC acc[MT][kFragsPerWarp];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int f = 0; f < kFragsPerWarp; ++f) wmma::fill_fragment(acc[m][f], 0.f);
      FragB b_even[kFragsPerWarp], b_odd[kFragsPerWarp];
      FragA a_frag[MT];
#pragma unroll
      for (int f = 0; f < kFragsPerWarp; ++f)
        wmma::load_matrix_sync(b_even[f], w + col0 + f * 16, G);
      for (int kk = 0; kk < nk; kk += 2) {
#pragma unroll
        for (int f = 0; f < kFragsPerWarp; ++f)
          wmma::load_matrix_sync(
              b_odd[f], w + static_cast<size_t>(kk + 1) * 16 * G + col0 + f * 16,
              G);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          wmma::load_matrix_sync(a_frag[m], hp + m * 16 * H + kk * 16, H);
#pragma unroll
        for (int f = 0; f < kFragsPerWarp; ++f)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wmma::mma_sync(acc[m][f], a_frag[m], b_even[f], acc[m][f]);
        if (kk + 2 < nk) {
#pragma unroll
          for (int f = 0; f < kFragsPerWarp; ++f)
            wmma::load_matrix_sync(
                b_even[f],
                w + static_cast<size_t>(kk + 2) * 16 * G + col0 + f * 16, G);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          wmma::load_matrix_sync(a_frag[m], hp + m * 16 * H + kk * 16 + 16, H);
#pragma unroll
        for (int f = 0; f < kFragsPerWarp; ++f)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wmma::mma_sync(acc[m][f], a_frag[m], b_odd[f], acc[m][f]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int f = 0; f < kFragsPerWarp; ++f)
          wmma::store_matrix_sync(hw + m * 16 * G + col0 + f * 16, acc[m][f],
                                  G, wmma::mem_row_major);
    }
    __syncthreads();

    // rows in groups of 8: the group's global loads (xw, g) are issued
    // together, from a valid row also past the batch, before any use
#pragma unroll
    for (int r0 = 0; r0 < BT; r0 += kRowGroup) {
      float xr[kRowGroup], xz[kRowGroup], xn[kRowGroup], gt[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const size_t row =
            (static_cast<size_t>(d) * B + b0 + min(r0 + i, rows - 1)) * T + t;
        xr[i] = __bfloat162float(xw[row * G + j]);
        xz[i] = __bfloat162float(xw[row * G + H + j]);
        xn[i] = __bfloat162float(xw[row * G + 2 * H + j]);
        gt[i] = g[row * H + j];
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const int r = r0 + i;
        if (r >= rows) break;
        const size_t row = (static_cast<size_t>(d) * B + b0 + r) * T + t;
        const float* hw_r = hw + r * G;
        const float hn = hw_r[2 * H + j] + bn;
        const float rr = sigmoidf(xr[i] + (hw_r[j] + br));
        const float zz = sigmoidf(xz[i] + (hw_r[H + j] + bz));
        const float nn = tanhf(xn[i] + rr * hn);
        const float h_p = __bfloat162float(hp[r * H + j]);
        const float dht = gt[i] + dh[r];
        const float dz = dht * (h_p - nn) * zz * (1.f - zz);
        const float dpn = dht * (1.f - zz) * (1.f - nn * nn);
        const float dpr = dpn * hn * rr * (1.f - rr);
        __nv_bfloat16* dx_t = dxw + row * G;
        dx_t[j] = __float2bfloat16(dpr);
        dx_t[H + j] = __float2bfloat16(dz);
        dx_t[2 * H + j] = __float2bfloat16(dpn);
        if constexpr (FUSED) {
          db_r += dpr;
          db_z += dz;
          db_n += dpn * rr;
        } else {
          r_out[row * H + j] = __float2bfloat16(rr);
        }
        dg[r * G + j] = __float2bfloat16(dpr);
        dg[r * G + H + j] = __float2bfloat16(dz);
        dg[r * G + 2 * H + j] = __float2bfloat16(dpn * rr);
        dh[r] = dht * zz;
      }
    }
    __syncthreads();
    [[maybe_unused]] const int step = (T - 1 - t) % kDwSteps;
    if constexpr (FUSED) {
      // this step's rows of bf16 h_prev and dgates into the scratch
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        const size_t k = static_cast<size_t>(step) * BT + r;
        hs[k * H + j] = hp[r * H + j];
        gs[k * G + j] = dg[r * G + j];
        gs[k * G + H + j] = dg[r * G + H + j];
        gs[k * G + 2 * H + j] = dg[r * G + 2 * H + j];
      }
    }

    // dh += dgates @ w_hh^T: warp w -> hidden columns [32w, 32w + 32);
    // w_hh^T read column-major straight from w_hh (H, 3H)
    {
      FragC acc[MT][kDhFragsPerWarp];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int f = 0; f < kDhFragsPerWarp; ++f)
          wmma::fill_fragment(acc[m][f], 0.f);
      for (int k = 0; k < G / 16; ++k) {
        FragA a_frag[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          wmma::load_matrix_sync(a_frag[m], dg + m * 16 * G + k * 16, G);
#pragma unroll
        for (int f = 0; f < kDhFragsPerWarp; ++f) {
          FragBT b_frag;
          wmma::load_matrix_sync(
              b_frag, w + static_cast<size_t>(dcol0 + f * 16) * G + k * 16, G);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wmma::mma_sync(acc[m][f], a_frag[m], b_frag, acc[m][f]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int f = 0; f < kDhFragsPerWarp; ++f)
          wmma::store_matrix_sync(hw + m * 16 * H + dcol0 + f * 16, acc[m][f],
                                  H, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BT; ++r)
      if (r < rows) dh[r] += hw[r * H + j];
    if constexpr (FUSED) {
      // every kDwSteps steps (and after t = 0): dw_blk += hs^T @ gs over
      // the scratch rows written so far (visible after the barrier above);
      // warp w owns 16 x 16 tiles w, w + H/32, ... of the (H, 3H) slice
      if (step == kDwSteps - 1 || t == 0) {
        const int k_rows = (step + 1) * BT;
        const int n_tiles = G / 16;
        for (int tile = warp; tile < (H / 16) * n_tiles;
             tile += blockDim.x / 32) {
          const int m0 = (tile / n_tiles) * 16;  // rows of dw: hidden units
          const int n0 = (tile % n_tiles) * 16;  // columns: gate units
          float* c_ptr = dw_blk + static_cast<size_t>(m0) * G + n0;
          FragC acc;
          wmma::load_matrix_sync(acc, c_ptr, G, wmma::mem_row_major);
          for (int k = 0; k < k_rows; k += 16) {
            FragAT a_frag;  // h_prev^T: (hidden, rows), col-major in hs
            FragB b_frag;
            wmma::load_matrix_sync(a_frag, hs + static_cast<size_t>(k) * H + m0,
                                   H);
            wmma::load_matrix_sync(b_frag, gs + static_cast<size_t>(k) * G + n0,
                                   G);
            wmma::mma_sync(acc, a_frag, b_frag, acc);
          }
          wmma::store_matrix_sync(c_ptr, acc, G, wmma::mem_row_major);
        }
      }
    }
  }
  if constexpr (FUSED) {
    db_part[part * G + j] = db_r;
    db_part[part * G + H + j] = db_z;
    db_part[part * G + 2 * H + j] = db_n;
  }
#pragma unroll
  for (int r = 0; r < BT; ++r)
    if (r < rows) dh0[(static_cast<size_t>(d) * B + b0 + r) * H + j] = dh[r];
}

template <int MT>
size_t smem_bytes(int H) {
  // hw f32 (3H) + two h_prev bf16 (H) + dgates bf16 (3H) per row
  return static_cast<size_t>(16 * MT) * H * (3 * 4 + 2 + 3 * 2);
}

template <int MT, bool FUSED>
cudaError_t launch_sweep(const void* xw, const void* h_prev, const void* w_hh,
                         const void* b_hh, const void* g, void* dxw, void* r,
                         void* dh0, void* dw_part, void* db_part,
                         void* scratch, int D, int B, int T, int H,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes<MT>(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<MT, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 16 * MT - 1) / (16 * MT), D);
  gru_bwd_kernel<MT, FUSED><<<grid, H, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(h_prev),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dxw),
      static_cast<__nv_bfloat16*>(r), static_cast<float*>(dh0),
      static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<__nv_bfloat16*>(scratch), B, T, H);
  return cudaGetLastError();
}

// The sweep for any H the kernels take: tiles of 32 rows up to H = 256,
// of 16 rows above (shared memory).
template <bool FUSED>
cudaError_t gru_bwd_sweep(const void* xw, const void* h_prev,
                          const void* w_hh, const void* b_hh, const void* g,
                          void* dxw, void* r, void* dh0, void* dw_part,
                          void* db_part, void* scratch, int D, int B, int T,
                          int H, cudaStream_t stream) {
  if (H <= 256)
    return launch_sweep<2, FUSED>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0,
                                  dw_part, db_part, scratch, D, B, T, H,
                                  stream);
  return launch_sweep<1, FUSED>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0,
                                dw_part, db_part, scratch, D, B, T, H, stream);
}

}  // namespace
