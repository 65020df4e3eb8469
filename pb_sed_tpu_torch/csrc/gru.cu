// GRU forward recurrence over precomputed input projections, torch gate
// order (r, z, n), for D independent directions at once:
//
//   gates = xw[t] + bf16(h) @ bf16(w_hh) (f32 accumulate) + b_hh
//   r = sigmoid(g_r), z = sigmoid(g_z), n = tanh(xw_n + r * hw_n)
//   h = (1 - z) * n + z * h;  y[t] = h
//
// Replaces: pb_sed_tpu/ops/pallas/gru.py:_gru_kernel (reached through
// _gru_scan_pallas_tm / gru_scan). xw streams as bf16 as it does there;
// the hidden state and the gate math stay f32.
//
// What bounds it on the H100: the recurrence is serial in t, and each
// step multiplies a thin (rows x H) state by the (H x 3H) recurrent
// weight. At H = 256, w_hh is 384 KiB of bf16 per direction, more than
// the 227 KB of shared memory a block can hold, so every step re-reads
// w_hh; with few rows per block the step is bound by that read from L2,
// not by the tensor cores.
//
// What the design does about it: one block per (direction, tile of 32
// batch rows, 16 when H > 256); rows never interact, so blocks never wait
// on each other. The tile's state lives in shared memory (f32 for the
// update, bf16 as the matmul operand). Each step, warp w computes the 96
// gate columns [96w, 96w + 96) for all rows of the tile with bf16
// tensor-core products (wmma 16x16x16, f32 accumulators), loading w_hh
// fragments straight from global memory (L2-resident after the first
// step), one K slice ahead of the products that use them, and reusing
// each fragment across the row tiles. Meanwhile the step's xw rows are
// copied into shared memory asynchronously (cp.async), so the
// elementwise phase reads no global memory: there thread j owns hidden
// unit j of every row, updates h and writes y coalesced. Two barriers per
// step. With blockDim = H, H must be a multiple of 32. At B = 32 this
// keeps most SMs idle; spreading w_hh over a cluster's distributed shared
// memory is left for a later change.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kColsPerWarp = 96;  // 6 wmma column fragments
constexpr int kFragsPerWarp = kColsPerWarp / 16;

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

template <int MT>
__global__ void __launch_bounds__(MT == 2 ? 256 : 512)
gru_scan_kernel(const __nv_bfloat16* __restrict__ xw,    // (D, B, T, 3H)
                const __nv_bfloat16* __restrict__ w_hh,  // (D, H, 3H)
                const float* __restrict__ b_hh,          // (D, 3H)
                const float* __restrict__ h0,            // (D, B, H)
                float* __restrict__ y,                   // (D, B, T, H)
                int B, int T, int H) {
  constexpr int BT = 16 * MT;  // batch rows per block
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  float* gates = reinterpret_cast<float*>(smem);      // (BT, 3H)
  float* h_f32 = gates + BT * G;                      // (BT, H)
  __nv_bfloat16* h_bf16 =
      reinterpret_cast<__nv_bfloat16*>(h_f32 + BT * H);  // (BT, H)
  __nv_bfloat16* x_s = h_bf16 + BT * H;                  // (BT, 3H)

  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;  // hidden unit owned in the elementwise phase
  const int warp = j / 32;
  const __nv_bfloat16* w = w_hh + static_cast<size_t>(d) * H * G;
  const float br = b_hh[static_cast<size_t>(d) * G + j];
  const float bz = b_hh[static_cast<size_t>(d) * G + H + j];
  const float bn = b_hh[static_cast<size_t>(d) * G + 2 * H + j];
  const int rows = min(BT, B - b0);
  const int chunks = G / 8;  // 16-byte chunks of one xw row

  for (int r = 0; r < BT; ++r) {
    const float h = r < rows ? h0[(static_cast<size_t>(d) * B + b0 + r) * H + j]
                             : 0.f;
    h_f32[r * H + j] = h;
    h_bf16[r * H + j] = __float2bfloat16(h);
  }
  __syncthreads();

  const int col0 = warp * kColsPerWarp;
  const int nk = H / 16;  // even: H % 32 == 0
  for (int t = 0; t < T; ++t) {
    // xw[t] of the tile's rows -> shared memory, overlapping the matmul
    for (int c = j; c < rows * chunks; c += blockDim.x) {
      const int r = c / chunks;
      const int q = c - r * chunks;
      const size_t row = (static_cast<size_t>(d) * B + b0 + r) * T + t;
      __pipeline_memcpy_async(x_s + r * G + q * 8, xw + row * G + q * 8, 16);
    }
    __pipeline_commit();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][kFragsPerWarp];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int f = 0; f < kFragsPerWarp; ++f) wmma::fill_fragment(acc[m][f], 0.f);
    // w_hh fragments of slice k + 1 load while slice k multiplies
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
        wmma::load_matrix_sync(a_frag[m], h_bf16 + m * 16 * H + kk * 16, H);
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
        wmma::load_matrix_sync(a_frag[m], h_bf16 + m * 16 * H + kk * 16 + 16,
                               H);
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
        wmma::store_matrix_sync(gates + m * 16 * G + col0 + f * 16, acc[m][f],
                                G, wmma::mem_row_major);
    __pipeline_wait_prior(0);
    __syncthreads();

    for (int r = 0; r < rows; ++r) {
      const __nv_bfloat16* x_t = x_s + r * G;
      const float* g = gates + r * G;
      const float rr = sigmoidf(__bfloat162float(x_t[j]) + g[j] + br);
      const float zz = sigmoidf(__bfloat162float(x_t[H + j]) + g[H + j] + bz);
      const float nn =
          tanhf(__bfloat162float(x_t[2 * H + j]) + rr * (g[2 * H + j] + bn));
      const float h = (1.f - zz) * nn + zz * h_f32[r * H + j];
      h_f32[r * H + j] = h;
      h_bf16[r * H + j] = __float2bfloat16(h);
      y[((static_cast<size_t>(d) * B + b0 + r) * T + t) * H + j] = h;
    }
    __syncthreads();
  }
}

template <int MT>
size_t smem_bytes(int H) {
  // gates f32 (3H) + h f32 + h bf16 + xw bf16 (3H) per row
  return static_cast<size_t>(16 * MT) * H * (3 * 4 + 4 + 2 + 3 * 2);
}

template <int MT>
cudaError_t launch(const void* xw, const void* w_hh, const void* b_hh,
                   const void* h0, void* y, int D, int B, int T, int H,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<MT>(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 16 * MT - 1) / (16 * MT), D);
  gru_scan_kernel<MT><<<grid, H, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(h0), static_cast<float*>(y), B, T, H);
  return cudaGetLastError();
}

}  // namespace

// xw (D, B, T, 3H) bf16, w_hh (D, H, 3H) bf16, b_hh (D, 3H) f32,
// h0 (D, B, H) f32, y (D, B, T, H) f32; contiguous, xw 16-byte aligned.
// Requires H % 32 == 0 and H <= 512 (blockDim = H). Tiles of 32 rows up
// to H = 256, of 16 rows above (shared memory). Returns a cudaError_t.
extern "C" int pbsed_gru_scan(const void* xw, const void* w_hh,
                              const void* b_hh, const void* h0, void* y, int D,
                              int B, int T, int H, void* stream) {
  if (H % 32 != 0 || H < 32 || H > 512 || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      H <= 256 ? launch<2>(xw, w_hh, b_hh, h0, y, D, B, T, H, s)
               : launch<1>(xw, w_hh, b_hh, h0, y, D, B, T, H, s);
  return static_cast<int>(err);
}

// Message for a cudaError_t returned by the functions above.
extern "C" const char* pbsed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
