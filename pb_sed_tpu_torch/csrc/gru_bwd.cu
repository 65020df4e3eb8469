// Backward of the GRU recurrence (gru.cu), torch gate order (r, z, n),
// for D independent directions at once: the reverse sweep over t that
// recomputes the gates from the bf16 previous state and carries dh.
//
//   hw    = bf16(h_prev) @ bf16(w_hh) (f32 accumulate) + b_hh
//   r, z  = sigmoid(xw_{r,z} + hw_{r,z});  n = tanh(xw_n + r * hw_n)
//   dh_t  = g[t] + dh
//   dz    = dh_t * (h_prev - n) * z * (1 - z)
//   dpn   = dh_t * (1 - z) * (1 - n^2);  dpr = dpn * hw_n * r * (1 - r)
//   dxw[t] = bf16([dpr, dz, dpn]);  r_out[t] = bf16(r)
//   dh    = dh_t * z + bf16([dpr, dz, dpn * r]) @ bf16(w_hh)^T (f32 acc)
//   dh0   = dh after t = 0
//
// Replaces: pb_sed_tpu/ops/pallas/gru.py:_gru_bwd_split_kernel (reached
// through _gru_scan_pallas_bwd(split=True), the production backward),
// with its rounding points (gru.py:394-426): h_prev rounded to bf16 and
// used both in the recompute and in dz, dxw and r written in bf16, dh
// carried in f32. As there, dw_hh and db_hh are NOT accumulated in the
// sweep: the wrapper contracts them afterwards over the (B*T) axis from
// bf16 h_prev and the bf16 product dxw_n * r (gru.py:546-552).
//
// What bounds it on the H100: like the forward, the sweep is serial in t
// and each step multiplies a thin (rows x H) operand by w_hh twice:
// h_prev @ w_hh (H x 3H) for the gates and dgates @ w_hh^T (3H x H) for
// dh. At H = 256 w_hh is 384 KiB of bf16 per direction, more than a
// block's shared memory, so each step re-reads it twice from L2; with few
// rows per block the step is bound by those reads and their latency.
//
// What the design does about it: the forward kernel's layout. One block
// per (direction, tile of 32 batch rows, 16 when H > 256); rows never
// interact. Each step the tile's bf16 h_prev rows are copied into shared
// memory (cp.async); warp w computes the 96 gate columns [96w, 96w + 96)
// with bf16 tensor-core products (wmma 16x16x16, w_hh fragments from
// global memory one K slice ahead); in the elementwise phase thread j
// owns hidden unit j of every row and keeps dh in registers. That phase
// reads xw and g from global memory: it issues the loads of 8 rows at
// once (from a valid row also past the batch) before it uses any, so
// their latency is paid once per 8 rows, not per row (at (2, 32, 500,
// 256) this took the kernel from 49.2 to 33.5 ms on an H100 80GB HBM3 at
// 700 W; double-buffering h_prev and prefetching the w_hh^T slices moved
// nothing). It writes dxw and r; then warp w computes the 32 columns
// [32w, 32w + 32) of dgates @ w_hh^T, reading w_hh column-major. Four
// barriers per step. blockDim = H, so H must be a multiple of 32. At
// B = 32 only 2 blocks run per direction pair.
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

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

template <int MT>
__global__ void __launch_bounds__(MT == 2 ? 256 : 512)
gru_bwd_kernel(const __nv_bfloat16* __restrict__ xw,      // (D, B, T, 3H)
               const __nv_bfloat16* __restrict__ h_prev,  // (D, B, T, H)
               const __nv_bfloat16* __restrict__ w_hh,    // (D, H, 3H)
               const float* __restrict__ b_hh,            // (D, 3H)
               const float* __restrict__ g,               // (D, B, T, H)
               __nv_bfloat16* __restrict__ dxw,           // (D, B, T, 3H)
               __nv_bfloat16* __restrict__ r_out,         // (D, B, T, H)
               float* __restrict__ dh0,                   // (D, B, H)
               int B, int T, int H) {
  constexpr int BT = 16 * MT;  // batch rows per block
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
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
        r_out[row * H + j] = __float2bfloat16(rr);
        dg[r * G + j] = __float2bfloat16(dpr);
        dg[r * G + H + j] = __float2bfloat16(dz);
        dg[r * G + 2 * H + j] = __float2bfloat16(dpn * rr);
        dh[r] = dht * zz;
      }
    }
    __syncthreads();

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

template <int MT>
cudaError_t launch(const void* xw, const void* h_prev, const void* w_hh,
                   const void* b_hh, const void* g, void* dxw, void* r,
                   void* dh0, int D, int B, int T, int H,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<MT>(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 16 * MT - 1) / (16 * MT), D);
  gru_bwd_kernel<MT><<<grid, H, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(h_prev),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dxw),
      static_cast<__nv_bfloat16*>(r), static_cast<float*>(dh0), B, T, H);
  return cudaGetLastError();
}

}  // namespace

// xw (D, B, T, 3H) bf16, h_prev (D, B, T, H) bf16 (= concat(h0, y[:-1])
// along T), w_hh (D, H, 3H) bf16, b_hh (D, 3H) f32, g (D, B, T, H) f32;
// outputs dxw (D, B, T, 3H) bf16, r (D, B, T, H) bf16, dh0 (D, B, H) f32.
// Contiguous, h_prev 16-byte aligned. Requires H % 32 == 0 and H <= 512
// (blockDim = H). Tiles of 32 rows up to H = 256, of 16 rows above
// (shared memory). Returns a cudaError_t.
extern "C" int pbsed_gru_scan_bwd(const void* xw, const void* h_prev,
                                  const void* w_hh, const void* b_hh,
                                  const void* g, void* dxw, void* r,
                                  void* dh0, int D, int B, int T, int H,
                                  void* stream) {
  if (H % 32 != 0 || H < 32 || H > 512 || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      H <= 256 ? launch<2>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, D, B, T, H, s)
               : launch<1>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, D, B, T, H, s);
  return static_cast<int>(err);
}
