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
// What bounds it on the H100: the recurrence is serial in t, and a step's
// work is nothing (a thin (rows x H) state times the (H x 3H) recurrent
// weight: 50 MFLOP per direction at H = 512, B = 32). What a step costs
// is the latency of its chain: fetch w_hh, multiply, gate math, make the
// new state visible to whoever multiplies next. w_hh is 384 KiB of bf16
// per direction at H = 256 and 1.5 MiB at H = 512, more than the 227 KB
// of shared memory a block can hold.
//
// Two designs, chosen by shape in pbsed_gru_scan (pbsed_gru_design says
// which, and with how much shared memory):
//
// 1. Few rows, many steps (training and tagging: B = 32, T = 500, also a
//    stacked ensemble's D = 2N), and at H = 512 every shape (the rule is
//    gru_cluster_takes in
//    gru_cluster.cuh): a thread-block cluster per (direction, tile of 16
//    rows while all clusters are on the card at once, else of 32:
//    gru_cluster_row_tiles), w_hh spread over the cluster's shared
//    memory, the state exchanged through distributed shared memory
//    (gru_scan_cluster_kernel below). Block c of C = H / 32
//    owns 32 hidden units and their 96 gate columns; its slice of w_hh is
//    copied into shared memory once and never read from global memory
//    again. Each step: 12 warps multiply the tile's full bf16 state (a
//    copy in every block's shared memory) by the slice (wmma from shared
//    memory, column tile x half of K a warp); after one block barrier, 16
//    warps do the gate math for the block's own units (f32 state in
//    registers, lane = unit, warp = row), write y, and store the new bf16
//    state of those units into EVERY block's copy of the state, 16 bytes
//    a lane, through st.shared::cluster. The state is double-buffered, so
//    one cluster barrier (arrive.release / wait.acquire) a step orders the
//    exchange: a block writes step t + 1's copy only after every block has
//    passed the barrier of step t - 1, that is, has finished reading it.
//    xw[t + 1] of the block's columns is loaded into registers a step
//    ahead; it depends on nothing in the loop.
// 2. Many rows, few steps at H = 256 (sliding-window SED: 16 000 windows
//    of 51 frames) and every other H: one block per (direction, tile of
//    32 batch rows, 16 when H > 256), which fill the card by their number
//    (gru_scan_kernel below). The tile's state lives in shared memory;
//    each step, warp w computes the 96 gate columns [96w, 96w + 96) with
//    wmma products, loading w_hh fragments straight from global memory
//    (L2-resident after the first step), one K slice ahead of the products
//    that use them; the step's xw rows arrive by cp.async meanwhile. Two
//    barriers per step. blockDim = H, so H must be a multiple of 32.
// 3. H above 512 (a multiple of 256, to 2048): the cluster design with
//    H / 16 units a block (gru_cluster_wide.cuh): a cluster of 16 blocks
//    per (direction, tile of 16 or 32 rows), the slice of w_hh that does
//    not fit a block's shared memory streamed from L2 every step through
//    a cp.async ring.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "gru_cluster.cuh"
#include "gru_cluster_wide.cuh"

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

// The cluster design (1. above). grid = (C * row tiles, D) in clusters of
// C = H / 32 along x; 512 threads.
template <int MT>
__global__ void __launch_bounds__(kClThreads, 1)
gru_scan_cluster_kernel(const __nv_bfloat16* __restrict__ xw,    // (D, B, T, 3H)
                        const __nv_bfloat16* __restrict__ w_hh,  // (D, H, 3H)
                        const float* __restrict__ b_hh,          // (D, 3H)
                        const float* __restrict__ h0,            // (D, B, H)
                        float* __restrict__ y,                   // (D, B, T, H)
                        int B, int T, int H) {
  constexpr int R = 16 * MT;  // batch rows per cluster
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  const int ldh = H + kClPad;
  const int C = H / kClUnits;
  __nv_bfloat16* sT = reinterpret_cast<__nv_bfloat16*>(smem);  // (96, ldh)
  __nv_bfloat16* hb = sT + kClCols * ldh;  // (2, R, ldh): the state, twice
  float* gs = reinterpret_cast<float*>(hb + 2 * R * ldh);  // (2, R, kClLdg)
  __nv_bfloat16* stg =
      reinterpret_cast<__nv_bfloat16*>(gs + 2 * R * kClLdg);  // (R, 32)

  const int rank = static_cast<int>(cl_rank());
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int rows = min(R, B - b0);
  const int u0 = rank * kClUnits;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  cl_load_slice(sT, w_hh + static_cast<size_t>(d) * H * G, H, u0);
  // copy 0 of the state: bf16(h0) of the whole tile; rows past the batch
  // (and all of copy 1) zero, and they stay zero
  for (int e = threadIdx.x; e < R * ldh; e += kClThreads) {
    const int r = e / ldh;
    const int k = e - r * ldh;
    const float v = (r < rows && k < H)
                        ? h0[(static_cast<size_t>(d) * B + b0 + r) * H + k]
                        : 0.f;
    hb[e] = __float2bfloat16(v);
    hb[R * ldh + e] = __float2bfloat16(0.f);
  }
  const float br = b_hh[static_cast<size_t>(d) * G + u0 + lane];
  const float bz = b_hh[static_cast<size_t>(d) * G + H + u0 + lane];
  const float bn = b_hh[static_cast<size_t>(d) * G + 2 * H + u0 + lane];
  // thread (warp, lane) owns unit u0 + lane of rows warp, warp + 16
  float h_own[MT];
  const __nv_bfloat16* x_row[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = min(warp + 16 * i, rows - 1);  // a valid row also past it
    const size_t row = static_cast<size_t>(d) * B + b0 + r;
    h_own[i] = h0[row * H + u0 + lane];
    x_row[i] = xw + row * T * G + u0 + lane;
  }
  __nv_bfloat16 nx_r[MT], nx_z[MT], nx_n[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    nx_r[i] = x_row[i][0];
    nx_z[i] = x_row[i][H];
    nx_n[i] = x_row[i][2 * H];
  }
  // every block of the cluster runs and has set up its shared memory
  // before any store from another block lands in it
  cl_arrive();
  cl_wait();

  // lane -> (block it sends to, 16-byte chunks of a row's 64 bytes)
  const int dest = lane % C;
  const int chunks = C / 8;  // per lane: 4 chunks over 32 / C lanes a block
  const int chunk0 = (lane / C) * chunks;
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    float x_r[MT], x_z[MT], x_n[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      x_r[i] = __bfloat162float(nx_r[i]);
      x_z[i] = __bfloat162float(nx_z[i]);
      x_n[i] = __bfloat162float(nx_n[i]);
    }
    if (t + 1 < T) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* x_t = x_row[i] + static_cast<size_t>(t + 1) * G;
        nx_r[i] = x_t[0];
        nx_z[i] = x_t[H];
        nx_n[i] = x_t[2 * H];
      }
    }
    cl_gate_product<MT>(hb + cur * R * ldh, sT, gs, H, warp);
    __syncthreads();

    __nv_bfloat16* h_next = hb + (cur ^ 1) * R * ldh;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = warp + 16 * i;
      if (r < rows) {  // the same for all lanes of a warp
        const float* g0 = gs + r * kClLdg + lane;
        const float* g1 = g0 + R * kClLdg;
        const float rr = cl_sigmoid(x_r[i] + (g0[0] + g1[0]) + br);
        const float zz =
            cl_sigmoid(x_z[i] + (g0[kClUnits] + g1[kClUnits]) + bz);
        const float nn = tanhf(
            x_n[i] + rr * ((g0[2 * kClUnits] + g1[2 * kClUnits]) + bn));
        const float h = (1.f - zz) * nn + zz * h_own[i];
        h_own[i] = h;
        y[((static_cast<size_t>(d) * B + b0 + r) * T + t) * H + u0 + lane] = h;
        stg[r * kClUnits + lane] = __float2bfloat16(h);
        __syncwarp();
        // the row's 32 new values (64 bytes) into every block's next copy
        for (int q = 0; q < chunks; ++q) {
          const int chunk = chunk0 + q;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + r * kClUnits + chunk * 8);
          cl_store16(
              cl_map(cl_smem_u32(h_next + r * ldh + u0 + chunk * 8), dest), v);
        }
      }
    }
    // one cluster barrier a step: the new state is complete in every
    // block, and every block is done with the old one (which the step
    // after the next overwrites) and with gs
    cl_arrive();
    cl_wait();
  }
}

template <int MT>
size_t cluster_smem_bytes(int H) {
  constexpr int R = 16 * MT;
  const size_t ldh = H + kClPad;
  return 2 * (kClCols + 2 * R) * ldh + 4 * 2 * R * kClLdg + 2 * R * kClUnits;
}

// shared memory a block and co-resident clusters of the design with
// 16 MT rows at hidden size H (asked of the CUDA runtime once per size)
template <int MT>
cudaError_t cluster_design(int H, int* smem, int* coresident) {
  static int cached[2] = {0, 0};
  int& slot = cached[H == 512];
  *smem = static_cast<int>(cluster_smem_bytes<MT>(H));
  if (slot == 0) {
    const cudaError_t err = gru_cluster_coresident(
        gru_scan_cluster_kernel<MT>, H / kClUnits, *smem, &slot);
    if (err != cudaSuccess) return err;
  }
  *coresident = slot;
  return cudaSuccess;
}

// 1 or 2 row tiles of 16 a cluster (gru_cluster_row_tiles)
cudaError_t cluster_row_tiles(int D, int B, int H, int* mt) {
  int smem = 0, coresident = 0;
  const cudaError_t err = cluster_design<1>(H, &smem, &coresident);
  if (err == cudaSuccess) *mt = gru_cluster_row_tiles(D, B, coresident);
  return err;
}

template <int MT>
cudaError_t launch_cluster(const void* xw, const void* w_hh, const void* b_hh,
                           const void* h0, void* y, int D, int B, int T, int H,
                           cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const int C = H / kClUnits;
  int smem = 0, coresident = 0;
  cudaError_t err = cluster_design<MT>(H, &smem, &coresident);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = gru_cluster_config(gru_scan_cluster_kernel<MT>, C, smem,
                           dim3(C * ((B + R - 1) / R), D), stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, gru_scan_cluster_kernel<MT>, static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(h0), static_cast<float*>(y), B, T, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The forward under one design: the cluster design (cluster != 0) or the
// row-tiled kernel.
cudaError_t gru_scan_design(const void* xw, const void* w_hh,
                            const void* b_hh, const void* h0, void* y, int D,
                            int B, int T, int H, bool cluster,
                            cudaStream_t s) {
  if (!cluster)
    return H <= 256 ? launch<2>(xw, w_hh, b_hh, h0, y, D, B, T, H, s)
                    : launch<1>(xw, w_hh, b_hh, h0, y, D, B, T, H, s);
  int mt = 0;
  cudaError_t err = cluster_row_tiles(D, B, H, &mt);
  if (err == cudaSuccess)
    err = mt == 2 ? launch_cluster<2>(xw, w_hh, b_hh, h0, y, D, B, T, H, s)
                  : launch_cluster<1>(xw, w_hh, b_hh, h0, y, D, B, T, H, s);
  return err;
}

}  // namespace

// xw (D, B, T, 3H) bf16, w_hh (D, H, 3H) bf16, b_hh (D, 3H) f32,
// h0 (D, B, H) f32, y (D, B, T, H) f32; contiguous, xw 16-byte aligned;
// above H = 512 w_hh packed, (D, 16, H, 3H / 16 + 8)
// (ops/kernels/gru.py:pack_wide), and 16-byte aligned. Requires H % 32 ==
// 0 up to 512 and H % 256 == 0 above, to 2048 (the wrapper pads any other
// H with zero units). Above H = 512 the cluster design of
// gru_cluster_wide.cuh; else the cluster design where gru_cluster_takes
// says so, else the row-tiled kernel (blockDim = H), in tiles of 32 rows
// up to H = 256, of 16 rows above (shared memory). Returns a cudaError_t
// (cudaErrorLaunchOutOfResources where the card holds no cluster of the
// design at all).
extern "C" int pbsed_gru_scan(const void* xw, const void* w_hh,
                              const void* b_hh, const void* h0, void* y, int D,
                              int B, int T, int H, void* stream) {
  if (H % 32 != 0 || H < 32 || H > kWideMaxH ||
      (H > kWideMinH && !gru_wide_takes(H)) || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || T == 0) return 0;
  if (gru_wide_takes(H))
    return static_cast<int>(gru_wide_fwd(xw, w_hh, b_hh, h0, y, D, B, T, H,
                                         static_cast<cudaStream_t>(stream)));
  return static_cast<int>(gru_scan_design(
      xw, w_hh, b_hh, h0, y, D, B, T, H,
      gru_cluster_takes(D, B, T, H, kClMaxTiles16Fwd),
      static_cast<cudaStream_t>(stream)));
}

// Which design pbsed_gru_scan runs at (D, B, T, H): returns 1 for the
// cluster designs (above H = 512 that of gru_cluster_wide.cuh), 0 for the
// row-tiled kernel, minus a cudaError_t when the query fails.
// *cluster: blocks a cluster (1 row-tiled); *rows: batch rows a cluster or
// block; *smem: dynamic shared memory a block, bytes; *coresident:
// clusters the card holds at once (0 row-tiled); *units: hidden units a
// block owns (0 row-tiled); *resident, *streamed: bytes of a block's
// slice of w_hh kept in its shared memory and read from L2 at every step
// (row-tiled: all of w_hh streamed).
extern "C" int pbsed_gru_design(int D, int B, int T, int H, int* cluster,
                                int* rows, int* smem, int* coresident,
                                int* units, int* resident, int* streamed) {
  if (gru_wide_takes(H))
    return gru_wide_design<false>(D, B, H, cluster, rows, smem, coresident,
                                  units, resident, streamed);
  if (!gru_cluster_takes(D, B, T, H, kClMaxTiles16Fwd)) {
    *cluster = 1;
    *rows = H <= 256 ? 32 : 16;
    *smem = static_cast<int>(H <= 256 ? smem_bytes<2>(H) : smem_bytes<1>(H));
    *coresident = 0;
    gru_row_tiled_slice(H, units, resident, streamed);
    return 0;
  }
  int mt = 0;
  cudaError_t err = cluster_row_tiles(D, B, H, &mt);
  if (err == cudaSuccess)
    err = mt == 2 ? cluster_design<2>(H, smem, coresident)
                  : cluster_design<1>(H, smem, coresident);
  gru_cluster_slice(H, cluster, units, resident, streamed);
  *rows = 16 * mt;
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

// Message for a cudaError_t returned by the functions above.
extern "C" const char* pbsed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
