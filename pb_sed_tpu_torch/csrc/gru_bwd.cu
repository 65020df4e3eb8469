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
// and a step's work is nothing; what a step costs is the latency of its
// chain. Only dh is carried from step to step: the gate product
// h_prev[t] @ w_hh reads a saved input and depends on nothing the sweep
// computes. w_hh (384 KiB of bf16 per direction at H = 256, 1.5 MiB at
// H = 512) does not fit one block's shared memory, and a step needs it
// twice: h_prev @ w_hh for the gates and dgates @ w_hh^T for dh.
//
// Two designs, chosen by shape in pbsed_gru_scan_bwd
// (pbsed_gru_bwd_design says which):
//
// 1. Few rows, many steps (the training step: B = 32, T = 500), and at
//    H = 512 every shape (the rule is gru_cluster_takes in
//    gru_cluster.cuh): gru_bwd_cluster_kernel below, the forward's cluster
//    layout. A cluster of C = H / 32 blocks per (direction, tile of 16
//    rows; of 32 at H = 256 when the clusters of 16 would not all be on
//    the card at once); block c owns 32 hidden units and keeps the SAME slice
//    w_hh[:, cols(U_c)] as the forward, transposed, in shared memory: it
//    is the B operand of both products. Each step t (descending):
//    - gate math for the block's own units (lane = unit, warp = row, dh of
//      those units in registers; xw[t] and g[t] were loaded into registers
//      a step ahead): dxw and r to global memory, bf16 dgates_own (rows x
//      96) to shared memory;
//    - all 16 warps: dgates_own @ slice^T (K = 96), a (rows x H) f32
//      partial of dh over ALL hidden units; each 16 x 16 tile is stored
//      straight into slot c of the receive buffer of the block that owns
//      those units (distributed shared memory); cluster barrier arrive;
//    - while that is in flight, 12 warps compute the NEXT step's gate
//      product h_prev[t - 1] @ slice from a ring of bf16 h_prev rows that
//      cp.async filled a step ahead: it is off the chain;
//    - cluster barrier wait; the owner adds the C slots IN RANK ORDER to
//      its dh, so two runs agree in every bit. Against the row-tiled
//      kernel only the f32 rounding of the sum over K changes.
//    The receive buffer is double-buffered, so one cluster barrier a step
//    is enough: step t - 2 writes the buffer of step t only after every
//    block has passed the barrier of step t - 1, which it reaches after it
//    has read step t's slots.
// 2. Every other shape: the row-tiled sweep of gru_bwd.cuh (one block per
//    (direction, tile of 32 batch rows, 16 when H > 256), w_hh fragments
//    from global memory twice a step, four barriers a step), which the
//    fused variant (gru_bwd_fused.cu) always runs.
#include "gru_bwd.cuh"
#include "gru_cluster.cuh"

namespace {

constexpr int kClLdr = 36;   // f32 row stride of a receive slot (32 units)
constexpr int kClLdd = 104;  // bf16 row stride of the dgates_own buffer

// stage t & 1 of the ring <- bf16 h_prev[t] of the tile's rows (cp.async)
__device__ __forceinline__ void cl_fetch_h_prev(
    __nv_bfloat16* hp, const __nv_bfloat16* h_prev_tile, int t, int rows,
    int R, int T, int H) {
  const int ldh = H + kClPad;
  const int chunks = H / 8;  // 16-byte chunks of one row
  __nv_bfloat16* stage = hp + (t & 1) * R * ldh;
  for (int c = threadIdx.x; c < rows * chunks; c += kClThreads) {
    const int r = c / chunks;
    const int q = c - r * chunks;
    __pipeline_memcpy_async(
        stage + r * ldh + q * 8,
        h_prev_tile + (static_cast<size_t>(r) * T + t) * H + q * 8, 16);
  }
}

// The cluster design (1. above). grid = (C * row tiles, D) in clusters of
// C = H / 32 along x; 512 threads.
template <int MT>
__global__ void __launch_bounds__(kClThreads, 1)
gru_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ xw,      // (D, B, T, 3H)
                       const __nv_bfloat16* __restrict__ h_prev,  // (D, B, T, H)
                       const __nv_bfloat16* __restrict__ w_hh,    // (D, H, 3H)
                       const float* __restrict__ b_hh,            // (D, 3H)
                       const float* __restrict__ g,               // (D, B, T, H)
                       __nv_bfloat16* __restrict__ dxw,           // (D, B, T, 3H)
                       __nv_bfloat16* __restrict__ r_out,         // (D, B, T, H)
                       float* __restrict__ dh0,                   // (D, B, H)
                       int B, int T, int H) {
  constexpr int R = 16 * MT;  // batch rows per cluster
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  const int ldh = H + kClPad;
  const int C = H / kClUnits;
  __nv_bfloat16* sT = reinterpret_cast<__nv_bfloat16*>(smem);  // (96, ldh)
  __nv_bfloat16* hp = sT + kClCols * ldh;  // (2, R, ldh): h_prev ring
  float* recv = reinterpret_cast<float*>(hp + 2 * R * ldh);  // (2, C, R, kClLdr)
  float* gs = recv + 2 * C * R * kClLdr;                     // (2, R, kClLdg)
  __nv_bfloat16* dgs =
      reinterpret_cast<__nv_bfloat16*>(gs + 2 * R * kClLdg);  // (R, kClLdd)

  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cl_rank());
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * R;
  const int rows = min(R, B - b0);
  const int u0 = rank * kClUnits;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  cl_load_slice(sT, w_hh + static_cast<size_t>(d) * H * G, H, u0);
  // rows past the batch stay zero in both matmul operands
  for (int e = threadIdx.x; e < 2 * R * ldh; e += kClThreads) hp[e] = zero;
  for (int e = threadIdx.x; e < R * kClLdd; e += kClThreads) dgs[e] = zero;
  const float br = b_hh[static_cast<size_t>(d) * G + u0 + lane];
  const float bz = b_hh[static_cast<size_t>(d) * G + H + u0 + lane];
  const float bn = b_hh[static_cast<size_t>(d) * G + 2 * H + u0 + lane];
  const __nv_bfloat16* h_prev_tile =
      h_prev + (static_cast<size_t>(d) * B + b0) * T * H;
  // thread (warp, lane) owns unit u0 + lane of rows warp, warp + 16
  float dh[MT];
  size_t row0[MT];  // (d, b0 + row, t = 0) as a row index of (D * B * T)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    dh[i] = 0.f;
    // a valid row also past the batch: its loads run, their values are not used
    row0[i] = (static_cast<size_t>(d) * B + b0 + min(warp + 16 * i, rows - 1)) *
              T;
  }
  __nv_bfloat16 nx_r[MT], nx_z[MT], nx_n[MT];
  float nx_g[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const size_t row = row0[i] + T - 1;
    nx_r[i] = xw[row * G + u0 + lane];
    nx_z[i] = xw[row * G + H + u0 + lane];
    nx_n[i] = xw[row * G + 2 * H + u0 + lane];
    nx_g[i] = g[row * H + u0 + lane];
  }
  __syncthreads();  // the zeroed ring before cp.async writes into it
  cl_fetch_h_prev(hp, h_prev_tile, T - 1, rows, R, T, H);
  __pipeline_commit();
  if (T >= 2) cl_fetch_h_prev(hp, h_prev_tile, T - 2, rows, R, T, H);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();
  cl_gate_product<MT>(hp + ((T - 1) & 1) * R * ldh, sT, gs, H, warp);
  // every block of the cluster runs before any store from another block
  // lands in its receive buffer (also the block barrier after gs)
  cl_arrive();
  cl_wait();

  const int tiles_per_warp = H / (16 * kClWarps);  // 1 at H = 256, 2 at 512
  for (int t = T - 1; t >= 0; --t) {
    const int cur = t & 1;
    float x_r[MT], x_z[MT], x_n[MT], g_t[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      x_r[i] = __bfloat162float(nx_r[i]);
      x_z[i] = __bfloat162float(nx_z[i]);
      x_n[i] = __bfloat162float(nx_n[i]);
      g_t[i] = nx_g[i];
    }
    if (t > 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const size_t row = row0[i] + t - 1;
        nx_r[i] = xw[row * G + u0 + lane];
        nx_z[i] = xw[row * G + H + u0 + lane];
        nx_n[i] = xw[row * G + 2 * H + u0 + lane];
        nx_g[i] = g[row * H + u0 + lane];
      }
    }
    const __nv_bfloat16* hp_t = hp + cur * R * ldh;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = warp + 16 * i;
      if (r < rows) {  // the same for all lanes of a warp
        const size_t row = row0[i] + t;
        const float* g0 = gs + r * kClLdg + lane;
        const float* g1 = g0 + R * kClLdg;
        const float hn = (g0[2 * kClUnits] + g1[2 * kClUnits]) + bn;
        const float rr = cl_sigmoid(x_r[i] + ((g0[0] + g1[0]) + br));
        const float zz =
            cl_sigmoid(x_z[i] + ((g0[kClUnits] + g1[kClUnits]) + bz));
        const float nn = tanhf(x_n[i] + rr * hn);
        const float h_p = __bfloat162float(hp_t[r * ldh + u0 + lane]);
        const float dht = g_t[i] + dh[i];
        const float dz = dht * (h_p - nn) * zz * (1.f - zz);
        const float dpn = dht * (1.f - zz) * (1.f - nn * nn);
        const float dpr = dpn * hn * rr * (1.f - rr);
        __nv_bfloat16* dx_t = dxw + row * G + u0 + lane;
        dx_t[0] = __float2bfloat16(dpr);
        dx_t[H] = __float2bfloat16(dz);
        dx_t[2 * H] = __float2bfloat16(dpn);
        r_out[row * H + u0 + lane] = __float2bfloat16(rr);
        __nv_bfloat16* dg_r = dgs + r * kClLdd + lane;
        dg_r[0] = __float2bfloat16(dpr);
        dg_r[kClUnits] = __float2bfloat16(dz);
        dg_r[2 * kClUnits] = __float2bfloat16(dpn * rr);
        dh[i] = dht * zz;
      }
    }
    __syncthreads();
    // h_prev[t - 2] into the stage h_prev[t] leaves: a step ahead of its
    // use; an empty group where there is none, so that the count below holds
    if (t >= 2) cl_fetch_h_prev(hp, h_prev_tile, t - 2, rows, R, T, H);
    __pipeline_commit();

    // partial of dh over all hidden units from this block's 96 gate
    // columns: warp w -> hidden columns [16 w tpw, 16 (w + 1) tpw), each
    // 16 x 16 tile stored into slot `rank` of its owner's receive buffer
    {
      FragC acc[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[m][f], 0.f);
#pragma unroll
      for (int k = 0; k < kClColTiles; ++k) {
        FragA a_frag[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          wmma::load_matrix_sync(a_frag[m], dgs + m * 16 * kClLdd + k * 16,
                                 kClLdd);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (f < tiles_per_warp) {
            FragB b_frag;
            wmma::load_matrix_sync(
                b_frag, sT + k * 16 * ldh + (warp * tiles_per_warp + f) * 16,
                ldh);
#pragma unroll
            for (int m = 0; m < MT; ++m)
              wmma::mma_sync(acc[m][f], a_frag[m], b_frag, acc[m][f]);
          }
        }
      }
      float* slot = recv + (cur * C + rank) * R * kClLdr;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if (f < tiles_per_warp) {
          const int tile = warp * tiles_per_warp + f;  // 16 hidden units
          float* dst = cluster.map_shared_rank(slot + (tile % 2) * 16,
                                               static_cast<unsigned>(tile / 2));
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wmma::store_matrix_sync(dst + m * 16 * kClLdr, acc[m][f], kClLdr,
                                    wmma::mem_row_major);
        }
      }
    }
    cl_arrive();
    if (t > 0) {
      // the next step's gate product, while the partials are in flight
      __pipeline_wait_prior(1);
      __syncthreads();
      cl_gate_product<MT>(hp + (cur ^ 1) * R * ldh, sT, gs, H, warp);
      __syncthreads();  // gs complete before the next step's gate math
    }
    cl_wait();
    // dh of the own units: the C partials in rank order
    const float* mine = recv + cur * C * R * kClLdr;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = warp + 16 * i;
      if (r < rows) {
        float sum = mine[r * kClLdr + lane];
        for (int c = 1; c < C; ++c)
          sum += mine[(c * R + r) * kClLdr + lane];
        dh[i] += sum;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = warp + 16 * i;
    if (r < rows)
      dh0[(static_cast<size_t>(d) * B + b0 + r) * H + u0 + lane] = dh[i];
  }
}

template <int MT>
size_t bwd_cluster_smem_bytes(int H) {
  constexpr int R = 16 * MT;
  const size_t ldh = H + kClPad;
  const size_t C = H / kClUnits;
  return 2 * (kClCols + 2 * R) * ldh + 4 * 2 * C * R * kClLdr +
         4 * 2 * R * kClLdg + 2 * R * kClLdd;
}

// shared memory a block and co-resident clusters of the design with
// 16 MT rows at hidden size H (asked of the CUDA runtime once per size)
template <int MT>
cudaError_t bwd_cluster_design(int H, int* smem, int* coresident) {
  static int cached[2] = {0, 0};
  int& slot = cached[H == 512];
  *smem = static_cast<int>(bwd_cluster_smem_bytes<MT>(H));
  if (slot == 0) {
    const cudaError_t err = gru_cluster_coresident(
        gru_bwd_cluster_kernel<MT>, H / kClUnits, *smem, &slot);
    if (err != cudaSuccess) return err;
  }
  *coresident = slot;
  return cudaSuccess;
}

// 1 or 2 row tiles of 16 a cluster (gru_cluster_row_tiles); at H = 512
// the receive buffers leave room for one only
cudaError_t bwd_cluster_row_tiles(int D, int B, int H, int* mt) {
  int smem = 0, coresident = 0;
  const cudaError_t err = bwd_cluster_design<1>(H, &smem, &coresident);
  if (err == cudaSuccess)
    *mt = H > 256 ? 1 : gru_cluster_row_tiles(D, B, coresident);
  return err;
}

template <int MT>
cudaError_t launch_bwd_cluster(const void* xw, const void* h_prev,
                               const void* w_hh, const void* b_hh,
                               const void* g, void* dxw, void* r, void* dh0,
                               int D, int B, int T, int H,
                               cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const int C = H / kClUnits;
  int smem = 0, coresident = 0;
  cudaError_t err = bwd_cluster_design<MT>(H, &smem, &coresident);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = gru_cluster_config(gru_bwd_cluster_kernel<MT>, C, smem,
                           dim3(C * ((B + R - 1) / R), D), stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, gru_bwd_cluster_kernel<MT>,
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(h_prev),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dxw),
      static_cast<__nv_bfloat16*>(r), static_cast<float*>(dh0), B, T, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// xw (D, B, T, 3H) bf16, h_prev (D, B, T, H) bf16 (= concat(h0, y[:-1])
// along T), w_hh (D, H, 3H) bf16, b_hh (D, 3H) f32, g (D, B, T, H) f32;
// outputs dxw (D, B, T, 3H) bf16, r (D, B, T, H) bf16, dh0 (D, B, H) f32.
// Contiguous, h_prev 16-byte aligned. Requires H % 32 == 0 and H <= 512.
// The cluster design where gru_cluster_takes says so; else the row-tiled
// sweep (blockDim = H; tiles of 32 rows up to H = 256, of 16 above).
// Returns a cudaError_t (cudaErrorLaunchOutOfResources where the card
// holds no cluster of the design at all).
extern "C" int pbsed_gru_scan_bwd(const void* xw, const void* h_prev,
                                  const void* w_hh, const void* b_hh,
                                  const void* g, void* dxw, void* r,
                                  void* dh0, int D, int B, int T, int H,
                                  void* stream) {
  if (H % 32 != 0 || H < 32 || H > 512 || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!gru_cluster_takes(D, B, T, H))
    return static_cast<int>(gru_bwd_sweep<false>(xw, h_prev, w_hh, b_hh, g,
                                                 dxw, r, dh0, nullptr, nullptr,
                                                 nullptr, D, B, T, H, s));
  int mt = 0;
  cudaError_t err = bwd_cluster_row_tiles(D, B, H, &mt);
  if (err == cudaSuccess)
    err = mt == 2 ? launch_bwd_cluster<2>(xw, h_prev, w_hh, b_hh, g, dxw, r,
                                          dh0, D, B, T, H, s)
                  : launch_bwd_cluster<1>(xw, h_prev, w_hh, b_hh, g, dxw, r,
                                          dh0, D, B, T, H, s);
  return static_cast<int>(err);
}

// Which design pbsed_gru_scan_bwd runs at (D, B, T, H); the arguments and
// the result as pbsed_gru_design (gru.cu).
extern "C" int pbsed_gru_bwd_design(int D, int B, int T, int H, int* cluster,
                                    int* rows, int* smem, int* coresident) {
  if (!gru_cluster_takes(D, B, T, H)) {
    *cluster = 1;
    *rows = H <= 256 ? 32 : 16;
    *smem = static_cast<int>(H <= 256 ? smem_bytes<2>(H) : smem_bytes<1>(H));
    *coresident = 0;
    return 0;
  }
  int mt = 0;
  cudaError_t err = bwd_cluster_row_tiles(D, B, H, &mt);
  if (err == cudaSuccess)
    err = mt == 2 ? bwd_cluster_design<2>(H, smem, coresident)
                  : bwd_cluster_design<1>(H, smem, coresident);
  *cluster = H / kClUnits;
  *rows = 16 * mt;
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}
