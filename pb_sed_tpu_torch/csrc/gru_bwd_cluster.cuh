// The cluster design of the GRU backward's reverse sweep (gru_bwd.cu
// states the recurrence and its rounding points), shared by the split
// backward (gru_bwd.cu, FUSED false) and the fused one (gru_bwd_fused.cu,
// FUSED true), and the launch and occupancy helpers of both.
//
// The chain of a step. A cluster of C = H / 32 blocks per (direction,
// tile of 16 rows; of 32 at H = 256 when the clusters of 16 would not all
// be on the card at once); block c owns 32 hidden units and keeps the SAME
// slice w_hh[:, cols(U_c)] as the forward, transposed, in shared memory:
// it is the B operand of both products. Each step t (descending):
// - gate math for the block's own units (lane = unit, warp = row, dh of
//   those units in registers; xw[t] and g[t] were loaded into registers a
//   step ahead): dxw and r to global memory, bf16 dgates_own (rows x 96)
//   to shared memory;
// - all 16 warps: dgates_own @ slice^T (K = 96), a (rows x H) f32 partial
//   of dh over ALL hidden units; each 16 x 16 tile is stored straight into
//   slot c of the receive buffer of the block that owns those units
//   (distributed shared memory); cluster barrier arrive;
// - while that is in flight, 12 warps compute the NEXT step's gate product
//   h_prev[t - 1] @ slice from a ring of bf16 h_prev rows that cp.async
//   filled a step ahead: it is off the chain;
// - cluster barrier wait; the owner adds the C slots IN RANK ORDER to its
//   dh, so two runs agree in every bit.
// The receive buffer is double-buffered, so one cluster barrier a step is
// enough: step t - 2 writes the buffer of step t only after every block
// has passed the barrier of step t - 1, which it reaches after it has read
// step t's slots.
//
// FUSED: dw_hh and db_hh accumulated off that chain. Block c owns the gate
// columns cols(U_c), so its part of the weight gradient,
// dw_hh[d][:, cols(U_c)] (H x 96 f32), is written by no other block of the
// cluster:
// - the gate math also adds the f32 dgates [dpr, dz, dpn * r] of its rows
//   to per-thread db sums and stores the bf16 dgates into a ring of 16
//   steps in global memory (rows x 16 x 96 bf16 a block, 48 KiB at 16
//   rows; zeroed once at the start), slot t % 16;
// - after the steps t = 16 g (every 16 steps and at t = 0), between the
//   barrier's arrive and its wait: the block's slice += h_prev[rows,
//   16 g .. 16 g + 15]^T @ ring, one K = 16 product a batch row, A read
//   column-major straight from h_prev in global memory (16 steps of a row
//   are 16 contiguous rows of H), B from the ring; the warps take the
//   (16 hidden units, 3 gate-column tiles) passes of the slice in turn,
//   3 f32 16 x 16 accumulators in registers while a pass runs. The slice
//   lives in dw_part, one read-modify-write per 16 steps (the top group
//   stores without reading: no zeroing). Slots of steps >= T stay zero; their A
//   rows are the next batch row's first steps, or, past the last row, the
//   15 H values of padding the wrapper puts after h_prev;
// - at the end the 16 warps' db sums are added in warp order.
// The partials (one per (direction, row tile)) are added over the row
// tiles in tile order by a second kernel (gru_bwd_fused.cu): two runs
// agree in every bit.
//
// Shared memory (227 KiB a block): the split design takes 218 KiB at
// H = 512 (slice 96 KiB + h_prev ring 32 KiB + receive slots 72 KiB + gate
// buffers 16 KiB) and 118 KiB at H = 256, 16 rows. FUSED adds none: the
// 192 KiB f32 accumulator of H = 512 fits neither the 9 KiB left nor the
// registers beside the chain's (96 more a thread), and a 16-step dgates
// ring (48 KiB) does not fit either, so both live in global memory, where
// L2 holds them (3 MiB of slices and 3 MiB of rings at (2, 32, 500, 512));
// db's final sum reuses the gate buffer.
#pragma once

#include "gru_cluster.cuh"

namespace {

constexpr int kDwSteps = 16;  // FUSED: steps per dw_hh accumulation

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

// FUSED: the block's slice of dw_hh ((H, 3H) f32 at dw_blk, its columns
// cols(U_c)) += h_prev[b, t0 .. t0 + 15]^T @ ring[b] summed over the
// tile's rows b (ring: (rows, 16, 96) bf16, slot k = step t0 + k);
// `first` stores without reading the slice; the block's `warps` warps
// take the passes in turn. kDwTiles of the 6 gate-column tiles a pass:
// that many accumulators fit in registers beside the chain's without a
// spill (6 do not)
constexpr int kDwTiles = 3;

__device__ __forceinline__ void cl_dw_group(float* dw_blk,
                                            const __nv_bfloat16* h_prev_tile,
                                            const __nv_bfloat16* ring,
                                            int t0, int rows, int T, int H,
                                            int u0, bool first, int warp,
                                            int warps) {
  using namespace nvcuda;
  const int G = 3 * H;
  constexpr int kPasses = kClColTiles / kDwTiles;  // per 16 hidden units
  for (int pass = warp; pass < (H / 16) * kPasses; pass += warps) {
    const int mh = pass / kPasses;                // 16 hidden units
    const int n0 = pass % kPasses * kDwTiles;     // first column tile
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kDwTiles];
    // column tile n: gate n / 2, units 16 (n % 2) .. of the block's 32
    float* c_row = dw_blk + static_cast<size_t>(16 * mh) * G + u0;
#pragma unroll
    for (int j = 0; j < kDwTiles; ++j) {
      const int n = n0 + j;
      if (first)
        wmma::fill_fragment(acc[j], 0.f);
      else
        wmma::load_matrix_sync(acc[j], c_row + (n / 2) * H + (n % 2) * 16, G,
                               wmma::mem_row_major);
    }
    for (int b = 0; b < rows; ++b) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          a_frag;  // h_prev^T: (hidden units, steps)
      wmma::load_matrix_sync(
          a_frag, h_prev_tile + (static_cast<size_t>(b) * T + t0) * H + 16 * mh,
          H);
      const __nv_bfloat16* ring_b =
          ring + static_cast<size_t>(b) * kDwSteps * kClCols + 16 * n0;
#pragma unroll
      for (int j = 0; j < kDwTiles; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            b_frag;
        wmma::load_matrix_sync(b_frag, ring_b + 16 * j, kClCols);
        wmma::mma_sync(acc[j], a_frag, b_frag, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kDwTiles; ++j) {
      const int n = n0 + j;
      wmma::store_matrix_sync(c_row + (n / 2) * H + (n % 2) * 16, acc[j], G,
                              wmma::mem_row_major);
    }
  }
}

// The cluster design. grid = (C * row tiles, D) in clusters of C = H / 32
// along x; 512 threads. FUSED: no r_out; dw_part ((D * row tiles, H, 3H)
// f32), db_part ((D * row tiles, 3H) f32) and dg_ring ((D * row tiles, C,
// 16 MT, 16, 96) bf16) as described above.
template <int MT, bool FUSED>
__global__ void __launch_bounds__(kClThreads, 1)
gru_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ xw,      // (D, B, T, 3H)
                       const __nv_bfloat16* __restrict__ h_prev,  // (D, B, T, H)
                       const __nv_bfloat16* __restrict__ w_hh,    // (D, H, 3H)
                       const float* __restrict__ b_hh,            // (D, 3H)
                       const float* __restrict__ g,               // (D, B, T, H)
                       __nv_bfloat16* __restrict__ dxw,           // (D, B, T, 3H)
                       __nv_bfloat16* __restrict__ r_out,         // split only
                       float* __restrict__ dh0,                   // (D, B, H)
                       float* dw_part, float* db_part,            // FUSED only
                       __nv_bfloat16* dg_ring,                    // FUSED only
                       int B, int T, int H) {
  using namespace nvcuda;
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
  // FUSED: this (direction, row tile)'s partial and this block's ring
  const size_t part =
      static_cast<size_t>(d) * (gridDim.x / C) + blockIdx.x / C;
  float* dw_blk = FUSED ? dw_part + part * H * G : nullptr;
  __nv_bfloat16* ring =
      FUSED ? dg_ring + (part * C + rank) * R * kDwSteps * kClCols : nullptr;
  if constexpr (FUSED) {
    for (int e = threadIdx.x; e < R * kDwSteps * kClCols; e += kClThreads)
      ring[e] = zero;
  }
  float db_r = 0.f, db_z = 0.f, db_n = 0.f;  // FUSED: unit u0 + lane
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
        const __nv_bfloat16 dg_r = __float2bfloat16(dpr);
        const __nv_bfloat16 dg_z = __float2bfloat16(dz);
        const __nv_bfloat16 dg_n = __float2bfloat16(dpn * rr);
        __nv_bfloat16* dg_own = dgs + r * kClLdd + lane;
        dg_own[0] = dg_r;
        dg_own[kClUnits] = dg_z;
        dg_own[2 * kClUnits] = dg_n;
        if constexpr (FUSED) {
          db_r += dpr;
          db_z += dz;
          db_n += dpn * rr;
          __nv_bfloat16* slot =
              ring + (static_cast<size_t>(r) * kDwSteps + (t & (kDwSteps - 1))) *
                         kClCols + lane;
          slot[0] = dg_r;
          slot[kClUnits] = dg_z;
          slot[2 * kClUnits] = dg_n;
        } else {
          r_out[row * H + u0 + lane] = __float2bfloat16(rr);
        }
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
    if constexpr (FUSED) {
      // the ring's 16 steps from t (written before the block barrier
      // above) into the slice; the next step's ring stores come after the
      // block barrier below
      if ((t & (kDwSteps - 1)) == 0)
        cl_dw_group(dw_blk, h_prev_tile, ring, t, rows, T, H, u0,
                    t + kDwSteps >= T, warp, kClWarps);
    }
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
  if constexpr (FUSED) {
    // db of the block's 96 gate columns: the warps' sums in warp order,
    // through gs (last read by the gate math of t = 0)
    float* red = gs;  // (16 warps, 96)
    red[warp * kClCols + lane] = db_r;
    red[warp * kClCols + kClUnits + lane] = db_z;
    red[warp * kClCols + 2 * kClUnits + lane] = db_n;
    __syncthreads();
    if (threadIdx.x < kClCols) {
      float sum = 0.f;
      for (int w = 0; w < kClWarps; ++w) sum += red[w * kClCols + threadIdx.x];
      db_part[part * G + (threadIdx.x / kClUnits) * H + u0 +
              threadIdx.x % kClUnits] = sum;
    }
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
template <int MT, bool FUSED>
cudaError_t bwd_cluster_design(int H, int* smem, int* coresident) {
  static int cached[2] = {0, 0};
  int& slot = cached[H == 512];
  *smem = static_cast<int>(bwd_cluster_smem_bytes<MT>(H));
  if (slot == 0) {
    const cudaError_t err = gru_cluster_coresident(
        gru_bwd_cluster_kernel<MT, FUSED>, H / kClUnits, *smem, &slot);
    if (err != cudaSuccess) return err;
  }
  *coresident = slot;
  return cudaSuccess;
}

// 1 or 2 row tiles of 16 a cluster (gru_cluster_row_tiles); at H = 512
// the receive buffers leave room for one only
template <bool FUSED>
cudaError_t bwd_cluster_row_tiles(int D, int B, int H, int* mt) {
  int smem = 0, coresident = 0;
  const cudaError_t err = bwd_cluster_design<1, FUSED>(H, &smem, &coresident);
  if (err == cudaSuccess)
    *mt = H > 256 ? 1 : gru_cluster_row_tiles(D, B, coresident);
  return err;
}

template <int MT, bool FUSED>
cudaError_t launch_bwd_cluster(const void* xw, const void* h_prev,
                               const void* w_hh, const void* b_hh,
                               const void* g, void* dxw, void* r, void* dh0,
                               void* dw_part, void* db_part, void* dg_ring,
                               int D, int B, int T, int H,
                               cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const int C = H / kClUnits;
  int smem = 0, coresident = 0;
  cudaError_t err = bwd_cluster_design<MT, FUSED>(H, &smem, &coresident);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = gru_cluster_config(gru_bwd_cluster_kernel<MT, FUSED>, C, smem,
                           dim3(C * ((B + R - 1) / R), D), stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, gru_bwd_cluster_kernel<MT, FUSED>,
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(h_prev),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dxw),
      static_cast<__nv_bfloat16*>(r), static_cast<float*>(dh0),
      static_cast<float*>(dw_part), static_cast<float*>(db_part),
      static_cast<__nv_bfloat16*>(dg_ring), B, T, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What the design queries report of the cluster design at (D, B, H)
// (split or FUSED; gru_bwd_rows.cuh:bwd_design): 1 and the cluster's
// size, rows, shared memory a block, co-resident clusters and the slice
// of w_hh; -cudaError_t on a failed query.
template <bool FUSED>
int bwd_cluster_report(int D, int B, int H, int* cluster, int* rows,
                       int* smem, int* coresident, int* units, int* resident,
                       int* streamed) {
  int mt = 0;
  cudaError_t err = bwd_cluster_row_tiles<FUSED>(D, B, H, &mt);
  if (err == cudaSuccess)
    err = mt == 2 ? bwd_cluster_design<2, FUSED>(H, smem, coresident)
                  : bwd_cluster_design<1, FUSED>(H, smem, coresident);
  gru_cluster_slice(H, cluster, units, resident, streamed);
  *rows = 16 * mt;
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

// The cluster sweep at a shape gru_cluster_takes accepts: 16 or 32 rows a
// cluster (bwd_cluster_row_tiles); *rows says which
template <bool FUSED>
cudaError_t bwd_cluster(const void* xw, const void* h_prev, const void* w_hh,
                        const void* b_hh, const void* g, void* dxw, void* r,
                        void* dh0, void* dw_part, void* db_part,
                        void* dg_ring, int D, int B, int T, int H,
                        cudaStream_t s, int* rows) {
  int mt = 0;
  cudaError_t err = bwd_cluster_row_tiles<FUSED>(D, B, H, &mt);
  if (err != cudaSuccess) return err;
  *rows = 16 * mt;
  return mt == 2
             ? launch_bwd_cluster<2, FUSED>(xw, h_prev, w_hh, b_hh, g, dxw, r,
                                            dh0, dw_part, db_part, dg_ring, D,
                                            B, T, H, s)
             : launch_bwd_cluster<1, FUSED>(xw, h_prev, w_hh, b_hh, g, dxw, r,
                                            dh0, dw_part, db_part, dg_ring, D,
                                            B, T, H, s);
}

}  // namespace
