// An alternative to the GRU backwards' wgmma rows design
// (csrc/gru_bwd_rows.cuh), kept here to be measured: the blocks of a
// cluster exchange their bf16 dgates instead of f32 partials of dh. Built
// only by scripts/perf/gru_bwd_designs.py (``--dgates``), which times it
// against the rows design; the split backward only, H = 32 C up to 192
// (above, its shared memory does not fit a block).
//
// The layout is the rows design's (a cluster of C = H / 32 blocks per
// tile of 64 rows, block c owning units U_c and its slice w_hh[:, cols(U_c)]
// for the gate recompute, the gates' factors a step ahead, dxw and r by
// TMA), but each block also keeps the rows w_hh[U_c, :] (32 x 3H bf16,
// K-major boxes of 32 x 32) and a tile of every block's bf16 dgates of
// the step (64 rows x 3H, the A operand: chunk k of 32 columns is gate
// k / C of block k % C). A step t:
// - wait until the peers' dgates of step t + 1 have landed (bulk copies of
//   their three chunks, the rows of the batch); the block's own chunks
//   are already there. dh of the block's units = dh_t+1 * z + dgates
//   (64 x 3H) @ w_hh[U_c, :]^T on wgmma, both operands in shared memory,
//   the K of 3H in two accumulator chains: no sum over blocks. Arrive at
//   the cluster barrier (the tile is read);
// - the gate math on the chain; the bf16 dgates into the block's own three
//   chunks of the tile, dxw into xw's stage;
// - one block barrier, the cluster barrier's wait (every block is done
//   with its tile), and one thread sends the three chunks to every peer's
//   tile (the same offsets) and stores dxw and r by TMA;
// - the gate recompute and factors of step t - 1, while the dgates fly.
// Per step a block sends 3 (C - 1) chunks of 2 KiB a warp of rows (bf16
// dgates of 96 columns), against C - 1 slots of 2 KiB a warp (f32
// partials of 32 columns) in the rows design.
#pragma once

#include "gru_bwd_rows.cuh"

namespace {

// Shared memory a block at hidden size H: the slice (192 H), w_hh's rows
// of the block (192 H), the state's stage (128 H), two xw stages and two
// r boxes (32 KiB), the dgates tile (384 H), b_hh of the block's columns,
// five mbarriers and 1 KiB to align the base.
__host__ __device__ constexpr int dgx_smem(int H) {
  return 1024 + 192 * H + 192 * H + 128 * H + 8 * kRowsBox + 384 * H +
         12 * kRowsU + 5 * 8;
}

// d[64 x 32] += A[64 x 16] (shared memory, K-major) * B[16 x 32] (shared
// memory, K-major), f32 accumulators
__device__ __forceinline__ void dgx_wgmma(float (&d)[16], uint64_t desc_a,
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// grid = (C * row tiles, D) in clusters of C along x; 128 threads.
// w_rows_map: w_hh (D, H, 3H) in boxes of 32 columns x 32 rows.
template <int C>
__global__ void __launch_bounds__(kRowsThreads, 1)
gru_bwd_dgx_kernel(const __grid_constant__ CUtensorMap xw_map,
                   const __grid_constant__ CUtensorMap hp_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap w_rows_map,
                   const __grid_constant__ CUtensorMap dxw_map,
                   const __grid_constant__ CUtensorMap r_map,
                   const float* __restrict__ b_hh,
                   const float* __restrict__ g, float* __restrict__ dh0,
                   int B, int T) {
  constexpr int U = kRowsU;
  constexpr int H = C * U;
  constexpr int G = 3 * H;
  constexpr int SW = kRowsSW;
  constexpr int XG = kRowsBox;
  constexpr int J = U / 8;
  constexpr int N = U / 2;
  constexpr int WR = 32 * SW;  // bytes of a box of w_hh's rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ws = smem;                // (3, H, 32): the slice
  uint8_t* wr = ws + 6 * H * U;      // (3C, 32, 32): w_hh[U_c, :]
  uint8_t* hs = wr + 3 * C * WR;     // (C, 64, 32): h_prev[t]
  uint8_t* xs = hs + C * XG;         // (2, 3, 64, 32): xw, dxw
  uint8_t* rs = xs + 2 * 3 * XG;     // (2, 64, 32): r
  uint8_t* dg = rs + 2 * XG;         // (3C, 64, 32): every block's dgates
  float* sb = reinterpret_cast<float*>(dg + 3 * C * XG);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sb + 3 * U);
  uint64_t* xs_full = bars + 1;
  uint64_t* h_full = bars + 3;
  uint64_t* recv_full = bars + 4;

  const int rank = static_cast<int>(cl_rank());
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * kRowsM;
  const int rows = min(kRowsM, B - b0);
  const int u0 = rank * U;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int live = min(4, (rows + 15) / 16);
  const uint32_t chunk_bytes = live * 16 * SW;  // a chunk's rows sent
  const uint32_t recv_bytes = 3 * (C - 1) * chunk_bytes;
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 6 * H * U + 3 * C * WR);
    for (int gt = 0; gt < 3; ++gt)
      tma_load_3d(ws + gt * H * SW, &w_map, &bars[0], gt * H + u0, 0, d);
    for (int k = 0; k < 3 * C; ++k)
      tma_load_3d(wr + k * WR, &w_rows_map, &bars[0], 32 * k, u0, d);
    mbar_expect_tx(h_full, C * XG);
    for (int c = 0; c < C; ++c)
      tma_load_4d(hs + c * XG, &hp_map, h_full, c * U, T - 1, b0, d);
    for (int s = 0; s < 2 && s < T; ++s) {
      mbar_expect_tx(&xs_full[s], 3 * XG);
      for (int gt = 0; gt < 3; ++gt)
        tma_load_4d(xs + s * 3 * XG + gt * XG, &xw_map, &xs_full[s],
                    gt * H + u0, T - 1 - s, b0, d);
    }
    if (C > 1) mbar_expect_tx(recv_full, recv_bytes);
  }
  for (int i = tid; i < 3 * U; i += kRowsThreads)
    sb[i] = b_hh[static_cast<size_t>(d) * G + (i / U) * H + u0 + i % U];
  // the tile's rows past the batch stay zero (never sent)
  for (int e = tid; e < 3 * C * XG / 16; e += kRowsThreads)
    reinterpret_cast<uint4*>(dg)[e] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();
  cl_arrive();
  cl_wait();

  const uint32_t ws_u32 = smem_u32(ws);
  const uint32_t hs_u32 = smem_u32(hs);
  float fz[N], fn[N], fr[N], fg[N], fzz[N];
  auto factors = [&](int i) {
    float acc[3 * N];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int gt = 0; gt < 3; ++gt) {
        const float2 bias =
            *reinterpret_cast<const float2*>(sb + gt * U + 8 * j + cq);
        acc[gt * N + 4 * j] = acc[gt * N + 4 * j + 2] = bias.x;
        acc[gt * N + 4 * j + 1] = acc[gt * N + 4 * j + 3] = bias.y;
      }
    rows_bwd_gates<C>(acc, rows_bwd_opaque(hs_u32), rows_bwd_opaque(ws_u32));
    mbar_wait(&xs_full[i & 1], (i >> 1) & 1);
    const uint8_t* x_t = xs + (i & 1) * 3 * XG;
    const uint8_t* own = hs + rank * XG;
    uint8_t* r_box = rs + (i & 1) * XG;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = 4 * j + 2 * half;
        const uint32_t off = swz<SW>((r0 + 8 * half) * SW + 2 * (8 * j + cq));
        const float2 xr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_t + off));
        const float2 xz = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_t + XG + off));
        const float2 xn = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_t + 2 * XG + off));
        const float2 hp = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(own + off));
        const float xv[3][2] = {{xr.x, xr.y}, {xz.x, xz.y}, {xn.x, xn.y}};
        const float hpe[2] = {hp.x, hp.y};
        float rv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hn = acc[2 * N + p + e];
          float rr, zz;
          rows_sigmoid2(xv[0][e] + acc[p + e], xv[1][e] + acc[N + p + e],
                        &rr, &zz);
          const float nn = rows_tanh(xv[2][e] + rr * hn);
          fz[p + e] = (hpe[e] - nn) * zz * (1.f - zz);
          fn[p + e] = (1.f - zz) * (1.f - nn * nn);
          fr[p + e] = fn[p + e] * hn * rr * (1.f - rr);
          fg[p + e] = fn[p + e] * rr;
          fzz[p + e] = zz;
          rv[e] = rr;
        }
        *reinterpret_cast<__nv_bfloat162*>(r_box + off) =
            __floats2bfloat162_rn(rv[0], rv[1]);
      }
    }
  };
  mbar_wait(&bars[0], 0);
  mbar_wait(h_full, 0);
  factors(0);
  __syncthreads();
  if (tid == 0 && T >= 2) {
    mbar_expect_tx(h_full, C * XG);
    for (int c = 0; c < C; ++c)
      tma_load_4d(hs + c * XG, &hp_map, h_full, c * U, T - 2, b0, d);
  }
  bool valid[2];
  size_t row_at0[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    valid[half] = r0 + 8 * half < rows;
    row_at0[half] = (static_cast<size_t>(d) * B + b0 +
                     min(r0 + 8 * half, rows - 1)) * T;
  }
  float dhz[N];
#pragma unroll
  for (int e = 0; e < N; ++e) dhz[e] = 0.f;
  // dh of the block's units = dhz + the tile (64 x 3H) @ w_hh[U_c, :]^T
  auto dh_product = [&](float (&dh)[N]) {
    constexpr uint32_t layout = swizzle_layout<SW>();
    const uint32_t dg_u32 = rows_bwd_opaque(smem_u32(dg));
    const uint32_t wr_u32 = rows_bwd_opaque(smem_u32(wr));
    float pa[N], pb[N];
#pragma unroll
    for (int e = 0; e < N; ++e) pa[e] = pb[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 6 * C; ++k) {
      const uint64_t da =
          gmma_desc(dg_u32 + (k / 2) * XG + 32 * (k % 2), 16, 8 * SW, layout);
      const uint64_t db =
          gmma_desc(wr_u32 + (k / 2) * WR + 32 * (k % 2), 16, 8 * SW, layout);
      if (k % 2)
        dgx_wgmma(pb, da, db);
      else
        dgx_wgmma(pa, da, db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(pb);
#pragma unroll
    for (int e = 0; e < N; ++e) dh[e] = dhz[e] + (pa[e] + pb[e]);
  };

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    float g_t[N];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float2 v = make_float2(0.f, 0.f);
        if (valid[half])
          v = *reinterpret_cast<const float2*>(
              g + (row_at0[half] + t) * H + u0 + 8 * j + cq);
        g_t[4 * j + 2 * half] = v.x;
        g_t[4 * j + 2 * half + 1] = v.y;
      }
    float dh[N];
    if (i == 0) {
#pragma unroll
      for (int e = 0; e < N; ++e) dh[e] = 0.f;
    } else {
      if (C > 1) {
        mbar_wait(recv_full, (i - 1) & 1);
        if (tid == 0) mbar_expect_tx(recv_full, recv_bytes);
      }
      dh_product(dh);
    }
    // the tile is read
    rows_bwd_arrive(dh);
    uint8_t* x_t = xs + (i & 1) * 3 * XG;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = 4 * j + 2 * half;
        float dgv[3][2], dpn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dht = g_t[p + e] + dh[p + e];
          dgv[0][e] = dht * fr[p + e];
          dgv[1][e] = dht * fz[p + e];
          dgv[2][e] = dht * fg[p + e];
          dpn[e] = dht * fn[p + e];
          dhz[p + e] = dht * fzz[p + e];
        }
        const uint32_t off = swz<SW>((r0 + 8 * half) * SW + 2 * (8 * j + cq));
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) {
          const uint32_t v = rows_bwd_pack(dgv[gt][0], dgv[gt][1]);
          // own chunk k = gate gt of this block: gt * C + rank
          *reinterpret_cast<uint32_t*>(dg + (gt * C + rank) * XG + off) = v;
          *reinterpret_cast<uint32_t*>(x_t + gt * XG + off) =
              gt < 2 ? v : rows_bwd_pack(dpn[0], dpn[1]);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();
    // every block is done with its tile
    cl_wait();
    if (tid == 96) {
#pragma unroll
      for (int k = 1; k < C; ++k) {
        const int dst = (rank + k) % C;
        for (int gt = 0; gt < 3; ++gt) {
          const uint32_t at =
              rows_bwd_opaque(smem_u32(dg + (gt * C + rank) * XG));
          rows_bwd_push(at, at, chunk_bytes,
                        rows_bwd_opaque(smem_u32(recv_full)), dst);
        }
      }
      for (int gt = 0; gt < 3; ++gt)
        rows_bwd_tma_store(&dxw_map, x_t + gt * XG, gt * H + u0, t, b0, d);
      rows_bwd_tma_store(&r_map, rs + (i & 1) * XG, u0, t, b0, d);
      rows_bwd_store_commit();
    }
    if (t >= 1) {
      mbar_wait(h_full, (i + 1) & 1);
      factors(i + 1);
    }
    if (tid == 96) {
      rows_bwd_store_read();
      if (t >= 2) {
        mbar_expect_tx(&xs_full[i & 1], 3 * XG);
        for (int gt = 0; gt < 3; ++gt)
          tma_load_4d(x_t + gt * XG, &xw_map, &xs_full[i & 1], gt * H + u0,
                      t - 2, b0, d);
      }
    }
    __syncthreads();
    if (tid == 64 && t >= 2) {
      mbar_expect_tx(h_full, C * XG);
      for (int c = 0; c < C; ++c)
        tma_load_4d(hs + c * XG, &hp_map, h_full, c * U, t - 2, b0, d);
    }
  }
  float dh[N];
  if (C > 1) mbar_wait(recv_full, (T - 1) & 1);
  dh_product(dh);
#pragma unroll
  for (int half = 0; half < 2; ++half)
    if (valid[half]) {
      float* out =
          dh0 + (static_cast<size_t>(d) * B + b0 + r0 + 8 * half) * H + u0;
#pragma unroll
      for (int j = 0; j < J; ++j)
        *reinterpret_cast<float2*>(out + 8 * j + cq) =
            make_float2(dh[4 * j + 2 * half], dh[4 * j + 2 * half + 1]);
    }
  if (tid == 96) rows_bwd_store_done();
  cl_arrive();
  cl_wait();
}

template <int C>
cudaError_t launch_dgx(const CUtensorMap* maps, const void* b_hh,
                       const void* g, void* dh0, int D, int B, int T,
                       cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = gru_cluster_config(
      gru_bwd_dgx_kernel<C>, C, dgx_smem(C * kRowsU),
      dim3(C * ((B + kRowsM - 1) / kRowsM), D), stream, &cfg, &attr,
      kRowsThreads);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gru_bwd_dgx_kernel<C>, maps[0], maps[1],
                           maps[2], maps[5], maps[3], maps[4],
                           static_cast<const float*>(b_hh),
                           static_cast<const float*>(g),
                           static_cast<float*>(dh0), B, T);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The split sweep on the dgates exchange: the arguments as
// pbsed_gru_scan_bwd's, H a multiple of 32 up to 192, T >= 1.
cudaError_t gru_bwd_dgx(const void* xw, const void* h_prev, const void* w_hh,
                        const void* b_hh, const void* g, void* dxw, void* r,
                        void* dh0, int D, int B, int T, int H,
                        cudaStream_t stream) {
  if (H > 192 || H % kRowsU || T < 1) return cudaErrorInvalidValue;
  CUtensorMap maps[6];  // xw, h_prev, w_hh, dxw, r, w_hh's rows
  const cuuint64_t row = 6ull * H;
  const cuuint64_t x_dims[4] = {3ull * H, static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t x_strides[3] = {row, row * T, row * T * B};
  const cuuint32_t box[4] = {kRowsU, 1, kRowsM, 1};
  const cuuint64_t h_row = 2ull * H;
  const cuuint64_t h_dims[4] = {static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t h_strides[3] = {h_row, h_row * T, h_row * T * B};
  const cuuint64_t w_dims[3] = {3ull * H, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t w_strides[2] = {row, row * H};
  const cuuint32_t w_box[3] = {kRowsU, static_cast<cuuint32_t>(H), 1};
  const cuuint32_t wr_box[3] = {kRowsU, kRowsU, 1};
  cudaError_t err = make_map(&maps[0], xw, 4, x_dims, x_strides, box,
                             kRowsSW);
  if (err == cudaSuccess)
    err = make_map(&maps[1], h_prev, 4, h_dims, h_strides, box, kRowsSW);
  if (err == cudaSuccess)
    err = make_map(&maps[2], w_hh, 3, w_dims, w_strides, w_box, kRowsSW);
  if (err == cudaSuccess)
    err = make_map(&maps[3], dxw, 4, x_dims, x_strides, box, kRowsSW);
  if (err == cudaSuccess)
    err = make_map(&maps[4], r, 4, h_dims, h_strides, box, kRowsSW);
  if (err == cudaSuccess)
    err = make_map(&maps[5], w_hh, 3, w_dims, w_strides, wr_box, kRowsSW);
  if (err != cudaSuccess) return err;
  switch (H / kRowsU) {
    case 1: return launch_dgx<1>(maps, b_hh, g, dh0, D, B, T, stream);
    case 2: return launch_dgx<2>(maps, b_hh, g, dh0, D, B, T, stream);
    case 3: return launch_dgx<3>(maps, b_hh, g, dh0, D, B, T, stream);
    case 4: return launch_dgx<4>(maps, b_hh, g, dh0, D, B, T, stream);
    case 5: return launch_dgx<5>(maps, b_hh, g, dh0, D, B, T, stream);
    case 6: return launch_dgx<6>(maps, b_hh, g, dh0, D, B, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
