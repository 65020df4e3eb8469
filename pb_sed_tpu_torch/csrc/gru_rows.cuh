// The GRU forward for many rows (gru.cu): sliding-window SED's
// (2, 16 000, 51, 256), the tuning chain's (2, 8 000, T, 256), a stacked
// ensemble's SED chunks (20, 2 000, 51, 256), and every H up to 512 that
// the cluster design of gru_cluster.cuh (H = 256 and 512 at few rows)
// does not take.
//
// Replaces: pb_sed_tpu/ops/pallas/gru.py:_gru_kernel (its pallas_call at
// :222) where gru_fwd_cluster_takes sends a shape here. The TPU kernel
// keeps all of w_hh in VMEM and tiles rows by 32; on Hopper w_hh (384 KiB
// of bf16 at H = 256, 1.5 MiB at 512) fits no block.
//
// What bounds it on the H100: the bytes. At (2, 16 000, 51, 256) the
// kernel reads 2.51 GB of bf16 xw and writes 1.67 GB of f32 y, 1.25 ms at
// the H100 SXM's 3.35 TB/s, against 0.64 TFLOP of products (0.65 ms at
// its 989 TFLOP/s; NVIDIA's data sheet, 700 W). It takes 3.146 ms there
// (NVIDIA H100 80GB HBM3, 700.00 W; scripts/gru_ab.py). The
// recurrence is serial in t, so what keeps HBM busy is many row tiles in
// flight, each a short chain a step: product, gate math, exchange.
//
// The layout. A cluster of C = H / 32 blocks serves one (direction, tile
// of 64 batch rows); block c owns the 32 hidden units [32c, 32c + 32) and
// so their 96 gate columns, the r, z and n stripes. w_hh stays resident:
// the block's slice w_hh[:, stripes] (H x 96 bf16, 48 KiB at H = 256, 96
// KiB at 512) is copied into shared memory once by TMA, straight from
// w_hh (D, H, 3H) with no packing (boxes of 32 columns x H or H / 2
// rows, the 64-byte swizzle: the MN-major B operand of wgmma), and never
// read from global memory again. The alternative, one block a tile
// streaming all of w_hh from L2 through a ring every step, moves 384 KiB
// of L2 a tile and step at H = 256 (9.8 GB at (2, 16 000, 51, 256),
// against 5.7 GB of distributed shared memory here) and needs the whole
// 3H-wide product of a step in one block: not built.
//
// A step t, one warpgroup a block (128 threads, 64 rows = wgmma's M):
// - wait until the copy of h[t - 1] (the tile's 64 rows, all H units,
//   bf16, in every block's shared memory as H / 32 chunks of 64 rows x
//   32 units, K-major and swizzled by 64 bytes: wgmma's canonical layout)
//   is complete: the other blocks' chunks count on its mbarrier as bytes;
// - the product on wgmma, both operands from shared memory: one
//   m64 x 96 x k16 product a k step over the three stripes, so that
//   accumulator i of the r, z and n columns holds the same (row, unit);
//   a commit group a chunk of K. The accumulators start at b_hh, so they
//   end at h @ w_hh + b_hh. Then the block arrives at a cluster barrier
//   (relaxed): it is done reading its copy;
// - the gate math on the accumulators in registers (no gate tile goes
//   through shared memory), sigmoid and tanh from ex2.approx and
//   rcp.approx: xw[t] is read from its stage (TMA copies of the three
//   stripes, boxes of 32 x 64 rows, loaded two steps ahead, so HBM
//   streams through the chain); the f32 state of the thread's
//   (row, unit) pairs lives in registers;
// - the cluster barrier's wait (every block is done reading its copy),
//   the new bf16 state of the block's units into its chunk of its copy,
//   one block barrier, and lane 0 of each warp sends the chunk to a
//   share of the other blocks by bulk copies (cp.async.bulk shared::cta
//   -> shared::cluster), each counted on the receiver's mbarrier; y[t]
//   is stored to global memory (f32 pairs) meanwhile.
// The layout takes at most 186 KiB (H = 512); up to H = 256 it takes 105
// KiB, so two blocks share an SM and the chains of two clusters
// interleave on it. Built and timed in development, and slower at
// (2, 16 000, 51, 256): 64 units a block (clusters of H / 64), two state
// copies (no barrier a step, one block an SM).
//
// Rounding points as the plain version (ops/kernels/gru.py:gru_scan_plain):
// bf16 xw, bf16 h into the product, f32 accumulation, f32 gate math and
// state, f32 y.
#pragma once

#include "conv2d_wgmma.cuh"
#include "gru_cluster.cuh"

namespace {

constexpr int kRowsM = 64;          // rows of a tile: one warpgroup's m64
constexpr int kRowsU = 32;          // units a block
constexpr int kRowsSW = 2 * kRowsU;       // bytes of a row of a chunk or box
constexpr int kRowsBox = kRowsM * kRowsSW;  // bytes of a chunk or xw box
constexpr int kRowsThreads = 128;   // one warpgroup a block

// Shared memory a block at hidden size H: the slice (3 x H x 32 bf16),
// two stages of xw (3 x 64 x 32 bf16), the state (64 x H bf16), b_hh of
// the block's columns (96 f32), four mbarriers, and 1 KiB to align the
// base for the swizzle.
__host__ __device__ constexpr int rows_smem(int H) {
  return 1024 + 6 * H * kRowsU + 6 * kRowsBox + 2 * kRowsM * H +
         12 * kRowsU + 4 * 8;
}

// sigmoid of two values and tanh from ex2.approx and rcp.approx (__expf,
// __fdividef): within about 1e-6 of the exact values, in a fraction of
// the instructions of expf, a division and tanhf. The two sigmoids share
// one reciprocal, 1 / ((1 + e^-a)(1 + e^-b)); a and b below -40 (sigmoid
// 4e-18) count as -40, so that the product stays finite.
__device__ __forceinline__ void rows_sigmoid2(float a, float b, float* sa,
                                              float* sb) {
  const float ea = 1.f + __expf(-fmaxf(a, -40.f));
  const float eb = 1.f + __expf(-fmaxf(b, -40.f));
  const float inv = __fdividef(1.f, ea * eb);
  *sa = eb * inv;
  *sb = ea * inv;
}

__device__ __forceinline__ float rows_tanh(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

// Built with GRU_ROWS_TIMING (scripts/perf/gru_designs.py --phases),
// thread 0 of block (0, 0) adds the SM cycles of each phase of its steps
// to g_rows_phase: the wait for the peers' chunks of the state, the
// product, the wait for xw, the gate math, the barriers before the
// exchange, the exchange's bulk copies, the stores of y. Without it the
// stamps compile to nothing.
constexpr int kRowsPhases = 7;
#ifdef GRU_ROWS_TIMING
__device__ long long g_rows_phase[kRowsPhases];
#define ROWS_STAMP(k)                                   \
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) { \
    const long long now = clock64();                    \
    g_rows_phase[k] += now - last_stamp;                \
    last_stamp = now;                                   \
  }
#else
#define ROWS_STAMP(k)
#endif

// d[64 x 96] += A[64 x 16] * B[16 x 96], both from shared memory: A
// K-major, B MN-major (the transpose bit set), f32 accumulators (the
// operand list spelled out)
__device__ __forceinline__ void rows_wgmma(float (&d)[48], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void rows_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// `bytes` of this block's shared memory at src into block `rank`'s at the
// same offset, by the bulk-copy engine, counted on that block's mbarrier
// at the offset of `bar`
__device__ __forceinline__ void rows_push(uint32_t src, uint32_t bytes,
                                          uint64_t* bar, uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(cl_map(src, rank)),
      "r"(src), "r"(bytes), "r"(cl_map(smem_u32(bar), rank))
      : "memory");
}

// acc (64 x 96, f32, wgmma's accumulator layout: columns [32g, 32g + 32)
// gate g of r, z, n) += h @ slice over K = H, one wgmma a k16 step: A
// from the state copy at hc (H / 32 chunks of 64 rows x 64 bytes,
// K-major, swizzled by 64 bytes: wgmma's canonical layout), B from the
// slice at ws (three stripes of H rows x 64 bytes, MN-major, swizzled by
// 64 bytes: one wgmma spans the three); a commit group a chunk.
__device__ __forceinline__ void rows_product(float (&acc)[48], uint32_t hc,
                                             uint32_t ws, int H) {
  constexpr uint32_t layout = swizzle_layout<kRowsSW>();
  const uint32_t stripe = static_cast<uint32_t>(H) * kRowsSW;
  wgmma_fence();
  for (int c = 0; c < H / kRowsU; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      rows_wgmma(acc,
                 gmma_desc(hc + c * kRowsBox + 32 * j, 16, 8 * kRowsSW,
                           layout),
                 gmma_desc(ws + (2 * c + j) * 16 * kRowsSW, stripe,
                           8 * kRowsSW, layout));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// grid = (C * row tiles, D) in clusters of C = H / 32 along x; 128
// threads.
__global__ void __launch_bounds__(kRowsThreads, 1)
gru_rows_kernel(const __grid_constant__ CUtensorMap xw_map,  // (D,B,T,3H)
                const __grid_constant__ CUtensorMap w_map,   // (D,H,3H)
                const float* __restrict__ b_hh,              // (D, 3H)
                const float* __restrict__ h0,                // (D, B, H)
                float* __restrict__ y,                       // (D, B, T, H)
                int B, int T, int H) {
  constexpr int U = kRowsU;
  constexpr int SW = kRowsSW;
  constexpr int XG = kRowsBox;        // bytes of a gate's xw box
  constexpr int CHUNK = kRowsBox;     // bytes of a state chunk
  constexpr int J = U / 8;            // 8-column blocks of a gate
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int C = H / U;
  uint8_t* ws = smem;                          // (3, H, 32) bf16, swizzled
  uint8_t* xs = ws + 6 * H * U;                // (2, 3, 64, 32) bf16
  uint8_t* hs = xs + 2 * 3 * XG;               // (C, 64, 32) bf16
  float* sb = reinterpret_cast<float*>(hs + C * CHUNK);  // (3, 32)
  // the slice, the two xw stages, the state
  uint64_t* bars = reinterpret_cast<uint64_t*>(sb + 3 * U);
  uint64_t* xs_full = bars + 1;
  uint64_t* h_full = bars + 3;

  const int rank = static_cast<int>(cl_rank());
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / C) * kRowsM;
  const int u0 = rank * U;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = 3 * H;
  const int nkb = H > 256 ? 2 : 1;  // boxes of a stripe of the slice
  const uint32_t push_bytes = (C - 1) * CHUNK;  // a step's bytes from peers
  uint8_t* own = hs + rank * CHUNK;             // this block's chunk

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 6 * H * U);
    for (int g = 0; g < 3; ++g)
      for (int kb = 0; kb < nkb; ++kb)
        tma_load_3d(ws + (g * H + kb * (H / nkb)) * SW, &w_map, &bars[0],
                    g * H + u0, kb * (H / nkb), d);
    for (int s = 0; s < 2 && s < T; ++s) {
      mbar_expect_tx(&xs_full[s], 3 * XG);
      for (int g = 0; g < 3; ++g)
        tma_load_4d(xs + s * 3 * XG + g * XG, &xw_map, &xs_full[s],
                    g * H + u0, s, b0, d);
    }
    // the state's first fill by the peers (the bytes may land first)
    if (C > 1) mbar_expect_tx(h_full, push_bytes);
  }
  for (int i = tid; i < 3 * U; i += kRowsThreads)
    sb[i] = b_hh[static_cast<size_t>(d) * G + (i / U) * H + u0 + i % U];
  // the state: bf16(h0) of the tile's rows, all units; rows past the
  // batch zero (their xw reads as TMA's zeros: they stay finite)
  for (int e = tid; e < kRowsM * H / 2; e += kRowsThreads) {
    const int r = e / (H / 2);
    const int k = 2 * (e - r * (H / 2));
    const float2 v =
        b0 + r < B ? *reinterpret_cast<const float2*>(
                         h0 + (static_cast<size_t>(d) * B + b0 + r) * H + k)
                   : make_float2(0.f, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(hs + (k / U) * CHUNK +
                                       swz<SW>(r * SW + 2 * (k % U))) =
        __floats2bfloat162_rn(v.x, v.y);
  }
  // thread (warp, lane) owns rows r0 and r0 + 8 of units 8j + cq, + 1
  // (wgmma's accumulator layout): index 4j + 2 half + e of a gate's 16
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float h_own[U / 2];
#pragma unroll
  for (int i = 0; i < U / 2; ++i) {
    const int r = r0 + 8 * ((i / 2) % 2);
    const int u = 8 * (i / 4) + cq + i % 2;
    h_own[i] = b0 + r < B
                   ? h0[(static_cast<size_t>(d) * B + b0 + r) * H + u0 + u]
                   : 0.f;
  }
  // h0's generic writes before wgmma reads them; every block of the
  // cluster runs and has set up its shared memory and barriers before any
  // copy from another block lands in it
  fence_proxy_async();
  cl_arrive();
  cl_wait();
  mbar_wait(&bars[0], 0);
#ifdef GRU_ROWS_TIMING
  long long last_stamp = clock64();
#endif

  const uint32_t ws_u32 = smem_u32(ws);
  const uint32_t hs_u32 = smem_u32(hs);
  for (int t = 0; t < T; ++t) {
    // h[t - 1]: the peers' chunks have landed (step 0: h0); armed again
    // at once for the next step's, which no peer sends before this block
    // has arrived at this step's cluster barrier
    if (C > 1 && t > 0) {
      mbar_wait(h_full, (t - 1) & 1);
      if (tid == 0) mbar_expect_tx(h_full, push_bytes);
    }
    ROWS_STAMP(0);
    float acc[3 * U / 2];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float2 bias =
            *reinterpret_cast<const float2*>(sb + g * U + 8 * j + cq);
        acc[g * U / 2 + 4 * j] = acc[g * U / 2 + 4 * j + 2] = bias.x;
        acc[g * U / 2 + 4 * j + 1] = acc[g * U / 2 + 4 * j + 3] = bias.y;
      }
    rows_product(acc, hs_u32, ws_u32, H);
    ROWS_STAMP(1);
    // this block is done reading its copy of the state
    rows_arrive_relaxed();
    mbar_wait(&xs_full[t & 1], (t >> 1) & 1);
    ROWS_STAMP(2);
    const uint8_t* x_t = xs + (t & 1) * 3 * XG;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int u = 8 * j + cq;
        const int i = 4 * j + 2 * half;
        const uint32_t off = swz<SW>(r * SW + 2 * u);
        const float2 xr = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_t + off));
        const float2 xz = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_t + XG + off));
        const float2 xn = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x_t + 2 * XG + off));
        const float xv[3][2] = {{xr.x, xr.y}, {xz.x, xz.y}, {xn.x, xn.y}};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float rr, zz;
          rows_sigmoid2(xv[0][e] + acc[i + e], xv[1][e] + acc[U / 2 + i + e],
                        &rr, &zz);
          const float nn = rows_tanh(xv[2][e] + rr * acc[U + i + e]);
          h_own[i + e] = (1.f - zz) * nn + zz * h_own[i + e];
        }
      }
    }
    ROWS_STAMP(3);
    // every block is done reading its copy before any part of one is
    // written; the block's units of h[t] into its chunk
    cl_wait();
#pragma unroll
    for (int i = 0; i < U / 2; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(
          own + swz<SW>((r0 + 8 * ((i / 2) % 2)) * SW +
                        2 * (8 * (i / 4) + cq))) =
          __floats2bfloat162_rn(h_own[i], h_own[i + 1]);
    // the chunk's generic writes before the bulk copies and the next
    // step's wgmma read it
    fence_proxy_async();
    __syncthreads();
    ROWS_STAMP(4);
    // the chunk into every other block's copy (not after the last step),
    // the copies spread over the four warps' first lanes; xw[t + 2] into
    // the stage step t has read
    if (lane == 0 && t + 1 < T)
      for (int k = 1 + warp; k < C; k += 4)
        rows_push(smem_u32(own), CHUNK, h_full, (rank + k) % C);
    if (tid == 96 && t + 2 < T) {
      mbar_expect_tx(&xs_full[t & 1], 3 * XG);
      for (int g = 0; g < 3; ++g)
        tma_load_4d(xs + (t & 1) * 3 * XG + g * XG, &xw_map,
                    &xs_full[t & 1], g * H + u0, t + 2, b0, d);
    }
    ROWS_STAMP(5);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (b0 + r < B) {
        float* y_row =
            y + ((static_cast<size_t>(d) * B + b0 + r) * T + t) * H + u0;
#pragma unroll
        for (int j = 0; j < J; ++j)
          *reinterpret_cast<float2*>(y_row + 8 * j + cq) = make_float2(
              h_own[4 * j + 2 * half], h_own[4 * j + 2 * half + 1]);
      }
    }
    ROWS_STAMP(6);
  }
  // no block leaves while a copy out of its shared memory may still run
  cl_arrive();
  cl_wait();
}

// Clusters of the design the card holds at once at hidden size H (asked
// of the CUDA runtime once per H).
cudaError_t rows_coresident(int H, int* coresident) {
  static int cached[512 / 32 + 1] = {};
  int& slot = cached[H / 32];
  if (slot == 0) {
    const cudaError_t err = gru_cluster_coresident(
        gru_rows_kernel, H / kRowsU, rows_smem(H), &slot, kRowsThreads);
    if (err != cudaSuccess) return err;
  }
  *coresident = slot;
  return cudaSuccess;
}

// The forward on this design: H a multiple of 32 up to 512.
cudaError_t gru_rows_fwd(const void* xw, const void* w_hh, const void* b_hh,
                         const void* h0, void* y, int D, int B, int T, int H,
                         cudaStream_t stream) {
  const int C = H / kRowsU;
  int coresident = 0;
  cudaError_t err = rows_coresident(H, &coresident);
  if (err != cudaSuccess) return err;
  // xw (D, B, T, 3H) in boxes of 32 columns x 64 rows of one step; w_hh
  // (D, H, 3H) in boxes of 32 columns x H / nkb rows; both swizzled by 64
  // bytes, the box row
  CUtensorMap xw_map, w_map;
  const cuuint64_t row = 6ull * H;
  const cuuint64_t x_dims[4] = {3ull * H, static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t x_strides[3] = {row, row * T, row * T * B};
  const cuuint32_t x_box[4] = {kRowsU, 1, kRowsM, 1};
  err = make_map(&xw_map, xw, 4, x_dims, x_strides, x_box, kRowsSW);
  if (err != cudaSuccess) return err;
  const int nkb = H > 256 ? 2 : 1;
  const cuuint64_t w_dims[3] = {3ull * H, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t w_strides[2] = {row, row * H};
  const cuuint32_t w_box[3] = {kRowsU, static_cast<cuuint32_t>(H / nkb), 1};
  err = make_map(&w_map, w_hh, 3, w_dims, w_strides, w_box, kRowsSW);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = gru_cluster_config(gru_rows_kernel, C, rows_smem(H),
                           dim3(C * ((B + kRowsM - 1) / kRowsM), D), stream,
                           &cfg, &attr, kRowsThreads);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gru_rows_kernel, xw_map, w_map,
                           static_cast<const float*>(b_hh),
                           static_cast<const float*>(h0),
                           static_cast<float*>(y), B, T, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What pbsed_gru_design reports of the design at hidden size H: blocks a
// cluster, rows a cluster, shared memory a block, co-resident clusters,
// units a block, bytes of a block's slice of w_hh resident (none
// streamed).
cudaError_t gru_rows_design(int H, int* cluster, int* rows, int* smem,
                            int* coresident, int* units, int* resident,
                            int* streamed) {
  *cluster = H / kRowsU;
  *rows = kRowsM;
  *smem = rows_smem(H);
  *units = kRowsU;
  *resident = 6 * H * kRowsU;
  *streamed = 0;
  return rows_coresident(H, coresident);
}

}  // namespace
