// The wgmma rows design of the GRU backward's reverse sweep (gru_bwd.cu
// states the recurrence and its rounding points), shared by the split
// backward (gru_bwd.cu, FUSED false) and the fused one (gru_bwd_fused.cu,
// FUSED true): every shape that the cluster design of gru_bwd_cluster.cuh
// (H = 256 at few rows, H = 512) does not take, H a multiple of 32 up to
// 256. Its main users: a bidirectional GRU layer at the DCASE baseline's
// 128 units trained at (2, 32, 500, 128), and training at H = 256 past 15
// row tiles of 16 ((2, 512, 500, 256)).
//
// Replaces: pb_sed_tpu/ops/pallas/gru.py:_gru_bwd_split_kernel (its
// pallas_call at :522) and :_gru_bwd_kernel (:569) at those shapes. The
// TPU kernels keep all of w_hh in VMEM and sweep a tile of rows; on
// Hopper w_hh fits no block at H = 256 and a step's chain is the cost.
//
// What bounds it on the H100: the recurrence is serial in t. At 32 rows a
// step's work is nothing (at (2, 32, 500, 128) the kernel moves 82 MB,
// 0.025 ms at 3.35 TB/s) and a step costs the latency of its chain: the
// partials of dh in, the gate math, the dh product, the partials out. At
// 512 rows the products (0.66 ms at 989 TFLOP/s at (2, 512, 500, 256))
// and the bytes (0.78 ms) are near; the card holds 15 of its 16
// clusters of 8 blocks at once (one 225 KiB block an SM).
//
// The layout, the backward counterpart of gru_rows.cuh. A cluster of
// C = H / 32 blocks (one warpgroup each) serves one (direction, tile of 64
// batch rows: wgmma's M); block c owns the hidden units
// U_c = [32c, 32c + 32) and so the gate columns cols(U_c), the r, z and n
// stripes. Its slice w_hh[:, cols(U_c)] (H x 96 bf16) is copied into
// shared memory once by TMA (boxes of 32 columns x H rows, 64-byte
// swizzle) and is the B operand of both products: MN-major for the gate
// recompute h_prev @ slice (K = H), K-major for the dh product
// dgates_own @ slice^T (K = 96: a stripe's row of 32 gate columns is 64
// contiguous bytes, the K of one swizzle atom).
//
// A step t (descending), one warpgroup a block:
// - wait until the peers' partials of dh from step t + 1 (64 rows x 32
//   units f32 each, in the accumulators' own order) have landed on the
//   block's mbarrier (bulk copies, only the warps' rows of the batch);
//   the owner adds the C partials IN RANK ORDER (its own from registers)
//   to dh_t+1 * z: two runs agree in every bit. Then the block arrives
//   (relaxed) at the cluster barrier: its receive slots are free;
// - the gate math left on the chain: everything of a step that does not
//   depend on dh (the gates, and the factors f with dz = dh_t f_z,
//   dpn = dh_t f_n, dpr = dh_t f_r, dgates_n = dh_t f_g) was computed a
//   step ahead, so dh_t = g[t] + dh and five products remain; the bf16
//   dgates [dpr, dz, dpn * r] go into registers in wgmma's A-fragment
//   layout (the accumulator layout of those columns is that layout),
//   dxw[t] into xw[t]'s stage in place;
// - the cluster barrier's wait (every block has added its partials: the
//   receive and send slots are free), then the dh product, two owners'
//   units at a time (n64), with the dgates as wgmma's register operand
//   and the K of 96 split over two accumulator chains. The block's own
//   share stays in registers, each other owner's goes to a send slot;
//   after one block barrier one thread sends the slots by bulk copies
//   (cp.async.bulk shared::cta -> shared::cluster) into the owners'
//   receive slots, counted on their mbarriers, and then (the same copy
//   engine takes them in turn) stores dxw[t] and (split) r[t] by TMA;
// - while the partials are in flight: the gate recompute of step t - 1,
//   bf16(h_prev[t - 1]) @ slice + b_hh (the state's stage, TMA-loaded a
//   step ahead: H / 32 chunks of 64 rows x 32 units, K-major and
//   swizzled, wgmma's canonical A; two accumulator chains), and that
//   step's gates and factors from xw[t - 1] (its TMA stage, loaded two
//   steps ahead) and h_prev[t - 1] of the block's units; r[t - 1] into
//   its box; then one block barrier and the next TMA loads.
// One cluster barrier a step (arrive after the sum, wait before the
// product) orders the exchange: a block's partials of step t land only
// after every block has added those of step t + 1, so one receive buffer
// suffices. Rows past the batch read as TMA's zeros and have g = 0: their
// dgates are 0, so they add nothing to dh (or to dw_hh and db_hh); TMA's
// stores leave them out. The kernel is built for each C = 1 .. 8, so that
// every loop over the cluster's blocks is unrolled.
//
// FUSED: dw_hh and db_hh off the chain, as gru_bwd_cluster.cuh does it:
// the gate math also adds the f32 dgates of each warp's rows (a fixed
// butterfly) to the warp's db sums in shared memory and stores the bf16
// dgates into a ring of 16 steps in global memory (64 rows x 16 x 96 bf16
// a block, zeroed at the start), and after the steps t = 16 g
// the block adds h_prev[rows, 16 g .. 16 g + 15]^T @ ring into its slice
// of dw_hh, dw_part[(d, tile)][:, cols(U_c)] (cl_dw_group, 4 warps), while
// the partials are in flight. At the end the warps' db sums are added in
// warp order. dxw and dh0 come from the same code as the split variant's,
// bit for bit.
//
// Shared memory: the slice (192 H bytes), the state's stage (128 H), two
// xw stages (24 KiB), two r boxes (8 KiB), C - 1 receive and C - 1 send
// slots of 8 KiB, b_hh of the block's columns: 225 KiB at H = 256, 121
// KiB at H = 128. Above H = 256 it does not fit (the wrapper runs
// 257-511 as 512, on the cluster design).
//
// Rounding points as the plain version (ops/kernels/gru.py:
// gru_scan_bwd_plain): bf16 h_prev into the recompute and into dz, bf16
// dgates into the dh product, f32 accumulation, dh and dh0 in f32, dxw and
// r written in bf16.
#pragma once

#include "gru_bwd_cluster.cuh"
#include "gru_rows.cuh"

namespace {

constexpr int kRbSlot = kRowsM * kRowsU * 4;  // bytes of a partial of dh
constexpr int kRbMaxH = 256;
// owners' units a round of the dh product: two chains of 32 accumulators
// (four owners' would spill beside the chain's registers)
constexpr int kRbOwners = 2;

// Shared memory a block at hidden size H (see above), with 1 KiB to align
// the base for the swizzle.
__host__ __device__ constexpr int rows_bwd_smem(int H) {
  return 1024 + 6 * H * kRowsU + 2 * kRowsM * H + 6 * kRowsBox +
         2 * kRowsBox + 2 * (H / kRowsU - 1) * kRbSlot + 12 * kRowsU + 5 * 8;
}

// `bytes` of this block's shared memory at src into block `rank`'s at the
// offset of dst, by the bulk-copy engine, counted on that block's mbarrier
// at the offset of `bar`
__device__ __forceinline__ void rows_bwd_push(uint32_t dst, uint32_t src,
                                              uint32_t bytes, uint32_t bar,
                                              uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(cl_map(dst, rank)),
      "r"(src), "r"(bytes), "r"(cl_map(bar, rank))
      : "memory");
}

// arrive (relaxed) on the cluster barrier once v is computed: the loads of
// the receive slots that v sums are complete, so no peer's copy of the
// next exchange can land under them, and no release has to wait for this
// thread's earlier global stores
__device__ __forceinline__ void rows_bwd_arrive(const float (&v)[16]) {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::"f"(v[0]),
               "f"(v[1]), "f"(v[2]), "f"(v[3]), "f"(v[4]), "f"(v[5]),
               "f"(v[6]), "f"(v[7]), "f"(v[8]), "f"(v[9]), "f"(v[10]),
               "f"(v[11]), "f"(v[12]), "f"(v[13]), "f"(v[14]), "f"(v[15])
               : "memory");
}

// a TMA store of the box at `src` to the tensor of `map` at (c0 .. c3),
// in this thread's bulk group
__device__ __forceinline__ void rows_bwd_tma_store(const CUtensorMap* map,
                                                   const void* src, int c0,
                                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void rows_bwd_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's TMA stores have read their shared memory
__device__ __forceinline__ void rows_bwd_store_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have written global memory
__device__ __forceinline__ void rows_bwd_store_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d[64 x 32 NQ] (+)= a[64 x 16] (bf16 registers) * B[16 x 32 NQ] (bf16
// shared memory, K-major: no transpose), f32 accumulators; `accumulate` 0
// writes the product alone. NQ = 1 or 2 owners' 32 units; the operand
// lists spelled out.
template <int NQ>
__device__ __forceinline__ void rows_bwd_wgmma(float (&d)[16 * NQ],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b,
                                               int accumulate);

template <>
__device__ __forceinline__ void rows_bwd_wgmma<1>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void rows_bwd_wgmma<2>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// v as an opaque value: what is derived from it (wgmma descriptors, the
// slots' addresses) is built where it is used, not held in registers
// across the sweep
__device__ __forceinline__ uint32_t rows_bwd_opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ float* rows_bwd_opaque(float* p) {
  asm volatile("" : "+l"(p));
  return p;
}

__device__ __forceinline__ uint32_t rows_bwd_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The dh product for NQ owners' units from o0: part (64 rows x 32 NQ
// units) = dgates (64 x 96, registers: K chunk kc = stripe kc / 2, its
// columns 16 (kc % 2) ..) @ the slice's rows of those units, K-major,
// its K split over two accumulator chains (pa the even chunks, pb the
// odd) that the caller adds, so that a chain waits on three wgmmas only.
// Issued and committed, not waited for. Owner o0 + q's share is
// [16 q .. 16 q + 15], in the accumulator layout of its own 32 units.
template <int NQ, int H>
__device__ __forceinline__ void rows_bwd_dh(float (&pa)[16 * NQ],
                                            float (&pb)[16 * NQ],
                                            const uint32_t (&dg_a)[6][4],
                                            uint32_t ws, int o0) {
  constexpr uint32_t layout = swizzle_layout<kRowsSW>();
#pragma unroll
  for (int e = 0; e < 16 * NQ; ++e) pa[e] = pb[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 6; ++kc) {
    const uint64_t desc =
        gmma_desc(ws + (kc / 2) * H * kRowsSW + o0 * kRowsU * kRowsSW +
                      32 * (kc % 2),
                  16, 8 * kRowsSW, layout);
    if (kc % 2)
      rows_bwd_wgmma<NQ>(pb, dg_a[kc], desc, kc >= 2);
    else
      rows_bwd_wgmma<NQ>(pa, dg_a[kc], desc, kc >= 2);
  }
  wgmma_commit();
}

// acc (64 x 96, the r, z and n columns of the block's units; holding
// b_hh on entry) += h @ slice over K = H = 32 C, as gru_rows.cuh's
// rows_product, but the K chunks split over two accumulator chains (acc2
// the odd k16 steps) added at the end; one commit group
template <int C>
__device__ __forceinline__ void rows_bwd_gates(float (&acc)[48],
                                               uint32_t hc, uint32_t ws) {
  constexpr uint32_t layout = swizzle_layout<kRowsSW>();
  constexpr uint32_t stripe = 32 * C * kRowsSW;
  float acc2[48];
#pragma unroll
  for (int e = 0; e < 48; ++e) acc2[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // each chunk's descriptors built just before its wgmmas, not all 4 C
    // of them ahead in registers (at C = 7 and 8 that would spill)
    const uint32_t a = rows_bwd_opaque(hc + c * kRowsBox);
    const uint32_t b = rows_bwd_opaque(ws + 2 * c * 16 * kRowsSW);
    rows_wgmma(acc, gmma_desc(a, 16, 8 * kRowsSW, layout),
               gmma_desc(b, stripe, 8 * kRowsSW, layout));
    rows_wgmma(acc2, gmma_desc(a + 32, 16, 8 * kRowsSW, layout),
               gmma_desc(b + 16 * kRowsSW, stripe, 8 * kRowsSW, layout));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(acc2);
#pragma unroll
  for (int e = 0; e < 48; ++e) acc[e] += acc2[e];
}

// Built with GRU_ROWS_BWD_TIMING (scripts/perf/gru_bwd_designs.py
// --phases), thread 0 of block (0, 0) adds the SM cycles of each phase of
// its steps to g_rows_bwd_phase: the wait for the peers' partials, their
// sum and the cluster barrier's arrive, the gate math on the chain, the
// cluster barrier's wait and the dh product (with dxw's stores under it),
// the block barrier with the bulk copies and the TMA stores of dxw and r,
// the gate recompute (with the wait for h_prev), the wait for xw and the
// gates' factors of the next step, the closing barrier. Without it the
// stamps compile to nothing.
constexpr int kRowsBwdPhases = 10;
#ifdef GRU_ROWS_BWD_TIMING
__device__ long long g_rows_bwd_phase[kRowsBwdPhases];
#define ROWS_BWD_STAMP(k)                               \
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) { \
    const long long now = clock64();                    \
    g_rows_bwd_phase[k] += now - last_stamp;            \
    last_stamp = now;                                   \
  }
#else
#define ROWS_BWD_STAMP(k)
#endif

// grid = (C * row tiles, D) in clusters of C = H / 32 along x; 128
// threads. dxw_map and r_map: TMA stores of dxw (as xw_map) and, split, r
// (as hp_map). FUSED: no r; dw_part ((D * row tiles, H, 3H) f32), db_part
// ((D * row tiles, 3H) f32) and dg_ring ((D * row tiles, C, 64, 16, 96)
// bf16) as described above.
template <bool FUSED, int C>
__global__ void __launch_bounds__(kRowsThreads, 1)
gru_bwd_rows_kernel(const __grid_constant__ CUtensorMap xw_map,  // (D,B,T,3H)
                    const __grid_constant__ CUtensorMap hp_map,  // (D,B,T,H)
                    const __grid_constant__ CUtensorMap w_map,   // (D,H,3H)
                    const __grid_constant__ CUtensorMap dxw_map,  // out
                    const __grid_constant__ CUtensorMap r_map,    // out
                    const __nv_bfloat16* __restrict__ h_prev,    // (D,B,T,H)
                    const float* __restrict__ b_hh,              // (D, 3H)
                    const float* __restrict__ g,                 // (D,B,T,H)
                    float* __restrict__ dh0,                     // (D, B, H)
                    float* dw_part, float* db_part,              // FUSED only
                    __nv_bfloat16* dg_ring,                      // FUSED only
                    int B, int T) {
  constexpr int U = kRowsU;
  constexpr int H = C * U;
  constexpr int G = 3 * H;
  constexpr int SW = kRowsSW;
  constexpr int XG = kRowsBox;  // bytes of a gate's xw box, of a chunk
  constexpr int J = U / 8;      // 8-column blocks of a gate
  constexpr int N = U / 2;      // a thread's (row, unit) pairs
  constexpr int SLOT = kRbSlot / 4;  // floats of a receive or send slot
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ws = smem;                    // (3, H, 32) bf16, swizzled
  uint8_t* hs = ws + 6 * H * U;          // (C, 64, 32) bf16: h_prev[t]
  uint8_t* xs = hs + C * XG;             // (2, 3, 64, 32) bf16: xw, dxw
  uint8_t* rs = xs + 2 * 3 * XG;         // (2, 64, 32) bf16: r; FUSED: db
  // C - 1 receive and C - 1 send slots of (warp, float4 q, lane): a
  // warp's q-th float4 of its 32 lanes side by side (no bank conflict),
  // the warps holding rows of the batch first
  float* recv = reinterpret_cast<float*>(rs + 2 * XG);
  float* send = recv + (C - 1) * SLOT;
  float* sb = send + (C - 1) * SLOT;  // (3, 32)
  // the slice, the two xw stages, the state's stage, the partials in
  uint64_t* bars = reinterpret_cast<uint64_t*>(sb + 3 * U);
  uint64_t* xs_full = bars + 1;
  uint64_t* h_full = bars + 3;
  uint64_t* recv_full = bars + 4;

  const int rank = static_cast<int>(cl_rank());
  const int d = blockIdx.y;
  const int tile = blockIdx.x / C;
  const int b0 = tile * kRowsM;
  const int rows = min(kRowsM, B - b0);
  const int u0 = rank * U;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the warps that hold rows of the batch (16 rows each): the partials of
  // the others are zero, neither sent nor read
  const int live = min(4, (rows + 15) / 16);
  const uint32_t push_bytes = live * (kRbSlot / 4);  // a slot's sent bytes
  const uint32_t recv_bytes = (C - 1) * push_bytes;  // an exchange's in
  // thread (warp, lane) owns rows r0 and r0 + 8 of units 8j + cq, + 1
  // (wgmma's accumulator layout): index 4j + 2 half + e of N
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  // FUSED: this (direction, row tile)'s partial and this block's ring
  const size_t part = static_cast<size_t>(d) * (gridDim.x / C) + tile;
  float* dw_blk = FUSED ? dw_part + part * H * G : nullptr;
  __nv_bfloat16* ring =
      FUSED ? dg_ring + (part * C + rank) * kRowsM * kDwSteps * kClCols
            : nullptr;
  float* db_sum = reinterpret_cast<float*>(rs);  // FUSED: (4 warps, 96)

  if (tid == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 6 * H * U);
    for (int gt = 0; gt < 3; ++gt)
      tma_load_3d(ws + gt * H * SW, &w_map, &bars[0], gt * H + u0, 0, d);
    mbar_expect_tx(h_full, C * XG);
    for (int c = 0; c < C; ++c)
      tma_load_4d(hs + c * XG, &hp_map, h_full, c * U, T - 1, b0, d);
    for (int s = 0; s < 2 && s < T; ++s) {
      mbar_expect_tx(&xs_full[s], 3 * XG);
      for (int gt = 0; gt < 3; ++gt)
        tma_load_4d(xs + s * 3 * XG + gt * XG, &xw_map, &xs_full[s],
                    gt * H + u0, T - 1 - s, b0, d);
    }
    // the first exchange (the bytes may land first)
    if (C > 1) mbar_expect_tx(recv_full, recv_bytes);
  }
  for (int i = tid; i < 3 * U; i += kRowsThreads)
    sb[i] = b_hh[static_cast<size_t>(d) * G + (i / U) * H + u0 + i % U];
  if constexpr (FUSED) {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kRowsM * kDwSteps * kClCols; e += kRowsThreads)
      ring[e] = zero;
    for (int e = tid; e < 4 * kClCols; e += kRowsThreads) db_sum[e] = 0.f;
  }
  // every block of the cluster runs and has set up its barriers before
  // any copy from another block lands in its shared memory; b_hh is in
  // sb
  cl_arrive();
  cl_wait();
#ifdef GRU_ROWS_BWD_TIMING
  long long last_stamp = clock64();
#endif

  const uint32_t ws_u32 = smem_u32(ws);
  const uint32_t hs_u32 = smem_u32(hs);
  // the gates' factors of the step, off the chain: dz = dh_t fz,
  // dpn = dh_t fn, dpr = dh_t fr, dgates_n = dpn r = dh_t fg, and z
  float fz[N], fn[N], fr[N], fg[N], fzz[N];
  // the factors of step t (index i) from h_prev[t] in the state's stage
  // and xw[t] in its stage: the gate recompute h_prev[t] @ slice + b_hh,
  // the gate math of everything that does not depend on dh, and (split)
  // r[t] into its box
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
    ROWS_BWD_STAMP(6);
    mbar_wait(&xs_full[i & 1], (i >> 1) & 1);
    ROWS_BWD_STAMP(7);
    const uint8_t* x_t = xs + (i & 1) * 3 * XG;
    const uint8_t* own = hs + rank * XG;
    uint8_t* r_box = rs + (i & 1) * XG;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int p = 4 * j + 2 * half;
        const uint32_t off = swz<SW>(r * SW + 2 * (8 * j + cq));
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
        if constexpr (!FUSED)
          *reinterpret_cast<__nv_bfloat162*>(r_box + off) =
              __floats2bfloat162_rn(rv[0], rv[1]);
      }
    }
  };
  mbar_wait(&bars[0], 0);
  mbar_wait(h_full, 0);
  factors(0);
  // every thread is done with the state's stage before its next load
  __syncthreads();
  if (tid == 0 && T >= 2) {
    mbar_expect_tx(h_full, C * XG);
    for (int c = 0; c < C; ++c)
      tma_load_4d(hs + c * XG, &hp_map, h_full, c * U, T - 2, b0, d);
  }

  // the thread's rows as row indices of (D * B * T) at t = 0; a row past
  // the batch reads no g (0)
  bool valid[2];
  size_t row_at0[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    valid[half] = r0 + 8 * half < rows;
    row_at0[half] = (static_cast<size_t>(d) * B + b0 +
                     min(r0 + 8 * half, rows - 1)) * T;
  }
  float dhz[N], own_part[N];  // dh_t * z of the last step; its own partial
#pragma unroll
  for (int e = 0; e < N; ++e) dhz[e] = own_part[e] = 0.f;
  // float4 q of this thread in a slot
  auto at = [&](float* slot_base, int q) {
    return reinterpret_cast<float4*>(slot_base) + (4 * warp + q) * 32 + lane;
  };
  // slot of block c at this block (rank order, own left out)
  auto slot = [&](int c) { return c < rank ? c : c - 1; };
  // dh = dh_t+1 * z + the C partials of the last exchange in rank order
  // (0 in a warp past the batch)
  auto gather = [&](float (&dh)[N]) {
    if (warp >= live) {
#pragma unroll
      for (int e = 0; e < N; ++e) dh[e] = 0.f;
      return;
    }
    float* in = rows_bwd_opaque(recv);
    float sum[N];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      // one slot's loads at a time: all of them at once would hold C x 16
      // registers
      asm volatile("" ::: "memory");
      float p[N];
      if (c == rank) {
#pragma unroll
        for (int e = 0; e < N; ++e) p[e] = own_part[e];
      } else {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 v = *at(in + slot(c) * SLOT, q);
          p[4 * q] = v.x;
          p[4 * q + 1] = v.y;
          p[4 * q + 2] = v.z;
          p[4 * q + 3] = v.w;
        }
      }
#pragma unroll
      for (int e = 0; e < N; ++e) sum[e] = c == 0 ? p[e] : sum[e] + p[e];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dh[e] = dhz[e] + sum[e];
  };

  for (int i = 0; i < T; ++i) {
    const int t = T - 1 - i;
    // g[t] of the thread's pairs, in flight while the partials come
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
        // the partials of step t + 1; armed again at once for step t's,
        // which no peer sends before this block has arrived below
        mbar_wait(recv_full, (i - 1) & 1);
        if (tid == 0) mbar_expect_tx(recv_full, recv_bytes);
      }
      ROWS_BWD_STAMP(0);
      gather(dh);
    }
    // this block's receive slots are free
    rows_bwd_arrive(dh);
    ROWS_BWD_STAMP(1);
    // the gate math on the chain: the bf16 dgates as wgmma's A (K chunk
    // 2 gate + j / 2, register 2 (j % 2) + half), dxw[t] into xw[t]'s
    // stage, in place
    uint8_t* x_t = xs + (i & 1) * 3 * XG;
    uint32_t dg_a[6][4];
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
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
          dg_a[2 * gt + j / 2][2 * (j % 2) + half] =
              rows_bwd_pack(dgv[gt][0], dgv[gt][1]);
        // dxw = [dpr, dz, dpn]: the first two are the dgates'
        const uint32_t off = swz<SW>((r0 + 8 * half) * SW + 2 * (8 * j + cq));
#pragma unroll
        for (int gt = 0; gt < 2; ++gt)
          *reinterpret_cast<uint32_t*>(x_t + gt * XG + off) =
              dg_a[2 * gt + j / 2][2 * (j % 2) + half];
        *reinterpret_cast<uint32_t*>(x_t + 2 * XG + off) =
            rows_bwd_pack(dpn[0], dpn[1]);
        if constexpr (FUSED) {
          // the ring and db: the f32 dgates of the warp's 16 rows by a
          // fixed butterfly, added into the warp's row of db_sum
          const int u = 8 * j + cq;
          __nv_bfloat16* ring_t =
              ring + (static_cast<size_t>(r0 + 8 * half) * kDwSteps +
                      (t & (kDwSteps - 1))) * kClCols + u;
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            *reinterpret_cast<uint32_t*>(ring_t + gt * U) =
                dg_a[2 * gt + j / 2][2 * (j % 2) + half];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = dgv[gt][e];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (lane < 4) db_sum[warp * kClCols + gt * U + u + e] += v;
            }
          }
        }
      }
    }
    ROWS_BWD_STAMP(2);
    // every block has added the last exchange: receive and send slots
    // free
    cl_wait();
    // the dh product, two owners' units a round; this block's own share
    // stays in registers, each other owner's goes to its send slot
    float* slots_out = rows_bwd_opaque(send);
    auto keep = [&](const auto& pa, const auto& pb, int at_e, int o) {
      if (o == rank) {
#pragma unroll
        for (int e = 0; e < N; ++e) own_part[e] = pa[at_e + e] + pb[at_e + e];
        return;
      }
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int e = at_e + 4 * q;
        *at(slots_out + slot(o) * SLOT, q) =
            make_float4(pa[e] + pb[e], pa[e + 1] + pb[e + 1],
                        pa[e + 2] + pb[e + 2], pa[e + 3] + pb[e + 3]);
      }
    };
    // (the rounds not unrolled: at C = 7 and 8 that would spill)
#pragma unroll 1
    for (int o = 0; o < C; o += kRbOwners) {
      auto owners = [&](auto nq_tag) {
        constexpr int NQ = decltype(nq_tag)::value;
        float pa[16 * NQ], pb[16 * NQ];
        rows_bwd_dh<NQ, H>(pa, pb, dg_a, rows_bwd_opaque(ws_u32), o);
        wgmma_wait<0>();
        fence_regs(pa);
        fence_regs(pb);
#pragma unroll
        for (int q = 0; q < NQ; ++q) keep(pa, pb, 16 * q, o + q);
      };
      if (C - o >= 2)
        owners(std::integral_constant<int, 2>());
      else
        owners(std::integral_constant<int, 1>());
    }
    ROWS_BWD_STAMP(3);
    // the send slots and dxw[t] (and r[t]) complete in shared memory: the
    // generic writes before the bulk copies and TMA stores read them
    fence_proxy_async();
    __syncthreads();
    if (tid == 96) {
      // the partials first: the bulk copies and the TMA stores queue on
      // the same copy engine
#pragma unroll 1
      for (int k = 1; k < C; ++k) {
        const int dst = (rank + k) % C;
        // into slot `rank` of owner dst (its slots skip its own rank)
        const int in = rank < dst ? rank : rank - 1;
        rows_bwd_push(smem_u32(recv + in * SLOT),
                      smem_u32(send + slot(dst) * SLOT), push_bytes,
                      smem_u32(recv_full), dst);
      }
      for (int gt = 0; gt < 3; ++gt)
        rows_bwd_tma_store(&dxw_map, x_t + gt * XG, gt * H + u0, t, b0, d);
      if constexpr (!FUSED)
        rows_bwd_tma_store(&r_map, rs + (i & 1) * XG, u0, t, b0, d);
      rows_bwd_store_commit();
    }
    ROWS_BWD_STAMP(4);
    if constexpr (FUSED) {
      // the ring's 16 steps from t (written before the block barrier
      // above) into the slice, while the partials are in flight
      if ((t & (kDwSteps - 1)) == 0)
        cl_dw_group(dw_blk,
                    h_prev + (static_cast<size_t>(d) * B + b0) * T * H,
                    ring, t, rows, T, H, u0, t + kDwSteps >= T, warp,
                    kRowsThreads / 32);
    }
    if (t >= 1) {
      // the next step's factors, while the partials are in flight
      mbar_wait(h_full, (i + 1) & 1);
      ROWS_BWD_STAMP(5);
      factors(i + 1);
    }
    ROWS_BWD_STAMP(8);
    // xw[t - 2] into the stage once the TMA stores have read it (and r's
    // box of this step free for the step after the next)
    if (tid == 96) {
      rows_bwd_store_read();
      if (t >= 2) {
        mbar_expect_tx(&xs_full[i & 1], 3 * XG);
        for (int gt = 0; gt < 3; ++gt)
          tma_load_4d(x_t + gt * XG, &xw_map, &xs_full[i & 1], gt * H + u0,
                      t - 2, b0, d);
      }
    }
    // every thread is done with the state's stage (and, FUSED, the ring)
    __syncthreads();
    ROWS_BWD_STAMP(9);
    if (tid == 64 && t >= 2) {
      mbar_expect_tx(h_full, C * XG);
      for (int c = 0; c < C; ++c)
        tma_load_4d(hs + c * XG, &hp_map, h_full, c * U, t - 2, b0, d);
    }
  }
  // the partials of step 0
  float dh[N];
  if (C > 1) mbar_wait(recv_full, (T - 1) & 1);
  gather(dh);
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
  if constexpr (FUSED) {
    // db of the block's 96 gate columns: the 4 warps' sums in warp order
    __syncthreads();
    if (tid < kClCols) {
      float sum = db_sum[tid];
      for (int w = 1; w < kRowsThreads / 32; ++w)
        sum += db_sum[w * kClCols + tid];
      db_part[part * G + (tid / U) * H + u0 + tid % U] = sum;
    }
  }
  if (tid == 96) rows_bwd_store_done();
  // no block leaves while a copy into or out of its shared memory may
  // still run
  cl_arrive();
  cl_wait();
}

// Clusters of the design the card holds at once (asked of the CUDA
// runtime once per width and variant).
template <bool FUSED, int C>
cudaError_t rows_bwd_coresident(int* coresident) {
  static int cached = 0;
  if (cached == 0) {
    const cudaError_t err =
        gru_cluster_coresident(gru_bwd_rows_kernel<FUSED, C>, C,
                               rows_bwd_smem(C * kRowsU), &cached,
                               kRowsThreads);
    if (err != cudaSuccess) return err;
  }
  *coresident = cached;
  return cudaSuccess;
}

template <bool FUSED>
cudaError_t rows_bwd_coresident(int H, int* coresident) {
  switch (H / kRowsU) {
    case 1: return rows_bwd_coresident<FUSED, 1>(coresident);
    case 2: return rows_bwd_coresident<FUSED, 2>(coresident);
    case 3: return rows_bwd_coresident<FUSED, 3>(coresident);
    case 4: return rows_bwd_coresident<FUSED, 4>(coresident);
    case 5: return rows_bwd_coresident<FUSED, 5>(coresident);
    case 6: return rows_bwd_coresident<FUSED, 6>(coresident);
    case 7: return rows_bwd_coresident<FUSED, 7>(coresident);
    case 8: return rows_bwd_coresident<FUSED, 8>(coresident);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED, int C>
cudaError_t launch_bwd_rows(const CUtensorMap* maps, const void* h_prev,
                            const void* b_hh, const void* g, void* dh0,
                            void* dw_part, void* db_part, void* dg_ring,
                            int D, int B, int T, cudaStream_t stream) {
  int coresident = 0;
  cudaError_t err = rows_bwd_coresident<FUSED, C>(&coresident);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = gru_cluster_config(gru_bwd_rows_kernel<FUSED, C>, C,
                           rows_bwd_smem(C * kRowsU),
                           dim3(C * ((B + kRowsM - 1) / kRowsM), D), stream,
                           &cfg, &attr, kRowsThreads);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, gru_bwd_rows_kernel<FUSED, C>, maps[0], maps[1], maps[2],
      maps[3], maps[4], static_cast<const __nv_bfloat16*>(h_prev),
      static_cast<const float*>(b_hh), static_cast<const float*>(g),
      static_cast<float*>(dh0), static_cast<float*>(dw_part),
      static_cast<float*>(db_part), static_cast<__nv_bfloat16*>(dg_ring), B,
      T);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The sweep on this design: H a multiple of 32 up to 256, T >= 1.
template <bool FUSED>
cudaError_t gru_bwd_rows(const void* xw, const void* h_prev,
                         const void* w_hh, const void* b_hh, const void* g,
                         void* dxw, void* r, void* dh0, void* dw_part,
                         void* db_part, void* dg_ring, int D, int B, int T,
                         int H, cudaStream_t stream) {
  if (H > kRbMaxH || H % kRowsU) return cudaErrorInvalidValue;
  // xw and dxw (D, B, T, 3H), h_prev and r (D, B, T, H) in boxes of 32
  // columns x 64 rows of one step; w_hh (D, H, 3H) in boxes of 32 columns
  // x H rows; all swizzled by 64 bytes, the box row
  CUtensorMap maps[5];  // xw, h_prev, w_hh, dxw, r
  const cuuint64_t row = 6ull * H;
  const cuuint64_t x_dims[4] = {3ull * H, static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t x_strides[3] = {row, row * T, row * T * B};
  const cuuint32_t box[4] = {kRowsU, 1, kRowsM, 1};
  cudaError_t err = make_map(&maps[0], xw, 4, x_dims, x_strides, box,
                             kRowsSW);
  if (err == cudaSuccess)
    err = make_map(&maps[3], dxw, 4, x_dims, x_strides, box, kRowsSW);
  if (err != cudaSuccess) return err;
  const cuuint64_t h_row = 2ull * H;
  const cuuint64_t h_dims[4] = {static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(T),
                                static_cast<cuuint64_t>(B),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t h_strides[3] = {h_row, h_row * T, h_row * T * B};
  err = make_map(&maps[1], h_prev, 4, h_dims, h_strides, box, kRowsSW);
  if (err != cudaSuccess) return err;
  maps[4] = maps[1];  // FUSED: never used
  if (!FUSED) {
    err = make_map(&maps[4], r, 4, h_dims, h_strides, box, kRowsSW);
    if (err != cudaSuccess) return err;
  }
  const cuuint64_t w_dims[3] = {3ull * H, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(D)};
  const cuuint64_t w_strides[2] = {row, row * H};
  const cuuint32_t w_box[3] = {kRowsU, static_cast<cuuint32_t>(H), 1};
  err = make_map(&maps[2], w_hh, 3, w_dims, w_strides, w_box, kRowsSW);
  if (err != cudaSuccess) return err;
  switch (H / kRowsU) {
#define PBSED_ROWS_BWD_CASE(c)                                          \
  case c:                                                              \
    return launch_bwd_rows<FUSED, c>(maps, h_prev, b_hh, g, dh0,       \
                                     dw_part, db_part, dg_ring, D, B, T, \
                                     stream);
    PBSED_ROWS_BWD_CASE(1)
    PBSED_ROWS_BWD_CASE(2)
    PBSED_ROWS_BWD_CASE(3)
    PBSED_ROWS_BWD_CASE(4)
    PBSED_ROWS_BWD_CASE(5)
    PBSED_ROWS_BWD_CASE(6)
    PBSED_ROWS_BWD_CASE(7)
    PBSED_ROWS_BWD_CASE(8)
#undef PBSED_ROWS_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// The design the backward (split or FUSED) runs at (D, B, T, H), as
// pbsed_gru_design (gru.cu) reports it: 1 and the cluster design's numbers
// where gru_cluster_takes says so, else 2 and this design's (clusters of
// H / 32 blocks of 32 units, 64 rows, the slice resident, none streamed);
// -cudaError_t on a failed query or an H this design does not take.
template <bool FUSED>
int bwd_design(int D, int B, int T, int H, int* cluster, int* rows,
               int* smem, int* coresident, int* units, int* resident,
               int* streamed) {
  if (gru_cluster_takes(D, B, T, H))
    return bwd_cluster_report<FUSED>(D, B, H, cluster, rows, smem,
                                     coresident, units, resident, streamed);
  if (H > kRbMaxH) return -static_cast<int>(cudaErrorInvalidValue);
  *cluster = H / kRowsU;
  *rows = kRowsM;
  *smem = rows_bwd_smem(H);
  *units = kRowsU;
  *resident = 6 * H * kRowsU;
  *streamed = 0;
  const cudaError_t err = rows_bwd_coresident<FUSED>(H, coresident);
  return err == cudaSuccess ? 2 : -static_cast<int>(err);
}

// The sweep under the design the rule picks (gru_cluster_takes: the
// cluster design, else this one); *rows: the rows of a (direction, row
// tile) partial (FUSED's workspace).
template <bool FUSED>
cudaError_t gru_bwd_sweep(const void* xw, const void* h_prev,
                          const void* w_hh, const void* b_hh, const void* g,
                          void* dxw, void* r, void* dh0, void* dw_part,
                          void* db_part, void* dg_ring, int D, int B, int T,
                          int H, cudaStream_t s, int* rows) {
  if (gru_cluster_takes(D, B, T, H))
    return bwd_cluster<FUSED>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0,
                              dw_part, db_part, dg_ring, D, B, T, H, s, rows);
  *rows = kRowsM;
  return gru_bwd_rows<FUSED>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, dw_part,
                             db_part, dg_ring, D, B, T, H, s);
}

}  // namespace
