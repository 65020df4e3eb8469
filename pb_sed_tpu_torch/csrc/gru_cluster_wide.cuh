// The cluster design of the GRU recurrence above H = 512, forward (gru.cu)
// and split backward (gru_bwd.cu): the JAX package runs no Pallas kernel
// there but a lax.scan (pb_sed_tpu/ops/rnn.py:122-138, 188-205), with the
// same math and the port's rounding points (xw, h and w_hh into the
// product in bf16; gates, state and dh in f32).
//
// The layout is gru_cluster.cuh's with the units a block as a parameter. A
// cluster of 16 blocks serves one (direction, tile of 16 or 32 batch
// rows); block c owns the U = H / 16 hidden units U_c = [cU, cU + U) (48
// at 768, 64 at 1024, 128 at 2048) and so the 3U gate columns cols(U_c).
// The products work on 16-column tiles (an ldmatrix.x4 and two mma.sync
// m16n8k16), which want U % 16 == 0, so that a gate stripe is whole tiles
// and each 16-unit tile of dh has one owner: the design takes H a multiple
// of 256 (768, 1024, ..., 2048), and the wrapper pads any other H above
// 512 with zero units to the next one (ops/kernels/gru.py:kernel_hidden;
// 600 runs as 768, 1.64x its work, where 8-column tiles would take 640).
//
// What does not fit: the block's slice w_hh[:, cols(U_c)] is H x 3U bf16,
// 216 KiB at 768, 384 KiB at 1024, 1.5 MiB at 2048, and shares the 227 KiB
// of shared memory with the state (forward) or the receive slots of dh
// (backward). The slice is kept row-major (k, 3U + 8 padding values): the
// row-major B operand of `state @ slice` (K = H) and the col-major B
// operand of `dgates_own @ slice^T` (K = 3U). The wrapper hands the kernels
// w_hh packed in that layout, (D, 16, H, 3U + 8) (ops/kernels/gru.py:
// pack_wide), so that a block's slice is one contiguous range of global
// memory, and a stage of it one bulk copy. Its first KR k-tiles (16
// rows each) are copied into shared memory once and stay there; the
// other KT - KR stream from L2 every product through a ring of NS stages
// of KCH k-tiles, NS - 1 stages ahead of the products that use them. One
// thread fills a stage with one bulk copy (cp.async.bulk, the TMA engine)
// that completes on the stage's mbarrier. The ring runs on across
// products (its chunks repeat every product), so the first stages of a
// product load during the previous step's gate math, exchange and
// barrier; a product multiplies a stage's k-tiles and a share of the
// resident ones while the next stage lands. Per product each block
// fetches (KT - KR) / KT of its slice, a sixteenth of what does not fit
// of w_hh.
//
// Shared memory a block (R = 16 rows; wide_layout computes it):
//   forward:  state 2 x R x (H + 8) bf16 (48.5 KiB at 768, 128.5 at 2048),
//             gates R x (3U + 4) f32, staging R x U bf16; the rest: a
//             ring of 4 k-tiles (2 stages of 2; 4 of 1 where less than 8
//             k-tiles fit) and resident k-tiles. 768: 30 of 48 k-tiles
//             resident (135 KiB), 18 streamed (81 KiB a step); 1024: 18
//             of 64 (108 KiB), 46 (276 KiB); 2048: 1 of 128 (1524 KiB a
//             step). R = 32: 768 18 resident (135 KiB streamed), 1024 6
//             (348 KiB). A deeper ring only costs residency: 11.60,
//             12.63, 13.95 us a step at (2, 32, 200, 768) with 4, 8, 12
//             k-tiles (scripts/perf/gru_wide_probe.py; NVIDIA H100 80GB
//             HBM3, 700.00 W).
//   backward: receive slots 16 x R x (U + 4) f32 (52 KiB at 768, 132 KiB
//             at 2048), gates R x (3U + 4) f32, dgates R x (3U + 8) bf16;
//             each ring stage also carries the gate product's A piece
//             (h_prev rows of its k-tiles, cp.async arriving on the
//             stage's mbarrier), and the resident k-tiles' A rows live in
//             a buffer of two products. 768: 24 resident (108 KiB), 24
//             streamed (108 KiB); 1024: 14 (84 KiB), 50 (300 KiB); 2048:
//             0, 128 (a ring of 4 stages of 1).
//
// Forward, a step (gru.cu's cluster kernel): warp w < NT (gate-column tiles
// 3U / 16) multiplies the tile's full bf16 state (a copy in every block)
// by column tiles w and w + 16 of the slice over all of K, two accumulators
// a tile; after one block barrier, warp = row, lane = unit (lane + 32 j
// for j < ceil(U / 32)) does the gate math with the f32 state in
// registers, writes y and stores the new bf16 state of the block's units
// into every block's next copy through st.shared::cluster. The state is
// double-buffered: one cluster barrier a step. xw[t + 1] is loaded a step
// ahead. Rows a cluster: 16 while every cluster of the launch is on the
// card at once, else 32 where the layout fits (H <= 1024), halving the
// clusters that wait their turn (sliding-window SED: (2, 16 000, 51, H)).
//
// Backward (16 rows), a step t (gru_bwd_cluster.cuh's chain, dh's receive
// slots single-buffered under a second, split cluster barrier):
// - gate math for the block's own units (gs: the gate product, recomputed
//   a step ahead): dxw and r to global memory, bf16 dgates_own to shared
//   memory, dh = dh_t * z in registers; block barrier; wait for the
//   barrier B2 of step t + 1 (every owner has read its slots);
// - one pass over the ring: for each stage the dh partial tiles of its
//   units, dgates_own @ slice^T (K = 3U), stored straight into slot c of
//   their owner's receive buffer (distributed shared memory), and the k-
//   tiles of the NEXT step's gate product h_prev[t - 1] @ slice; then the
//   resident units' partial tiles; arrive at B1;
// - the next gate product's resident k-tiles, off the chain, into gs;
// - wait for B1; the owner adds its 16 slots IN RANK ORDER to dh (two runs
//   agree in every bit); arrive at B2.
// So w_hh streams once a step for both products, the chain has one block
// barrier and two split cluster barriers, and no global workspace.
#pragma once

#include <algorithm>

#include "gru_cluster.cuh"

namespace {

constexpr int kWideMinH = 512;     // the design takes H above this
constexpr int kWideMaxH = 2048;    // and up to this,
constexpr int kWideStep = 256;     // a multiple of this (16 x 16 units)
constexpr int kWideBlocks = 16;    // blocks a cluster
constexpr int kWidePad = 8;        // bf16 padding of a slice or state row
constexpr int kWideRingTiles = 4;  // k-tiles of the ring at most
constexpr int kWideSmem = 232448;  // 227 KB a block may use
constexpr int kWideMaxStages = 16;  // mbarriers a block reserves

// Where what lives in a block's shared memory, and how the slice is cut.
struct WideLayout {
  int U;    // hidden units a block owns (H / 16)
  int NT;   // 16-column tiles of its 3U gate columns
  int KT;   // 16-row k-tiles of H
  int KR;   // resident k-tiles: the slice's first 16 KR rows
  int KCH;  // k-tiles a ring stage
  int NS;   // ring stages
  int NCH;  // stages a product streams: (KT - KR) / KCH
  int lds;  // bf16 row stride of the slice, the ring and the dgates: 3U + 8
  int ldh;  // bf16 row stride of the state (forward): H + 8
  int ldg;  // f32 row stride of the gate buffer: 3U + 4
  int ldr;  // f32 row stride of a receive slot (backward): U + 4
  int lda;  // bf16 row stride of the resident A buffer (backward): 16 KR + 8
  int ldp;  // bf16 row stride of a stage's A piece (backward): 16 KCH + 8
  int stage;  // bytes of a ring stage
  // byte offsets: ring, state or receive slots, gates, staging or
  // dgates, resident A (two products)
  int off_ring, off_a, off_gs, off_x, off_res;
  int off_bar;  // the ring's mbarriers, one a stage
  int smem;  // bytes a block
};

inline bool gru_wide_takes(int H) {
  return H > kWideMinH && H <= kWideMaxH && H % kWideStep == 0;
}

__host__ __device__ inline int wide_align(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// The layout at hidden size H with R rows a cluster, forward or backward,
// with a ring of at most ring_tiles k-tiles; smem > kWideSmem where it does
// not fit.
inline WideLayout wide_layout(int H, int R, bool backward,
                              int ring_tiles = kWideRingTiles) {
  WideLayout L = {};
  L.U = H / kWideBlocks;
  L.NT = 3 * L.U / 16;
  L.KT = H / 16;
  L.lds = 3 * L.U + kWidePad;
  L.ldh = H + kWidePad;
  L.ldg = 3 * L.U + 4;
  L.ldr = L.U + 4;
  const int ktile = 2 * 16 * L.lds;  // bytes of a k-tile of the slice
  int fixed;
  if (backward) {
    L.off_a = 0;  // receive slots
    L.off_gs = L.off_a + wide_align(4 * kWideBlocks * R * L.ldr);
    L.off_x = L.off_gs + wide_align(4 * R * L.ldg);  // dgates
    L.off_bar = L.off_x + wide_align(2 * R * L.lds);
  } else {
    L.off_a = 0;  // state, twice
    L.off_gs = L.off_a + wide_align(2 * 2 * R * L.ldh);
    L.off_x = L.off_gs + wide_align(4 * R * L.ldg);  // staging
    L.off_bar = L.off_x + wide_align(2 * R * L.U);
  }
  fixed = L.off_bar + wide_align(8 * kWideMaxStages);
  const int avail = kWideSmem - fixed;
  L.KCH = avail / ktile >= 8 ? 2 : 1;
  L.ldp = 16 * L.KCH + kWidePad;
  L.stage = ktile * L.KCH + (backward ? wide_align(2 * R * L.ldp) : 0);
  L.NS = std::min(ring_tiles / L.KCH, avail / L.stage);
  // the resident k-tiles in what is left, the backward's with their A
  // rows in a buffer of two products
  const int left = avail - L.NS * L.stage;
  const int res_fixed = backward ? 2 * 2 * R * kWidePad + 256 : 0;
  const int per_tile = ktile + (backward ? 2 * 2 * R * 16 : 0);
  int kr = std::max(0, std::min(L.KT, (left - res_fixed) / per_tile));
  kr -= (L.KT - kr) % L.KCH;  // whole stages streamed
  L.KR = kr;
  L.NCH = (L.KT - L.KR) / L.KCH;
  if (L.NCH == 0) L.NS = 0;
  L.lda = 16 * L.KR + kWidePad;
  // shared memory: [fixed][ring][resident slice][resident A x 2]
  L.off_ring = fixed;
  L.off_res = L.off_ring + L.NS * L.stage + wide_align(ktile * L.KR);
  L.smem = L.off_res + (backward ? 2 * wide_align(2 * R * L.lda) : 0);
  // a fetch runs at most one product ahead: the resident A buffer of the
  // product after next is written after this product read it
  if (L.NCH > 0 && (L.NS < 2 || L.NS > kWideMaxStages || L.NS - 1 > L.NCH))
    L.smem = kWideSmem + 1;
  return L;
}

// ---- shared memory, ring, products ---------------------------------------

template <typename T>
__device__ __forceinline__ T* wide_at(unsigned char* smem, int offset) {
  return reinterpret_cast<T*>(smem + offset);
}

__device__ __forceinline__ __nv_bfloat16* wide_slice(unsigned char* smem,
                                                     const WideLayout& L) {
  return wide_at<__nv_bfloat16>(smem, L.off_ring + L.NS * L.stage);
}

// `bytes` (a multiple of 16) from src to dst, 16 bytes a cp.async of
// every thread of the block
__device__ __forceinline__ void wide_copy(void* dst, const void* src,
                                          int bytes) {
  for (int e = threadIdx.x; e < bytes / 16; e += kClThreads)
    __pipeline_memcpy_async(static_cast<uint4*>(dst) + e,
                            static_cast<const uint4*>(src) + e, 16);
}

// ---- the ring: bulk copies (TMA) completing on an mbarrier a stage -------

__device__ __forceinline__ void wide_bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   cl_smem_u32(bar))
               : "memory");
}

// the stage's fetch: one arrival that expects `bytes` of bulk copies
__device__ __forceinline__ void wide_bar_expect(uint64_t* bar,
                                                uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          cl_smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed; a copy that never
// lands traps, so it surfaces as a launch error instead of a hung card
__device__ __forceinline__ void wide_bar_wait(uint64_t* bar,
                                              uint32_t parity) {
  const uint32_t addr = cl_smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global memory
// into this block's shared memory by the bulk-copy engine, counted on bar
__device__ __forceinline__ void wide_bulk(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(cl_smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(cl_smem_u32(bar))
      : "memory");
}

// The ring's position, the same in every thread: the stage of the next
// chunk consumed and the parity of its mbarrier's phase; the stage, the
// chunk (of a product) and the product of the next fetch.
struct WideRing {
  int cur, phase, fill, chunk, product;
};

// What a fetch brings besides the slice's rows (backward only): the A
// piece of the gate product that consumes the chunk, h_prev[t] with
// t = T - 1 - product (the backward's products are those of steps T - 1,
// T - 2, ...), and, with a product's first chunk, the A rows of its
// resident k-tiles.
struct WideA {
  const __nv_bfloat16* h_tile;  // h_prev at (d, b0, t = 0); null: forward
  int rows, T;
};

// h_prev[t]'s columns [c0, c0 + 16 n) of the tile's R rows into dst (rows
// ld apart) by the lanes of one warp: 16 bytes a cp.async for the rows of
// the batch, zeros past them
__device__ __forceinline__ void wide_fetch_a(__nv_bfloat16* dst, int ld,
                                             const WideA& A, int t, int c0,
                                             int n, int R, int H, int lane) {
  for (int e = lane; e < R * 2 * n; e += 32) {
    const int r = e / (2 * n);
    const int q = e - r * 2 * n;
    __nv_bfloat16* to = dst + r * ld + 8 * q;
    if (r < A.rows)
      __pipeline_memcpy_async(
          to, A.h_tile + (static_cast<size_t>(r) * A.T + t) * H + c0 + 8 * q,
          16);
    else
      *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
  }
}

// The next fetch, issued by warp 0 into stage `fill`: chunk `chunk` of the
// streamed rows of the packed slice wp (16 KCH contiguous rows) by one bulk
// copy; backward, the A rows by cp.async, which arrive on the same
// mbarrier.
__device__ __forceinline__ void wide_fetch(unsigned char* smem, WideRing& ring,
                                           const __nv_bfloat16* wp,
                                           const WideLayout& L, int H, int R,
                                           const WideA& A) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int kt0 = L.KR + ring.chunk * L.KCH;
    const int t = A.T - 1 - ring.product;
    uint64_t* bar = wide_at<uint64_t>(smem, L.off_bar) + ring.fill;
    __nv_bfloat16* stage =
        wide_at<__nv_bfloat16>(smem, L.off_ring + ring.fill * L.stage);
    const int bytes = 2 * 16 * L.KCH * L.lds;
    if (A.h_tile != nullptr && t >= 0) {
      wide_fetch_a(stage + 16 * L.KCH * L.lds, L.ldp, A, t, 16 * kt0, L.KCH,
                   R, H, lane);
      if (ring.chunk == 0 && L.KR > 0)
        wide_fetch_a(wide_at<__nv_bfloat16>(
                         smem, L.off_res + (ring.product & 1) *
                                               wide_align(2 * R * L.lda)),
                     L.lda, A, t, 0, L.KR, R, H, lane);
      // each lane's copies arrive on the stage's mbarrier when they land
      // (its pending count raised now, before the arrival below)
      asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                       cl_smem_u32(bar))
                   : "memory");
    }
    __syncwarp();
    if (lane == 0) {
      // the stage was read through the generic proxy before the block
      // barrier that precedes this fetch
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wide_bar_expect(bar, bytes);
      wide_bulk(stage, wp + 16 * kt0 * L.lds, bytes, bar);
    }
  }
  ring.fill = ring.fill + 1 == L.NS ? 0 : ring.fill + 1;
  if (++ring.chunk == L.NCH) {
    ring.chunk = 0;
    ++ring.product;
  }
}

// before the first product (after a block barrier that follows
// wide_ring_init): stages 0 .. NS - 2 in flight
__device__ __forceinline__ void wide_ring_start(unsigned char* smem,
                                                WideRing& ring,
                                                const __nv_bfloat16* wp,
                                                const WideLayout& L, int H,
                                                int R, const WideA& A) {
  ring = {0, 0, 0, 0, 0};
  for (int s = 0; s + 1 < L.NS; ++s) wide_fetch(smem, ring, wp, L, H, R, A);
}

// the ring's mbarriers, by thread 0, visible to the bulk-copy engine
__device__ __forceinline__ void wide_ring_init(unsigned char* smem,
                                               const WideLayout& L) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.NS; ++s)
      wide_bar_init(wide_at<uint64_t>(smem, L.off_bar) + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The next chunk: landed (each thread waits on its stage's mbarrier) and
// the stage consumed before it refilled (NS - 1 ahead) after a block
// barrier. Returns its stage.
__device__ __forceinline__ __nv_bfloat16* wide_next(unsigned char* smem,
                                                    WideRing& ring,
                                                    const __nv_bfloat16* wp,
                                                    const WideLayout& L,
                                                    int H, int R,
                                                    const WideA& A) {
  wide_bar_wait(wide_at<uint64_t>(smem, L.off_bar) + ring.cur, ring.phase);
  __syncthreads();
  wide_fetch(smem, ring, wp, L, H, R, A);
  __nv_bfloat16* stage =
      wide_at<__nv_bfloat16>(smem, L.off_ring + ring.cur * L.stage);
  if (++ring.cur == L.NS) {
    ring.cur = 0;
    ring.phase ^= 1;
  }
  return stage;
}

// at the end: the NS - 1 fetches in flight land before the block exits
__device__ __forceinline__ void wide_ring_drain(unsigned char* smem,
                                                WideRing& ring,
                                                const WideLayout& L) {
  for (int s = 0; s + 1 < L.NS; ++s) {
    wide_bar_wait(wide_at<uint64_t>(smem, L.off_bar) + ring.cur, ring.phase);
    if (++ring.cur == L.NS) {
      ring.cur = 0;
      ring.phase ^= 1;
    }
  }
}

// ---- products: ldmatrix and mma.sync m16n8k16 ----------------------------
//
// wmma's loads from these layouts compile to generic 32-bit loads (LD.E,
// no ldmatrix: cuobjdump -sass of a wmma build of this design, and of
// gru_cluster.cuh's kernels), which made the gate product a step's largest
// part: 8.4 of 15.0 us at H = 768 (scripts/perf/gru_wide_probe.py, its
// fwd_no_product line; NVIDIA H100 80GB HBM3, 700.00 W). So the products
// load fragments with ldmatrix from shared-memory addresses and multiply
// with mma.sync. A lane's accumulators of a 16 x 16 f32 tile: [n half][4],
// c0, c1 at row lane / 4 and c2, c3 at row lane / 4 + 8, columns 8 half +
// 2 (lane % 4) and the next.

// four 8 x 8 bf16 matrices, rows at the lanes' addresses (lane 8j .. 8j +
// 7 for matrix j), transposed with `trans`
__device__ __forceinline__ void wide_ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wide_ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16) @ b (16 x 8 bf16, fragments b0, b1)
__device__ __forceinline__ void wide_mma(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats into another block's shared memory (a cl_map address)
__device__ __forceinline__ void wide_store2(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
               "f"(x), "f"(y)
               : "memory");
}

// this lane's ldmatrix address of the row-major 16 x 16 tile at p (rows
// ld apart): rows lane % 16, columns 8 (lane / 16): the A fragment, or
// with ldmatrix.trans the B fragments of two 8-column halves of a
// row-major B
__device__ __forceinline__ uint32_t wide_lane_rows(const __nv_bfloat16* p,
                                                   int ld) {
  const int lane = threadIdx.x % 32;
  return cl_smem_u32(p + (lane % 16) * ld + (lane / 16) * 8);
}

// ... of the 16 x 16 tile at p of B^T (rows: B's 16 columns, ld apart):
// B's columns (lane % 8) + 8 (lane / 16), rows 8 ((lane / 8) % 2)
__device__ __forceinline__ uint32_t wide_lane_cols(const __nv_bfloat16* p,
                                                   int ld) {
  const int lane = threadIdx.x % 32;
  return cl_smem_u32(p + (lane % 8 + (lane / 16) * 8) * ld +
                     ((lane / 8) % 2) * 8);
}

// the gate product's accumulators of a warp: column tiles j (warp + 16 j),
// row tiles m, two accumulators (even and odd k-tiles) where the warp has
// one column tile
template <int MT, int TPW>
struct WideAcc {
  // two column tiles already give two chains of products: one accumulator
  static constexpr int kPar = TPW == 2 ? 1 : 2;
  float v[TPW][MT][kPar][2][4];
};

// One k-tile into accumulator P of this warp's column tiles (warp, warp
// + 16, below NT): a_addr the lane's A address (16 MT rows, row tiles
// a_tile bytes apart), b_addr its B address at column tile 0 (the slice's
// 16 rows of the k-tile, row-major).
template <int MT, int TPW, int P>
__device__ __forceinline__ void wide_gate_ktile(WideAcc<MT, TPW>& acc,
                                                uint32_t a_addr, int a_tile,
                                                uint32_t b_addr, int NT,
                                                int warp) {
  uint32_t a[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) wide_ldsm(a[m], a_addr + m * a_tile);
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int tile = warp + 16 * j;
    if (tile < NT) {
      uint32_t b[4];
      wide_ldsm_t(b, b_addr + tile * 32);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        constexpr int p = P % WideAcc<MT, TPW>::kPar;
        wide_mma(acc.v[j][m][p][0], a[m], b[0], b[1]);
        wide_mma(acc.v[j][m][p][1], a[m], b[2], b[3]);
      }
    }
  }
}

// k-tiles [0, n) of a (16 MT rows, ld lda; k-tile kt at a + 16 kt) and b
// (the slice's rows, ld ldb; k-tile kt at b + 16 kt ldb), alternating the
// accumulators from `parity`
template <int MT, int TPW>
__device__ __forceinline__ void wide_gate_tiles(
    WideAcc<MT, TPW>& acc, const __nv_bfloat16* a, int lda,
    const __nv_bfloat16* b, int ldb, int n, int parity, int NT, int warp) {
  if (n <= 0) return;
  uint32_t a_addr = wide_lane_rows(a, lda);
  uint32_t b_addr = wide_lane_rows(b, ldb);
  const int a_tile = 2 * 16 * lda;  // bytes between row tiles of a
  const int b_step = 2 * 16 * ldb;  // bytes between k-tiles of b
  int kt = 0;
  if (parity & 1) {
    wide_gate_ktile<MT, TPW, 1>(acc, a_addr, a_tile, b_addr, NT, warp);
    a_addr += 32;
    b_addr += b_step;
    kt = 1;
  }
  for (; kt + 1 < n; kt += 2) {
    wide_gate_ktile<MT, TPW, 0>(acc, a_addr, a_tile, b_addr, NT, warp);
    wide_gate_ktile<MT, TPW, 1>(acc, a_addr + 32, a_tile, b_addr + b_step, NT,
                                warp);
    a_addr += 64;
    b_addr += 2 * b_step;
  }
  if (kt < n)
    wide_gate_ktile<MT, TPW, 0>(acc, a_addr, a_tile, b_addr, NT, warp);
}

template <int MT, int TPW>
__device__ __forceinline__ void wide_gate_zero(WideAcc<MT, TPW>& acc) {
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int p = 0; p < WideAcc<MT, TPW>::kPar; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc.v[j][m][p][h][i] = 0.f;
}

// each column tile's accumulators, summed, into gs (16 MT rows, ldg)
template <int MT, int TPW>
__device__ __forceinline__ void wide_gate_store(WideAcc<MT, TPW>& acc,
                                                float* gs, int ldg, int NT,
                                                int warp) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int tile = warp + 16 * j;
    if (tile < NT) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            c[i] = acc.v[j][m][0][h][i];
            if constexpr (WideAcc<MT, TPW>::kPar == 2)
              c[i] += acc.v[j][m][1][h][i];
          }
          float* row = gs + (16 * m + lane / 4) * ldg + 16 * tile + 8 * h +
                       2 * (lane % 4);
          *reinterpret_cast<float2*>(row) = make_float2(c[0], c[1]);
          *reinterpret_cast<float2*>(row + 8 * ldg) = make_float2(c[2], c[3]);
        }
    }
  }
}

// ---- forward ---------------------------------------------------------------

// grid (16 * row tiles, D) in clusters of 16 along x; 512 threads.
// UPL: units a lane, ceil(U / 32).
template <int MT, int UPL>
__global__ void __launch_bounds__(kClThreads, 1)
gru_scan_wide_cluster_kernel(const __nv_bfloat16* __restrict__ xw,  // (D, B, T, 3H)
                             const __nv_bfloat16* __restrict__ w_hh,  // packed
                             const float* __restrict__ b_hh,  // (D, 3H)
                             const float* __restrict__ h0,    // (D, B, H)
                             float* __restrict__ y,           // (D, B, T, H)
                             int B, int T, int H, const WideLayout L) {
  constexpr int R = 16 * MT;
  constexpr int TPW = UPL >= 3 ? 2 : 1;  // NT > 16 from H = 1536
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  const int U = L.U;
  const __nv_bfloat16* slice = wide_slice(smem, L);
  __nv_bfloat16* hb = wide_at<__nv_bfloat16>(smem, L.off_a);  // (2, R, ldh)
  float* gs = wide_at<float>(smem, L.off_gs);                  // (R, ldg)
  __nv_bfloat16* stg = wide_at<__nv_bfloat16>(smem, L.off_x);  // (R, U)

  const int rank = static_cast<int>(cl_rank());
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / kWideBlocks) * R;
  const int rows = min(R, B - b0);
  const int u0 = rank * U;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's slice of the packed w_hh (d, rank): (H, lds)
  const __nv_bfloat16* wp =
      w_hh + (static_cast<size_t>(d) * kWideBlocks + rank) * H * L.lds;
  const float* bias = b_hh + static_cast<size_t>(d) * G + u0;
  const WideA no_a = {nullptr, 0, 0};

  wide_copy(wide_slice(smem, L), wp, 2 * 16 * L.KR * L.lds);
  __pipeline_commit();
  // copy 0 of the state: bf16(h0) of the whole tile; rows past the batch
  // (and all of copy 1) zero, and they stay zero
  for (int e = threadIdx.x; e < R * L.ldh; e += kClThreads) {
    const int r = e / L.ldh;
    const int k = e - r * L.ldh;
    const float v = (r < rows && k < H)
                        ? h0[(static_cast<size_t>(d) * B + b0 + r) * H + k]
                        : 0.f;
    hb[e] = __float2bfloat16(v);
    hb[R * L.ldh + e] = __float2bfloat16(0.f);
  }
  // thread (warp, lane) owns units lane + 32 j (below U) of rows warp +
  // 16 i; a unit past U reads unit 0 (its values are not used)
  float h_own[MT][UPL];
  const __nv_bfloat16* x_row[MT];
  __nv_bfloat16 nx[MT][UPL][3];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const size_t row =
        static_cast<size_t>(d) * B + b0 + min(warp + 16 * i, rows - 1);
    x_row[i] = xw + row * T * G + u0;
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int u = lane + 32 * j < U ? lane + 32 * j : 0;
      h_own[i][j] = h0[row * H + u0 + u];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) nx[i][j][gate] = x_row[i][gate * H + u];
    }
  }
  wide_ring_init(smem, L);
  __pipeline_wait_prior(0);  // this thread's part of the resident slice
  __syncthreads();
  WideRing ring;
  wide_ring_start(smem, ring, wp, L, H, R, no_a);
  // every block of the cluster runs and has set up its shared memory
  // before any store from another block lands in it
  cl_arrive();
  cl_wait();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    float x[MT][UPL][3];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < UPL; ++j)
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
          x[i][j][gate] = __bfloat162float(nx[i][j][gate]);
    if (t + 1 < T) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* x_t = x_row[i] + static_cast<size_t>(t + 1) * G;
#pragma unroll
        for (int j = 0; j < UPL; ++j) {
          const int u = lane + 32 * j < U ? lane + 32 * j : 0;
#pragma unroll
          for (int gate = 0; gate < 3; ++gate)
            nx[i][j][gate] = x_t[gate * H + u];
        }
      }
    }
    // the gate product: per stage of the ring its streamed k-tiles and a
    // share of the resident ones, which fill the time the next stage takes
    const __nv_bfloat16* a = hb + cur * R * L.ldh;
    WideAcc<MT, TPW> acc;
    wide_gate_zero<MT, TPW>(acc);
    for (int c = 0; c < L.NCH; ++c) {
      const __nv_bfloat16* st = wide_next(smem, ring, wp, L, H, R, no_a);
      if (warp < L.NT) {
        wide_gate_tiles<MT, TPW>(acc, a + 16 * (L.KR + c * L.KCH), L.ldh, st,
                                 L.lds, L.KCH, c * L.KCH, L.NT, warp);
        const int r0 = c * L.KR / L.NCH;
        wide_gate_tiles<MT, TPW>(acc, a + 16 * r0, L.ldh,
                                 slice + 16 * r0 * L.lds, L.lds,
                                 (c + 1) * L.KR / L.NCH - r0, r0, L.NT, warp);
      }
    }
    if (warp < L.NT) {
      if (L.NCH == 0)
        wide_gate_tiles<MT, TPW>(acc, a, L.ldh, slice, L.lds, L.KR, 0, L.NT,
                                 warp);
      wide_gate_store<MT, TPW>(acc, gs, L.ldg, L.NT, warp);
    }
    __syncthreads();

    __nv_bfloat16* h_next = hb + (cur ^ 1) * R * L.ldh;
    const int pieces = U / 8;  // 16-byte pieces of a row's U values
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = warp + 16 * i;
      if (r < rows) {  // the same for all lanes of a warp
        float* y_t =
            y + ((static_cast<size_t>(d) * B + b0 + r) * T + t) * H + u0;
#pragma unroll
        for (int j = 0; j < UPL; ++j) {
          const int u = lane + 32 * j;
          if (u < U) {
            const float* g = gs + r * L.ldg + u;
            const float rr = cl_sigmoid(x[i][j][0] + (g[0] + __ldg(bias + u)));
            const float zz =
                cl_sigmoid(x[i][j][1] + (g[U] + __ldg(bias + H + u)));
            const float nn = tanhf(x[i][j][2] +
                                   rr * (g[2 * U] + __ldg(bias + 2 * H + u)));
            const float h = (1.f - zz) * nn + zz * h_own[i][j];
            h_own[i][j] = h;
            y_t[u] = h;
            stg[r * U + u] = __float2bfloat16(h);
          }
        }
        __syncwarp();
        // the row's U new values into every block's next copy
        for (int p = lane; p < pieces * kWideBlocks; p += 32) {
          const int dest = p / pieces;
          const int q = p - dest * pieces;
          const uint4 v = *reinterpret_cast<const uint4*>(stg + r * U + 8 * q);
          cl_store16(cl_map(cl_smem_u32(h_next + r * L.ldh + u0 + 8 * q),
                            static_cast<uint32_t>(dest)),
                     v);
        }
      }
    }
    // one cluster barrier a step: the new state is complete in every
    // block, and every block is done with the old one and with gs
    cl_arrive();
    cl_wait();
  }
  wide_ring_drain(smem, ring, L);
}

// ---- split backward --------------------------------------------------------

// dh's partial tile of the 16 units of k-tile kt over this block's 3U gate
// columns, dgs (16 rows, lds) @ rows_kt^T (rows_kt: the slice's 16 rows of
// kt), stored into slot `rank` of the owner of those units
template <int P>
__device__ __forceinline__ void wide_dh_ktile(float (&acc)[2][2][4],
                                              uint32_t a_addr,
                                              uint32_t b_addr) {
  uint32_t a[4], b[4];
  wide_ldsm(a, a_addr);
  wide_ldsm(b, b_addr);
  wide_mma(acc[P][0], a, b[0], b[1]);
  wide_mma(acc[P][1], a, b[2], b[3]);
}

__device__ __forceinline__ void wide_dh_tile(const __nv_bfloat16* dgs,
                                             const __nv_bfloat16* rows_kt,
                                             const WideLayout& L, int kt,
                                             float* recv, int rank) {
  float acc[2][2][4] = {};
  const uint32_t a_addr = wide_lane_rows(dgs, L.lds);
  const uint32_t b_addr = wide_lane_cols(rows_kt, L.lds);
  int j = 0;
  for (; j + 1 < L.NT; j += 2) {
    wide_dh_ktile<0>(acc, a_addr + 32 * j, b_addr + 32 * j);
    wide_dh_ktile<1>(acc, a_addr + 32 * (j + 1), b_addr + 32 * (j + 1));
  }
  if (j < L.NT) wide_dh_ktile<0>(acc, a_addr + 32 * j, b_addr + 32 * j);
  const int lane = threadIdx.x % 32;
  const int owner = 16 * kt / L.U;
  const uint32_t slot = cl_map(
      cl_smem_u32(recv + (rank * 16 + lane / 4) * L.ldr +
                  (16 * kt - owner * L.U) + 2 * (lane % 4)),
      static_cast<uint32_t>(owner));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* c0 = acc[0][h];
    const float* c1 = acc[1][h];
    wide_store2(slot + 4 * 8 * h, c0[0] + c1[0], c0[1] + c1[1]);
    wide_store2(slot + 4 * (8 * h + 8 * L.ldr), c0[2] + c1[2],
                c0[3] + c1[3]);
  }
}

// grid (16 * row tiles of 16, D) in clusters of 16 along x; 512 threads.
template <int UPL>
__global__ void __launch_bounds__(kClThreads, 1)
gru_bwd_wide_cluster_kernel(const __nv_bfloat16* __restrict__ xw,  // (D, B, T, 3H)
                            const __nv_bfloat16* __restrict__ h_prev,  // (D, B, T, H)
                            const __nv_bfloat16* __restrict__ w_hh,  // packed
                            const float* __restrict__ b_hh,  // (D, 3H)
                            const float* __restrict__ g,     // (D, B, T, H)
                            __nv_bfloat16* __restrict__ dxw,    // (D, B, T, 3H)
                            __nv_bfloat16* __restrict__ r_out,  // (D, B, T, H)
                            float* __restrict__ dh0,            // (D, B, H)
                            int B, int T, int H, const WideLayout L) {
  constexpr int R = 16;
  constexpr int TPW = UPL >= 3 ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int G = 3 * H;
  const int U = L.U;
  const __nv_bfloat16* slice = wide_slice(smem, L);
  float* recv = wide_at<float>(smem, L.off_a);                 // (16, R, ldr)
  float* gs = wide_at<float>(smem, L.off_gs);                  // (R, ldg)
  __nv_bfloat16* dgs = wide_at<__nv_bfloat16>(smem, L.off_x);  // (R, lds)

  const int rank = static_cast<int>(cl_rank());
  const int d = blockIdx.y;
  const int b0 = (blockIdx.x / kWideBlocks) * R;
  const int rows = min(R, B - b0);
  const int u0 = rank * U;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's slice of the packed w_hh (d, rank): (H, lds)
  const __nv_bfloat16* wp =
      w_hh + (static_cast<size_t>(d) * kWideBlocks + rank) * H * L.lds;
  const float* bias = b_hh + static_cast<size_t>(d) * G + u0;
  // the gate product of ring product p is that of step T - 1 - p
  const WideA a_src = {h_prev + (static_cast<size_t>(d) * B + b0) * T * H,
                       rows, T};
  const int res_bytes = wide_align(2 * R * L.lda);

  wide_copy(wide_slice(smem, L), wp, 2 * 16 * L.KR * L.lds);
  __pipeline_commit();
  // rows past the batch stay zero in the dh product's A operand
  for (int e = threadIdx.x; e < R * L.lds; e += kClThreads)
    dgs[e] = __float2bfloat16(0.f);
  // thread (warp, lane) owns units lane + 32 j (below U) of row warp; a
  // unit past U reads unit 0 (its values are not used)
  const size_t row0 =
      (static_cast<size_t>(d) * B + b0 + min(warp, rows - 1)) * T;
  // xw, g and h_prev of the thread's units at step t; loaded a step ahead
  // up to two units a lane, where the registers allow it (H <= 1024)
  constexpr bool kAhead = UPL <= 2;
  __nv_bfloat16 nx[UPL][3], nh[UPL];
  float ng[UPL];
  auto load_step = [&](int t) {
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int u = lane + 32 * j < U ? lane + 32 * j : 0;
      const size_t row = row0 + t;
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        nx[j][gate] = xw[row * G + gate * H + u0 + u];
      ng[j] = g[row * H + u0 + u];
      nh[j] = h_prev[row * H + u0 + u];
    }
  };
  if (kAhead) load_step(T - 1);
  wide_ring_init(smem, L);
  __pipeline_wait_prior(0);  // this thread's part of the resident slice
  __syncthreads();
  WideRing ring;
  wide_ring_start(smem, ring, wp, L, H, R, a_src);

  // the gate product of step T - 1: the ring's product 0
  WideAcc<1, TPW> acc;
  wide_gate_zero<1, TPW>(acc);
  for (int c = 0; c < L.NCH; ++c) {
    const __nv_bfloat16* st = wide_next(smem, ring, wp, L, H, R, a_src);
    if (warp < L.NT)
      wide_gate_tiles<1, TPW>(acc, st + 16 * L.KCH * L.lds, L.ldp, st, L.lds,
                              L.KCH, c * L.KCH, L.NT, warp);
  }
  // the resident A rows came with the product's first chunk (visible
  // since its wide_next)
  if (warp < L.NT) {
    wide_gate_tiles<1, TPW>(acc, wide_at<__nv_bfloat16>(smem, L.off_res),
                            L.lda, slice, L.lds, L.KR, 0, L.NT, warp);
    wide_gate_store<1, TPW>(acc, gs, L.ldg, L.NT, warp);
  }
  // every block of the cluster runs before any store from another block
  // lands in its receive slots (also the block barrier after gs)
  cl_arrive();
  cl_wait();

  float dh[UPL];
#pragma unroll
  for (int j = 0; j < UPL; ++j) dh[j] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    if (!kAhead) load_step(t);
    float x[UPL][3], g_t[UPL], h_p[UPL];
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
#pragma unroll
      for (int gate = 0; gate < 3; ++gate)
        x[j][gate] = __bfloat162float(nx[j][gate]);
      g_t[j] = ng[j];
      h_p[j] = __bfloat162float(nh[j]);
    }
    if (kAhead && t > 0) load_step(t - 1);
    if (warp < rows) {  // the same for all lanes of a warp
      const size_t row = row0 + t;
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        const int u = lane + 32 * j;
        if (u < U) {
          const float* s = gs + warp * L.ldg + u;
          const float hn = s[2 * U] + __ldg(bias + 2 * H + u);
          const float rr = cl_sigmoid(x[j][0] + (s[0] + __ldg(bias + u)));
          const float zz = cl_sigmoid(x[j][1] + (s[U] + __ldg(bias + H + u)));
          const float nn = tanhf(x[j][2] + rr * hn);
          const float dht = g_t[j] + dh[j];
          const float dz = dht * (h_p[j] - nn) * zz * (1.f - zz);
          const float dpn = dht * (1.f - zz) * (1.f - nn * nn);
          const float dpr = dpn * hn * rr * (1.f - rr);
          __nv_bfloat16* dx_t = dxw + row * G + u0 + u;
          dx_t[0] = __float2bfloat16(dpr);
          dx_t[H] = __float2bfloat16(dz);
          dx_t[2 * H] = __float2bfloat16(dpn);
          r_out[row * H + u0 + u] = __float2bfloat16(rr);
          __nv_bfloat16* dg_own = dgs + warp * L.lds + u;
          dg_own[0] = __float2bfloat16(dpr);
          dg_own[U] = __float2bfloat16(dz);
          dg_own[2 * U] = __float2bfloat16(dpn * rr);
          dh[j] = dht * zz;
        }
      }
    }
    __syncthreads();  // dgates complete; gs read
    if (t < T - 1) cl_wait();  // B2 of step t + 1: the slots are free

    // one pass over the ring: dh's partial tiles of the stage's units and
    // the k-tiles of the next step's gate product
    const bool next = t > 0;
    wide_gate_zero<1, TPW>(acc);
    for (int c = 0; c < L.NCH; ++c) {
      const __nv_bfloat16* st = wide_next(smem, ring, wp, L, H, R, a_src);
      if (next && warp < L.NT)
        wide_gate_tiles<1, TPW>(acc, st + 16 * L.KCH * L.lds, L.ldp, st,
                                L.lds, L.KCH, c * L.KCH, L.NT, warp);
      const int kk = warp - (kWideBlocks - L.KCH);
      if (kk >= 0)
        wide_dh_tile(dgs, st + 16 * kk * L.lds, L, L.KR + c * L.KCH + kk,
                     recv, rank);
      // a share of the resident units' tiles, on the other warps
      for (int kt = c * L.KR / L.NCH; kt < (c + 1) * L.KR / L.NCH; ++kt)
        if (kt % (kWideBlocks - L.KCH) == warp)
          wide_dh_tile(dgs, slice + 16 * kt * L.lds, L, kt, recv, rank);
    }
    if (L.NCH == 0)
      for (int kt = warp; kt < L.KR; kt += kClWarps)
        wide_dh_tile(dgs, slice + 16 * kt * L.lds, L, kt, recv, rank);
    cl_arrive();  // B1: the partials are in their owners' slots
    if (next) {
      // the rest of the next gate product, off the chain; its resident A
      // rows came with this product's first chunk
      const int product = T - t;
      if (warp < L.NT) {
        wide_gate_tiles<1, TPW>(
            acc,
            wide_at<__nv_bfloat16>(smem, L.off_res + (product & 1) * res_bytes),
            L.lda, slice, L.lds, L.KR, 0, L.NT, warp);
        wide_gate_store<1, TPW>(acc, gs, L.ldg, L.NT, warp);
      }
      // gs complete before any warp's next gate math: the other warps pass
      // B1's wait while these still multiply
      __syncthreads();
    }
    cl_wait();  // B1
    // dh of the own units: the 16 partials in rank order
    if (warp < rows) {
#pragma unroll
      for (int j = 0; j < UPL; ++j) {
        const int u = lane + 32 * j;
        if (u < U) {
          const float* mine = recv + warp * L.ldr + u;
          float sum = mine[0];
          for (int c = 1; c < kWideBlocks; ++c) sum += mine[c * R * L.ldr];
          dh[j] += sum;
        }
      }
    }
    cl_arrive();  // B2: the slots are read
  }
  cl_wait();  // the last B2
  if (warp < rows) {
#pragma unroll
    for (int j = 0; j < UPL; ++j) {
      const int u = lane + 32 * j;
      if (u < U)
        dh0[(static_cast<size_t>(d) * B + b0 + warp) * H + u0 + u] = dh[j];
    }
  }
  wide_ring_drain(smem, ring, L);
}

// ---- launch ----------------------------------------------------------------

inline int wide_units_a_lane(int H) { return (H / kWideBlocks + 31) / 32; }

// clusters of the kernel the card holds at once at its shared memory,
// asked of the CUDA runtime once per H (slot: a cache entry per H)
template <typename Kernel>
cudaError_t wide_coresident(Kernel kernel, int smem, int H,
                            int (&cached)[kWideMaxH / kWideStep + 1],
                            int* coresident) {
  int& slot = cached[H / kWideStep];
  if (slot == 0) {
    const cudaError_t err =
        gru_cluster_coresident(kernel, kWideBlocks, smem, &slot);
    if (err != cudaSuccess) return err;
  }
  *coresident = slot;
  return cudaSuccess;
}

template <int MT, int UPL>
cudaError_t wide_fwd_design(int H, WideLayout* L, int* coresident) {
  static int cached[kWideMaxH / kWideStep + 1] = {};
  *L = wide_layout(H, 16 * MT, false);
  if (L->smem > kWideSmem) return cudaErrorInvalidValue;
  return wide_coresident(gru_scan_wide_cluster_kernel<MT, UPL>, L->smem, H,
                         cached, coresident);
}

// 32 rows only up to H = 1024 (two units a lane): the layout's state takes
// 2 x 32 x (H + 8) bf16, and more units a lane would spill
template <int MT>
cudaError_t wide_fwd_design_upl(int H, WideLayout* L, int* coresident) {
  if constexpr (MT == 2) {
    return wide_units_a_lane(H) == 2 ? wide_fwd_design<2, 2>(H, L, coresident)
                                     : cudaErrorInvalidValue;
  } else {
    switch (wide_units_a_lane(H)) {
      case 2: return wide_fwd_design<1, 2>(H, L, coresident);
      case 3: return wide_fwd_design<1, 3>(H, L, coresident);
      default: return wide_fwd_design<1, 4>(H, L, coresident);
    }
  }
}

// Rows a cluster of the forward: 16 while every cluster of the launch is
// on the card at once (gru_cluster_row_tiles), else 32 up to H = 1024.
template <typename = void>
cudaError_t wide_fwd_row_tiles(int D, int B, int H, int* mt) {
  WideLayout L;
  int coresident = 0;
  cudaError_t err = wide_fwd_design_upl<1>(H, &L, &coresident);
  if (err != cudaSuccess) return err;
  *mt = gru_cluster_row_tiles(D, B, coresident);
  if (*mt == 2 && (wide_units_a_lane(H) > 2 ||
                   wide_layout(H, 32, false).smem > kWideSmem))
    *mt = 1;
  return cudaSuccess;
}

template <int MT, int UPL>
cudaError_t wide_fwd_launch(const void* xw, const void* w_hh, const void* b_hh,
                            const void* h0, void* y, int D, int B, int T,
                            int H, cudaStream_t stream) {
  constexpr int R = 16 * MT;
  WideLayout L;
  int coresident = 0;
  cudaError_t err = wide_fwd_design<MT, UPL>(H, &L, &coresident);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = gru_cluster_config(gru_scan_wide_cluster_kernel<MT, UPL>, kWideBlocks,
                           L.smem, dim3(kWideBlocks * ((B + R - 1) / R), D),
                           stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, gru_scan_wide_cluster_kernel<MT, UPL>,
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(h0), static_cast<float*>(y), B, T, H, L);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// (gru_wide_fwd, gru_wide_bwd and gru_wide_design are templates so that a
// source instantiates only the kernels it launches)
template <typename = void>
cudaError_t gru_wide_fwd(const void* xw, const void* w_hh, const void* b_hh,
                         const void* h0, void* y, int D, int B, int T, int H,
                         cudaStream_t s) {
  int mt = 0;
  const cudaError_t err = wide_fwd_row_tiles(D, B, H, &mt);
  if (err != cudaSuccess) return err;
  switch (wide_units_a_lane(H) + 10 * mt) {
    case 12: return wide_fwd_launch<1, 2>(xw, w_hh, b_hh, h0, y, D, B, T, H, s);
    case 13: return wide_fwd_launch<1, 3>(xw, w_hh, b_hh, h0, y, D, B, T, H, s);
    case 14: return wide_fwd_launch<1, 4>(xw, w_hh, b_hh, h0, y, D, B, T, H, s);
    case 22: return wide_fwd_launch<2, 2>(xw, w_hh, b_hh, h0, y, D, B, T, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int UPL>
cudaError_t wide_bwd_design(int H, WideLayout* L, int* coresident) {
  static int cached[kWideMaxH / kWideStep + 1] = {};
  *L = wide_layout(H, 16, true);
  if (L->smem > kWideSmem) return cudaErrorInvalidValue;
  return wide_coresident(gru_bwd_wide_cluster_kernel<UPL>, L->smem, H, cached,
                         coresident);
}

template <typename = void>
cudaError_t wide_bwd_design_upl(int H, WideLayout* L, int* coresident) {
  switch (wide_units_a_lane(H)) {
    case 2: return wide_bwd_design<2>(H, L, coresident);
    case 3: return wide_bwd_design<3>(H, L, coresident);
    default: return wide_bwd_design<4>(H, L, coresident);
  }
}

template <int UPL>
cudaError_t wide_bwd_launch(const void* xw, const void* h_prev,
                            const void* w_hh, const void* b_hh, const void* g,
                            void* dxw, void* r, void* dh0, int D, int B, int T,
                            int H, cudaStream_t stream) {
  WideLayout L;
  int coresident = 0;
  cudaError_t err = wide_bwd_design<UPL>(H, &L, &coresident);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  err = gru_cluster_config(gru_bwd_wide_cluster_kernel<UPL>, kWideBlocks,
                           L.smem, dim3(kWideBlocks * ((B + 15) / 16), D),
                           stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, gru_bwd_wide_cluster_kernel<UPL>,
      static_cast<const __nv_bfloat16*>(xw),
      static_cast<const __nv_bfloat16*>(h_prev),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(b_hh),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dxw),
      static_cast<__nv_bfloat16*>(r), static_cast<float*>(dh0), B, T, H, L);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// T = 0: dh0 = 0 (no step)
template <typename = void>
cudaError_t gru_wide_bwd(const void* xw, const void* h_prev, const void* w_hh,
                         const void* b_hh, const void* g, void* dxw, void* r,
                         void* dh0, int D, int B, int T, int H,
                         cudaStream_t s) {
  if (T == 0)
    return cudaMemsetAsync(dh0, 0, sizeof(float) * static_cast<size_t>(D) * B * H,
                           s);
  switch (wide_units_a_lane(H)) {
    case 2:
      return wide_bwd_launch<2>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, D, B,
                                T, H, s);
    case 3:
      return wide_bwd_launch<3>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, D, B,
                                T, H, s);
    default:
      return wide_bwd_launch<4>(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, D, B,
                                T, H, s);
  }
}

// The design query's answer for this design (1: a cluster design), as
// pbsed_gru_design (gru.cu) reports it: blocks a cluster, rows, shared
// memory, co-resident clusters, units a block and the bytes of a block's
// slice of w_hh resident in shared memory and streamed a product.
template <bool BACKWARD>
int gru_wide_design(int D, int B, int H, int* cluster, int* rows, int* smem,
                    int* coresident, int* units, int* resident,
                    int* streamed) {
  WideLayout L;
  int mt = 1;
  cudaError_t err;
  if constexpr (BACKWARD) {
    err = wide_bwd_design_upl(H, &L, coresident);
  } else {
    err = wide_fwd_row_tiles(D, B, H, &mt);
    if (err == cudaSuccess)
      err = mt == 2 ? wide_fwd_design_upl<2>(H, &L, coresident)
                    : wide_fwd_design_upl<1>(H, &L, coresident);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  *cluster = kWideBlocks;
  *rows = 16 * mt;
  *smem = L.smem;
  *units = L.U;
  *resident = 2 * 16 * 3 * L.U * L.KR;
  *streamed = 2 * 16 * 3 * L.U * (L.KT - L.KR);
  return 1;
}

}  // namespace
