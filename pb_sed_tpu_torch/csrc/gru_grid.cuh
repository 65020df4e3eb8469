// The grid design of the GRU recurrence above H = 2048, forward (gru.cu)
// and split backward (gru_bwd.cu): the JAX package runs no Pallas kernel
// there but a lax.scan (pb_sed_tpu/ops/rnn.py:125-136 and its autodiff),
// with the same math and the port's rounding points (xw, h and w_hh into
// the product in bf16; gates, state and dh in f32; the backward's dxw, r
// and dgates in bf16).
//
// Why not a cluster: the design of 16 blocks (gru_cluster_wide.cuh) keeps
// a full bf16 copy of the state in every block (the forward: 2 x R x
// (H + 8), 257 KiB at 4096) and 16 receive slots of dh partials (the
// backward: 266 KiB at 4096), and a cluster has at most 16 blocks. Above
// 2048 neither fits, and w_hh (H x 3H bf16: 31.9 MB a direction at 2304,
// 100.7 MB at 4096) outgrows the card's shared memory (132 x 227 KB) and
// its L2 (50 MB) together from H ~ 3700 on two directions: most of it is
// read from L2 or device memory at every step, whatever the design.
//
// The design: one persistent block an SM (7 consumer warps and a producer
// warp), launched cooperatively (cudaLaunchAttributeCooperative: a grid
// the card cannot hold at once fails the launch, and the wrapper raises;
// it never waits for blocks that are not running). The P = SMs / D blocks
// of a direction split its H / 16 unit tiles of 16 hidden units: block p
// owns the tiles [p NUT / P, (p + 1) NUT / P) and so their r, z and n
// columns; D above the SMs runs in groups of directions, one launch each.
// A step is a GEMM over the block's columns: for each row tile of R <= 64
// batch rows and column chunk of at most kGridMaxTiles unit tiles, a K
// loop over chunks of 64. The producer warp copies each chunk's A piece
// (the state rows, R x 64 bf16) and B piece (w_hh's 64 rows of the chunk's
// columns) by bulk copies (the TMA engine) into a ring of kGridStages
// stages; the consumer warps multiply on mma.sync m16n8k16 from ldmatrix
// fragments (see "the ring" below). So nothing in shared memory grows with
// H. What the ring leaves of the 227 KB holds the first chunks of the
// block's slice of w_hh, loaded once (resident); the rest streams from L2
// or device memory every step. The wrapper hands the kernels w_hh packed
// by unit tile and K chunk (ops/kernels/gru.py:pack_grid), so that a B
// piece is one contiguous 6 KiB range a unit tile (the backward's dh
// product: 2 KiB). Each consumer warp owns (16-row tile, unit tile)
// items, r, z and n of the same units in its accumulators, and does their
// gate math in registers straight from the accumulators.
//
// The exchange between steps goes through global memory, in L2: the
// forward writes the new bf16 state of its units into a double-buffered
// (2, D, B, H) buffer, the backward its bf16 dgates (dpr, dz, dpn * r)
// into a (2, D, B, 3H) one, and one grid-wide barrier a step (a release
// add and acquire loads of a counter in global memory) orders them.
//
// Backward, step t (t from T - 1 down): the gate product h_prev[t] @ w_hh
// of the block's columns (a saved input: nothing of the chain), then the
// gate math with dh (f32, in dh0's buffer: the owner's units only) and
// g[t]: dxw and r to global memory, dgates to the exchange, dh = dh_t * z;
// the grid barrier; then dh of the block's units, dgates (R x 3H) @
// w_hh[units, :]^T (K = 3H, the block's rows of w_hh as the B^T piece),
// added to dh. Each unit's dh is summed by one thread in one fixed order,
// so two runs agree in every bit, and the next step's gate product needs
// no barrier: the block reads only its own units' dh.
//
// What bounds it: at the training shape the serial chain, not the work (2
// us a step of bound at (2, 32, 500, 2304), 28 us measured: the grid
// barrier ~6, the stream of B ~8, the gate math ~5, the ring's own
// turn-around ~8; scripts/perf/gru_grid_probe.py --variants, NVIDIA H100
// 80GB HBM3, 700.00 W); at many rows the products and the slice of w_hh
// re-streamed for every row tile of 64.
#pragma once

#include <algorithm>

#include "conv2d_wgmma.cuh"
#include "gru_cluster_wide.cuh"

namespace {

constexpr int kGridMinH = kWideMaxH;  // the design takes H above this,
constexpr int kGridStep = 64;         // a multiple of this (the K chunk)
// consumer warps, and one producer more: 8 warps, 2 an SM sub-partition,
// so that a thread may hold up to 255 registers (9 warps, 3 on one
// sub-partition, cap it at 168, and the backward's epilogue spilled)
constexpr int kGridWarps = 7;
constexpr int kGridThreads = 32 * (kGridWarps + 1);
constexpr int kGridStages = 5;        // the ring
constexpr int kGridMaxRows = 64;      // rows a row tile
constexpr int kGridMaxTiles = 4;      // unit tiles of 16 a column chunk
// (16-row tile, unit tile) items a consumer warp: a column chunk holds at
// most kGridItems x kGridWarps / (R / 16) unit tiles (grid_plan)
constexpr int kGridItems = 2;
constexpr int kGridCounterBytes = 256;  // the barrier's counter, first
// bytes of a unit tile's packed chunk: the gate product's 64 rows x (r, z,
// n) x 16 units, the dh product's 16 rows x 64 columns
constexpr int kGridTile1 = 2 * 64 * 48;
constexpr int kGridTile2 = 2 * 16 * 64;
// the mbarriers' bytes before the ring, whose A pieces TMA writes with a
// 128-byte swizzle (1024-byte aligned), and the slack to align the base
constexpr int kGridBarBytes = 1024;

// One launch: its directions, and how its blocks cut theirs.
struct GridPlan {
  int D0, Dg;     // the launch's directions [D0, D0 + Dg)
  int B, T, H;
  int P;          // blocks a direction
  int NUT;        // unit tiles of 16 a direction
  int CT;         // unit tiles a column chunk at most
  int NCC;        // column chunks of the largest block
  int R, NRT;     // rows a row tile (a multiple of 16), row tiles
  int stage;      // bytes of a ring stage
  int off_b;      // bytes from a stage to its B piece
  int nres1;      // resident chunks of the gate product's B
  int nres2;      // ... of the backward's dh product's B^T
  int off_res1, off_res2;
  int smem;
};

// the grid kernels take any H a multiple of kGridStep; the C entry points'
// design queries send them H above kGridMinH (gru_grid_runs), and the
// design of 16 blocks everything from 513 to 2048
inline bool gru_grid_takes(int H) { return H > 0 && H % kGridStep == 0; }

inline bool gru_grid_runs(int H) {
  return H > kGridMinH && gru_grid_takes(H);
}

// bytes of a B piece (CT unit tiles): the gate product's, the dh
// product's
__host__ __device__ inline int grid_piece1(const GridPlan& L) {
  return L.CT * kGridTile1;
}

__host__ __device__ inline int grid_piece2(const GridPlan& L) {
  return L.CT * kGridTile2;
}

// The plan of a launch of dg directions, with `blocks` the grid the card
// holds at once (one block an SM). Shared memory: the mbarriers, the
// ring, the resident pieces.
inline GridPlan grid_plan(int d0, int dg, int B, int T, int H, bool backward,
                          int blocks) {
  GridPlan L = {};
  L.D0 = d0;
  L.Dg = dg;
  L.B = B;
  L.T = T;
  L.H = H;
  L.NUT = H / 16;
  L.P = std::max(1, std::min(blocks / dg, L.NUT));
  L.R = std::min(kGridMaxRows, (B + 15) / 16 * 16);
  L.NRT = (B + L.R - 1) / L.R;
  const int nut = (L.NUT + L.P - 1) / L.P;
  const int most =
      std::min(kGridMaxTiles, kGridItems * kGridWarps / (L.R / 16));
  L.NCC = (nut + most - 1) / most;
  L.CT = (nut + L.NCC - 1) / L.NCC;
  L.off_b = 128 * L.R;  // the A piece: R rows of 64 bf16
  L.stage = L.off_b + (backward ? std::max(grid_piece1(L), grid_piece2(L))
                                : grid_piece1(L));
  const int ring = kGridStages * L.stage;
  const int avail = kWideSmem - 1024 - kGridBarBytes - ring;
  const int kc = H / 64;
  if (backward) {
    L.nres1 = std::max(0, std::min(L.NCC * kc, avail / 2 / grid_piece1(L)));
    L.nres2 = std::max(0, std::min(3 * L.NCC * kc,
                                   (avail - L.nres1 * grid_piece1(L)) /
                                       grid_piece2(L)));
  } else {
    L.nres1 = std::max(0, std::min(L.NCC * kc, avail / grid_piece1(L)));
  }
  L.off_res1 = kGridBarBytes + ring;
  L.off_res2 = L.off_res1 + L.nres1 * grid_piece1(L);
  L.smem = L.off_res2 + L.nres2 * grid_piece2(L) + 1024;
  return L;
}

// ---- PTX: copies, the barrier ----------------------------------------------

// an mbarrier expecting `count` arrivals a phase
__device__ __forceinline__ void grid_bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   cl_smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void grid_bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   cl_smem_u32(bar))
               : "memory");
}

// The grid-wide barrier: every block arrives (a release add) and waits
// until the counter reaches `target` (acquire loads); what any thread of
// the grid wrote before it is visible to every thread after it. The grid
// is co-resident (a cooperative launch), so every block arrives; a wait
// past 20 s traps, so a fault surfaces as a launch error, not a hung card.
__device__ __forceinline__ void grid_sync(unsigned int* counter,
                                          unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
    unsigned long long start, now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(start));
    for (;;) {
      unsigned int seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (seen >= target) break;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (now - start > 20000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// ---- what a block owns ------------------------------------------------------

struct GridBlock {
  int d;      // its direction
  int dl;     // ... within the launch
  int tile0;  // its first unit tile
  int nut;    // its unit tiles
  int ncc;    // its column chunks
};

__device__ __forceinline__ GridBlock grid_block(const GridPlan& L) {
  GridBlock g;
  g.dl = blockIdx.x / L.P;
  g.d = L.D0 + g.dl;
  const int p = blockIdx.x - g.dl * L.P;
  g.tile0 = p * L.NUT / L.P;
  g.nut = (p + 1) * L.NUT / L.P - g.tile0;
  g.ncc = (g.nut + L.CT - 1) / L.CT;
  return g;
}

// the first unit of column chunk cc, and its unit tiles
__device__ __forceinline__ int grid_u0(const GridPlan& L, const GridBlock& g,
                                       int cc) {
  return 16 * (g.tile0 + cc * L.CT);
}

__device__ __forceinline__ int grid_ct(const GridPlan& L, const GridBlock& g,
                                       int cc) {
  return min(L.CT, g.nut - cc * L.CT);
}

// ---- the ring ----------------------------------------------------------------
//
// One producer warp (warp kGridWarps) copies each chunk's pieces with bulk
// copies (cp.async.bulk, the TMA engine) into a stage of the ring and
// counts them on the stage's `full` mbarrier; the consumer warps wait on
// it, multiply, and arrive on its `empty` mbarrier, which the producer
// waits on before it refills the stage. No block barrier a chunk: the
// warps run apart up to the ring's depth. The A piece is one tensor copy
// of R rows x 64 values (a box of a tensor map of the state, h_prev or the
// dgates; 128-byte swizzle, so that ldmatrix meets no bank conflict; rows
// past the batch are other rows or zeros, whose products land in rows
// that are never stored); a B piece one bulk copy a
// unit tile, from w_hh packed so that each 8 x 8 matrix of ldmatrix is
// 128 contiguous bytes (ops/kernels/gru.py:pack_grid): the gate product's
// (k8, gate, unit half) matrices of 64 rows x (r, z, n) x 16 units, the dh
// product's (column 8, unit half) ones of 16 units x 64 columns.

// The ring's position, the same in every thread: the stage of the next
// chunk and the parity of its mbarriers' phase.
struct GridRing {
  int stage, phase;
  __device__ __forceinline__ void step() {
    if (++stage == kGridStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  __device__ __forceinline__ void advance(int n) {
    const int next = stage + n;
    phase ^= (next / kGridStages) & 1;
    stage = next % kGridStages;
  }
};

// the block's shared memory from its first 1024-byte boundary (the plan
// allocates 1024 bytes of slack)
__device__ __forceinline__ unsigned char* grid_align(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint64_t* grid_bars(unsigned char* smem) {
  return reinterpret_cast<uint64_t*>(smem);  // full, empty, resident
}

// unit tile jl of chunk (cc, kc): its packed source
template <int MODE>
__device__ __forceinline__ const __nv_bfloat16* grid_tile(
    const GridPlan& L, const GridBlock& g, int cc, int kc, int jl,
    const __nv_bfloat16* w) {
  const size_t tile = g.tile0 + cc * L.CT + jl;
  if constexpr (MODE == 0)
    return w + (tile * (L.H / 64) + kc) * (kGridTile1 / 2);
  else
    return w + (tile * (3 * L.H / 64) + kc) * (kGridTile2 / 2);
}

// A phase's A operand: its tensor map (3-D, a box of 64 x R rows) and
// where row tile rt's box sits: (64 kc, y, z + R rt) with rows_in_z, else
// (64 kc, y + R rt, z).
struct GridA {
  const CUtensorMap* map;
  int y, z;
  bool rows_in_z;
};

// The producer's part of one phase: chunks 0 .. n - 1, (row tile, column
// chunk, k chunk) in that order, each into the ring's next stage once the
// consumers have released it.
template <int MODE>
__device__ __forceinline__ void grid_produce(unsigned char* smem,
                                             GridRing ring, const GridPlan& L,
                                             const GridBlock& g, int KC,
                                             const GridA& a,
                                             const __nv_bfloat16* w,
                                             int nres) {
  const int lane = threadIdx.x % 32;
  const int tile_bytes = MODE == 0 ? kGridTile1 : kGridTile2;
  uint64_t* full = grid_bars(smem);
  uint64_t* empty = full + kGridStages;
  // the A rows may be the exchange, written by other blocks' threads
  // before the grid barrier: order those writes before the bulk copies
  if (lane == 0) asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncwarp();
  for (int rt = 0; rt < L.NRT; ++rt) {
    const int ay = a.y + (a.rows_in_z ? 0 : L.R * rt);
    const int az = a.z + (a.rows_in_z ? L.R * rt : 0);
    for (int cc = 0; cc < g.ncc; ++cc) {
      const int ct = grid_ct(L, g, cc);
      for (int kc = 0; kc < KC; ++kc) {
        const bool resident = cc * KC + kc < nres;
        wide_bar_wait(empty + ring.stage, ring.phase ^ 1);
        unsigned char* st = smem + kGridBarBytes + ring.stage * L.stage;
        uint64_t* bar = full + ring.stage;
        if (lane == 0) {
          // the stage was read through the generic proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wide_bar_expect(bar, L.off_b + (resident ? 0 : ct * tile_bytes));
          tma_load_3d(st, a.map, bar, 64 * kc, ay, az);
        }
        __syncwarp();
        if (!resident && lane < ct)
          wide_bulk(st + L.off_b + lane * tile_bytes,
                    grid_tile<MODE>(L, g, cc, kc, lane, w), tile_bytes, bar);
        ring.step();
      }
    }
  }
}

// The resident chunks (cc, kc) with cc KC + kc < nres: their bytes (which
// the producer's lane 0 expects first), and their copies to res + (cc KC
// + kc) pieces by the producer's lanes, counted on `bar`.
template <int MODE>
__device__ __forceinline__ int grid_resident_bytes(const GridPlan& L,
                                                   const GridBlock& g, int KC,
                                                   int nres) {
  int bytes = 0;
  for (int c = 0; c < min(nres, g.ncc * KC); ++c)
    bytes += grid_ct(L, g, c / KC) * (MODE == 0 ? kGridTile1 : kGridTile2);
  return bytes;
}

template <int MODE>
__device__ __forceinline__ void grid_load_resident(unsigned char* res,
                                                   const GridPlan& L,
                                                   const GridBlock& g, int KC,
                                                   const __nv_bfloat16* w,
                                                   int nres, uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  const int tile_bytes = MODE == 0 ? kGridTile1 : kGridTile2;
  const int piece = MODE == 0 ? grid_piece1(L) : grid_piece2(L);
  for (int c = 0; c < min(nres, g.ncc * KC); ++c) {
    const int cc = c / KC;
    if (lane < grid_ct(L, g, cc))
      wide_bulk(res + c * piece + lane * tile_bytes,
                grid_tile<MODE>(L, g, cc, c % KC, lane, w), tile_bytes, bar);
  }
}

// ---- products ----------------------------------------------------------------

// One stage into the accumulators of this warp's items (item i = warp + 7 s:
// row tile i % mt, unit tile i / mt of the chunk's ct). MODE 0: r, z and n
// columns of the unit tile (B row-major, ldmatrix.trans); MODE 1: the unit
// tile's columns of B^T (ldmatrix). A lane's matrix of the x4 load is
// lane / 8 (matrices 0, 1: the k16 step's two k8 halves of the unit
// tile's columns 0-7; 2, 3: of columns 8-15), its row lane % 8.
template <int MODE, int NG>
__device__ __forceinline__ void grid_mma(float (&acc)[kGridItems][NG][2][4],
                                         uint32_t sa, uint32_t sb, int mt,
                                         int ct) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mi = lane / 8;
#pragma unroll
  for (int s = 0; s < kGridItems; ++s) {
    const int item = warp + kGridWarps * s;
    if (item < mt * ct) {
      const int m = item % mt;
      const int jl = item / mt;
      // row r of the A piece at 128 r, its 16-byte chunk q at (q ^ r % 8)
      const int r = 16 * m + lane % 16;
      const uint32_t a_row = sa + 128 * r;
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16) {
        uint32_t a[4];
        wide_ldsm(a, a_row + (((2 * k16 + lane / 16) ^ (r & 7)) << 4));
        const int kb = 2 * k16 + (mi & 1);
        if constexpr (MODE == 0) {
#pragma unroll
          for (int gate = 0; gate < 3; ++gate) {
            uint32_t b[4];
            wide_ldsm_t(b, sb + jl * kGridTile1 +
                               ((kb * 3 + gate) * 2 + (mi >> 1)) * 128 +
                               (lane % 8) * 16);
            wide_mma(acc[s][gate][0], a, b[0], b[1]);
            wide_mma(acc[s][gate][1], a, b[2], b[3]);
          }
        } else {
          uint32_t b[4];
          wide_ldsm(b, sb + jl * kGridTile2 + (kb * 2 + (mi >> 1)) * 128 +
                           (lane % 8) * 16);
          wide_mma(acc[s][0][0], a, b[0], b[1]);
          wide_mma(acc[s][0][1], a, b[2], b[3]);
        }
      }
    }
  }
}

// One phase: the GEMM of a step over the block's chunks (row tiles x
// column chunks x K / 64). The producer warp copies them into the ring
// (grid_produce), the consumer warps multiply them as they land and call
// epi(rt, cc, ct, acc) after each K loop. K = 64 KC; a: the A operand.
// Every thread's ring advances by the phase's chunks.
template <int MODE, typename Epi>
__device__ __forceinline__ void grid_phase(unsigned char* smem,
                                           GridRing& ring, const GridPlan& L,
                                           const GridBlock& g, int KC,
                                           const GridA& a,
                                           const __nv_bfloat16* w, int nres,
                                           uint32_t res, Epi&& epi) {
  constexpr int NG = MODE == 0 ? 3 : 1;
  const int piece = MODE == 0 ? grid_piece1(L) : grid_piece2(L);
  const int n = L.NRT * g.ncc * KC;
  if (threadIdx.x / 32 == kGridWarps) {
    grid_produce<MODE>(smem, ring, L, g, KC, a, w, nres);
    ring.advance(n);
    return;
  }
  const int mt = L.R / 16;
  uint64_t* full = grid_bars(smem);
  uint64_t* empty = full + kGridStages;
  const uint32_t ring_base = cl_smem_u32(smem) + kGridBarBytes;
  float acc[kGridItems][NG][2][4];
  for (int rt = 0; rt < L.NRT; ++rt) {
    for (int cc = 0; cc < g.ncc; ++cc) {
#pragma unroll
      for (int s = 0; s < kGridItems; ++s)
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[s][q][h][i] = 0.f;
      const int ct = grid_ct(L, g, cc);
      for (int kc = 0; kc < KC; ++kc) {
        const uint32_t sa = ring_base + ring.stage * L.stage;
        const int c = cc * KC + kc;
        wide_bar_wait(full + ring.stage, ring.phase);
        grid_mma<MODE, NG>(acc, sa,
                           c < nres ? res + c * piece : sa + L.off_b, mt,
                           ct);
        __syncwarp();
        if (threadIdx.x % 32 == 0) grid_bar_arrive(empty + ring.stage);
        ring.step();
      }
      epi(rt, cc, ct, acc);
    }
  }
}

// The epilogue of chunk (rt, cc) over this lane's accumulator pairs
// (batch row b < B, units u and u + 1), in two passes so that their global
// loads are in flight together: in[s][i][h] = load(b, u) for every pair,
// then use(b, u, v, in[s][i][h]) with v[q][e] the accumulator of product
// column block q (the gate, forward) at unit u + e.
template <typename In, int NG, typename Load, typename Use>
__device__ __forceinline__ void grid_pairs(
    const GridPlan& L, const GridBlock& g, int rt, int cc, int ct,
    const float (&acc)[kGridItems][NG][2][4], Load&& load, Use&& use) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mt = L.R / 16;
  In in[kGridItems][2][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int s = 0; s < kGridItems; ++s) {
      const int item = warp + kGridWarps * s;
      if (item < mt * ct) {
        const int m = item % mt;
        const int jl = item / mt;
        const int u = grid_u0(L, g, cc) + 16 * jl + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int b = rt * L.R + 16 * m + lane / 4 + 8 * i;
          if (b < L.B) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (pass == 0) {
                in[s][i][h] = load(b, u + 8 * h);
              } else {
                float v[NG][2];
#pragma unroll
                for (int q = 0; q < NG; ++q) {
                  v[q][0] = acc[s][q][h][2 * i];
                  v[q][1] = acc[s][q][h][2 * i + 1];
                }
                use(b, u + 8 * h, v, in[s][i][h]);
              }
            }
          }
        }
      }
    }
  }
}

// what the epilogues load: the forward's xw (r, z, n) and previous state;
// the backward's xw, g, bf16 h_prev and dh; its dh product's dh
struct GridFwdIn {
  __nv_bfloat162 x[3];
  float2 hp;
};

struct GridBwdIn {
  __nv_bfloat162 x[3];
  float2 g;
  __nv_bfloat162 hp;
  float2 dh;
};

__device__ __forceinline__ void grid_load_x(__nv_bfloat162 (&x)[3],
                                            const __nv_bfloat16* x_t, int H) {
#pragma unroll
  for (int gate = 0; gate < 3; ++gate)
    x[gate] = *reinterpret_cast<const __nv_bfloat162*>(x_t + gate * H);
}

// The block's set-up, before its first grid barrier or phase: the
// mbarriers (thread 0), then the resident pieces of both products by the
// producer's bulk copies on the resident mbarrier (none for an empty
// product). Returns whether there are any (the consumer warps wait on the
// resident mbarrier after a block barrier before their first phase).
__device__ __forceinline__ bool grid_setup(unsigned char* smem,
                                           const GridPlan& L,
                                           const GridBlock& g, int KC,
                                           const __nv_bfloat16* w1,
                                           const __nv_bfloat16* w2) {
  uint64_t* bars = grid_bars(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGridStages; ++s) {
      grid_bar_init(bars + s, 1);
      grid_bar_init(bars + kGridStages + s, kGridWarps);
    }
    grid_bar_init(bars + 2 * kGridStages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int bytes = grid_resident_bytes<0>(L, g, KC, L.nres1) +
                    grid_resident_bytes<1>(L, g, 3 * KC, L.nres2);
  if (bytes > 0 && threadIdx.x / 32 == kGridWarps) {
    uint64_t* bar = bars + 2 * kGridStages;
    if (threadIdx.x % 32 == 0) wide_bar_expect(bar, bytes);
    __syncwarp();
    grid_load_resident<0>(smem + L.off_res1, L, g, KC, w1, L.nres1, bar);
    if (w2 != nullptr)
      grid_load_resident<1>(smem + L.off_res2, L, g, 3 * KC, w2, L.nres2,
                            bar);
  }
  return bytes > 0;
}

// ---- forward -------------------------------------------------------------------

// grid P x Dg (cooperative), kGridThreads threads. hx: the exchanged bf16
// state, (2, Dg, B, H); counter: zero at the launch.
template <typename = void>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_grid_fwd_kernel(const __nv_bfloat16* __restrict__ xw,    // (D, B, T, 3H)
                    const __nv_bfloat16* __restrict__ w_hh,  // packed
                    const float* __restrict__ b_hh,          // (D, 3H)
                    const float* __restrict__ h0,            // (D, B, H)
                    float* y,                                // (D, B, T, H)
                    __nv_bfloat16* hx, unsigned int* counter,
                    const GridPlan L,
                    const __grid_constant__ CUtensorMap hx_map) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = grid_align(smem_raw);
  const GridBlock g = grid_block(L);
  const int H = L.H;
  const int G = 3 * H;
  const int B = L.B;
  const int T = L.T;
  const int KC = H / 64;
  const __nv_bfloat16* w = w_hh + static_cast<size_t>(g.d) * H * G;
  const uint32_t res = cl_smem_u32(smem) + L.off_res1;
  const bool resident = grid_setup(smem, L, g, KC, w, nullptr);
  // copy 0 of the exchanged state: bf16(h0) of the block's units
  const size_t plane = static_cast<size_t>(L.Dg) * B * H;
  const int pairs = 8 * g.nut;
  for (int e = threadIdx.x; e < B * pairs; e += kGridThreads) {
    const int b = e / pairs;
    const int u = 16 * g.tile0 + 2 * (e - b * pairs);
    const float2 v = *reinterpret_cast<const float2*>(
        h0 + (static_cast<size_t>(g.d) * B + b) * H + u);
    *reinterpret_cast<__nv_bfloat162*>(
        hx + (static_cast<size_t>(g.dl) * B + b) * H + u) =
        __floats2bfloat162_rn(v.x, v.y);
  }
  unsigned int gen = 1;
  grid_sync(counter, gen * gridDim.x);
  if (resident && threadIdx.x / 32 < kGridWarps)
    wide_bar_wait(grid_bars(smem) + 2 * kGridStages, 0);
  const float* bias = b_hh + static_cast<size_t>(g.d) * G;
  GridRing ring = {0, 0};
  for (int t = 0; t < T; ++t) {
    __nv_bfloat16* h_next =
        hx + ((t + 1) & 1) * plane + static_cast<size_t>(g.dl) * B * H;
    const GridA a = {&hx_map, g.dl * B, t & 1, false};
    grid_phase<0>(smem, ring, L, g, KC, a, w, L.nres1, res,
                  [&](int rt, int cc, int ct, const auto& acc) {
      grid_pairs<GridFwdIn>(L, g, rt, cc, ct, acc,
          [&](int b, int u) {
        const size_t row = static_cast<size_t>(g.d) * B + b;
        GridFwdIn in;
        grid_load_x(in.x, xw + (row * T + t) * G + u, H);
        in.hp = *reinterpret_cast<const float2*>(
            t > 0 ? y + (row * T + t - 1) * H + u : h0 + row * H + u);
        return in;
      },
          [&](int b, int u, const float (&v)[3][2], const GridFwdIn& in) {
        const size_t row = static_cast<size_t>(g.d) * B + b;
        float x[3][2];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const float2 f = __bfloat1622float2(in.x[gate]);
          x[gate][0] = f.x;
          x[gate][1] = f.y;
        }
        const float h_prev[2] = {in.hp.x, in.hp.y};
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rr =
              cl_sigmoid(x[0][e] + (v[0][e] + __ldg(bias + u + e)));
          const float zz =
              cl_sigmoid(x[1][e] + (v[1][e] + __ldg(bias + H + u + e)));
          const float nn =
              tanhf(x[2][e] + rr * (v[2][e] + __ldg(bias + 2 * H + u + e)));
          out[e] = (1.f - zz) * nn + zz * h_prev[e];
        }
        *reinterpret_cast<float2*>(y + (row * T + t) * H + u) =
            make_float2(out[0], out[1]);
        *reinterpret_cast<__nv_bfloat162*>(h_next + static_cast<size_t>(b) * H +
                                           u) =
            __floats2bfloat162_rn(out[0], out[1]);
      });
    });
    if (t + 1 < T) grid_sync(counter, ++gen * gridDim.x);
  }
}

// ---- split backward ------------------------------------------------------------

// grid P x Dg (cooperative). dgx: the exchanged bf16 dgates, (2, Dg, B,
// 3H); counter: zero at the launch. dh0 carries dh through the sweep.
template <typename = void>
__global__ void __launch_bounds__(kGridThreads, 1)
gru_grid_bwd_kernel(const __nv_bfloat16* __restrict__ xw,      // (D, B, T, 3H)
                    const __nv_bfloat16* __restrict__ h_prev,  // (D, B, T, H)
                    const __nv_bfloat16* __restrict__ w_gate,  // packed
                    const __nv_bfloat16* __restrict__ w_dh,    // packed
                    const float* __restrict__ b_hh,            // (D, 3H)
                    const float* __restrict__ g_in,            // (D, B, T, H)
                    __nv_bfloat16* __restrict__ dxw,           // (D, B, T, 3H)
                    __nv_bfloat16* __restrict__ r_out,         // (D, B, T, H)
                    float* dh0,                                // (D, B, H)
                    __nv_bfloat16* dgx, unsigned int* counter,
                    const GridPlan L,
                    const __grid_constant__ CUtensorMap hp_map,
                    const __grid_constant__ CUtensorMap dg_map) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = grid_align(smem_raw);
  const GridBlock g = grid_block(L);
  const int H = L.H;
  const int G = 3 * H;
  const int B = L.B;
  const int T = L.T;
  const int KC = H / 64;
  const __nv_bfloat16* w = w_gate + static_cast<size_t>(g.d) * H * G;
  const __nv_bfloat16* w2 = w_dh + static_cast<size_t>(g.d) * H * G;
  const uint32_t res1 = cl_smem_u32(smem) + L.off_res1;
  const uint32_t res2 = cl_smem_u32(smem) + L.off_res2;
  const bool resident = grid_setup(smem, L, g, KC, w, w2);
  // dh = 0 for the block's units
  const int pairs = 8 * g.nut;
  for (int e = threadIdx.x; e < B * pairs; e += kGridThreads) {
    const int b = e / pairs;
    const int u = 16 * g.tile0 + 2 * (e - b * pairs);
    *reinterpret_cast<float2*>(dh0 + (static_cast<size_t>(g.d) * B + b) * H +
                               u) = make_float2(0.f, 0.f);
  }
  __syncthreads();
  if (resident && threadIdx.x / 32 < kGridWarps)
    wide_bar_wait(grid_bars(smem) + 2 * kGridStages, 0);
  const size_t plane = static_cast<size_t>(L.Dg) * B * G;
  const float* bias = b_hh + static_cast<size_t>(g.d) * G;
  unsigned int gen = 0;
  GridRing ring = {0, 0};
  for (int t = T - 1; t >= 0; --t) {
    __nv_bfloat16* dg =
        dgx + (t & 1) * plane + static_cast<size_t>(g.dl) * B * G;
    // the gate product h_prev[t] @ w_hh[:, cols] and the gate math
    const GridA a1 = {&hp_map, t, g.d * B, true};
    grid_phase<0>(
        smem, ring, L, g, KC, a1, w, L.nres1, res1,
        [&](int rt, int cc, int ct, const auto& acc) {
      grid_pairs<GridBwdIn>(L, g, rt, cc, ct, acc,
          [&](int b, int u) {
        const size_t row = static_cast<size_t>(g.d) * B + b;
        const size_t step = row * T + t;
        GridBwdIn in;
        grid_load_x(in.x, xw + step * G + u, H);
        in.g = *reinterpret_cast<const float2*>(g_in + step * H + u);
        in.hp = *reinterpret_cast<const __nv_bfloat162*>(h_prev + step * H +
                                                         u);
        in.dh = *reinterpret_cast<const float2*>(dh0 + row * H + u);
        return in;
      },
          [&](int b, int u, const float (&v)[3][2], const GridBwdIn& in) {
        const size_t row = static_cast<size_t>(g.d) * B + b;
        const size_t step = row * T + t;
        float x[3][2];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const float2 f = __bfloat1622float2(in.x[gate]);
          x[gate][0] = f.x;
          x[gate][1] = f.y;
        }
        const float2 hp = __bfloat1622float2(in.hp);
        const float g_t[2] = {in.g.x, in.g.y};
        const float h_p[2] = {hp.x, hp.y};
        const float dh_in[2] = {in.dh.x, in.dh.y};
        float dpr[2], dz[2], dpn[2], rr[2], dgn[2], dh_out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hn = v[2][e] + __ldg(bias + 2 * H + u + e);
          rr[e] = cl_sigmoid(x[0][e] + (v[0][e] + __ldg(bias + u + e)));
          const float zz =
              cl_sigmoid(x[1][e] + (v[1][e] + __ldg(bias + H + u + e)));
          const float nn = tanhf(x[2][e] + rr[e] * hn);
          const float dht = g_t[e] + dh_in[e];
          dz[e] = dht * (h_p[e] - nn) * zz * (1.f - zz);
          dpn[e] = dht * (1.f - zz) * (1.f - nn * nn);
          dpr[e] = dpn[e] * hn * rr[e] * (1.f - rr[e]);
          dgn[e] = dpn[e] * rr[e];
          dh_out[e] = dht * zz;
        }
        __nv_bfloat16* dx_t = dxw + step * G + u;
        *reinterpret_cast<__nv_bfloat162*>(dx_t) =
            __floats2bfloat162_rn(dpr[0], dpr[1]);
        *reinterpret_cast<__nv_bfloat162*>(dx_t + H) =
            __floats2bfloat162_rn(dz[0], dz[1]);
        *reinterpret_cast<__nv_bfloat162*>(dx_t + 2 * H) =
            __floats2bfloat162_rn(dpn[0], dpn[1]);
        *reinterpret_cast<__nv_bfloat162*>(r_out + step * H + u) =
            __floats2bfloat162_rn(rr[0], rr[1]);
        __nv_bfloat16* dg_b = dg + static_cast<size_t>(b) * G + u;
        *reinterpret_cast<__nv_bfloat162*>(dg_b) =
            __floats2bfloat162_rn(dpr[0], dpr[1]);
        *reinterpret_cast<__nv_bfloat162*>(dg_b + H) =
            __floats2bfloat162_rn(dz[0], dz[1]);
        *reinterpret_cast<__nv_bfloat162*>(dg_b + 2 * H) =
            __floats2bfloat162_rn(dgn[0], dgn[1]);
        *reinterpret_cast<float2*>(dh0 + row * H + u) =
            make_float2(dh_out[0], dh_out[1]);
      });
    });
    // every block's dgates of step t are in the exchange
    grid_sync(counter, ++gen * gridDim.x);
    // dh += dgates (R x 3H) @ w_hh[units, :]^T
    const GridA a2 = {&dg_map, g.dl * B, t & 1, false};
    grid_phase<1>(smem, ring, L, g, 3 * KC, a2, w2, L.nres2, res2,
                  [&](int rt, int cc, int ct, const auto& acc) {
      grid_pairs<float2>(L, g, rt, cc, ct, acc,
          [&](int b, int u) {
        return *reinterpret_cast<const float2*>(
            dh0 + (static_cast<size_t>(g.d) * B + b) * H + u);
      },
          [&](int b, int u, const float (&v)[1][2], const float2& dh) {
        *reinterpret_cast<float2*>(
            dh0 + (static_cast<size_t>(g.d) * B + b) * H + u) =
            make_float2(dh.x + v[0][0], dh.y + v[0][1]);
      });
    });
  }
}

// ---- launch --------------------------------------------------------------------

// blocks of the kernel the card holds at once: one an SM
inline cudaError_t grid_blocks(int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(blocks, cudaDevAttrMultiProcessorCount,
                                 device);
  return err;
}

// A 3-D bf16 tensor map with a box of 64 x R rows (the rows in dimension
// 1, or 2 with rows_in_z), 128-byte swizzle: dims innermost first, byte
// strides of dims 1 and 2.
inline cudaError_t grid_map(CUtensorMap* map, const void* base, uint64_t d0,
                            uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                            int R, bool rows_in_z) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {64, rows_in_z ? 1u : static_cast<cuuint32_t>(R),
                             rows_in_z ? static_cast<cuuint32_t>(R) : 1u};
  return make_map(map, base, 3, dims, strides, box, 128);
}

template <typename Kernel, typename... Args>
cudaError_t grid_launch(Kernel kernel, const GridPlan& L, void* workspace,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
  if (err != cudaSuccess) return err;
  // the barrier's counter, zero at the launch
  err = cudaMemsetAsync(workspace, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.P * L.Dg);
  cfg.blockDim = dim3(kGridThreads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the exchange buffer, after the counter's bytes
template <typename T>
T* grid_exchange(void* workspace) {
  return reinterpret_cast<T*>(static_cast<unsigned char*>(workspace) +
                              kGridCounterBytes);
}

// (gru_grid_fwd, gru_grid_bwd and gru_grid_design are templates so that a
// source instantiates only the kernels it launches)
template <typename = void>
cudaError_t gru_grid_fwd(const void* xw, const void* w_hh, const void* b_hh,
                         const void* h0, void* y, void* workspace, int D,
                         int B, int T, int H, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = grid_blocks(&blocks);
  __nv_bfloat16* hx = grid_exchange<__nv_bfloat16>(workspace);
  for (int d0 = 0; err == cudaSuccess && d0 < D; d0 += blocks) {
    const GridPlan L =
        grid_plan(d0, std::min(D - d0, blocks), B, T, H, false, blocks);
    // the exchanged state (2, Dg, B, H): rows (Dg B) of H, two copies
    CUtensorMap hx_map;
    err = grid_map(&hx_map, hx, H, static_cast<uint64_t>(L.Dg) * B, 2,
                   2ull * H, 2ull * L.Dg * B * H, L.R, false);
    if (err != cudaSuccess) return err;
    err = grid_launch(gru_grid_fwd_kernel<>, L, workspace, s,
                      static_cast<const __nv_bfloat16*>(xw),
                      static_cast<const __nv_bfloat16*>(w_hh),
                      static_cast<const float*>(b_hh),
                      static_cast<const float*>(h0), static_cast<float*>(y),
                      hx, static_cast<unsigned int*>(workspace), L, hx_map);
  }
  return err;
}

template <typename = void>
cudaError_t gru_grid_bwd(const void* xw, const void* h_prev,
                         const void* w_gate, const void* w_dh,
                         const void* b_hh, const void* g, void* dxw, void* r,
                         void* dh0, void* workspace, int D, int B, int T,
                         int H, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = grid_blocks(&blocks);
  __nv_bfloat16* dgx = grid_exchange<__nv_bfloat16>(workspace);
  // h_prev (D, B, T, H): rows (D B) of T steps of H
  CUtensorMap hp_map;
  for (int d0 = 0; err == cudaSuccess && d0 < D; d0 += blocks) {
    const GridPlan L =
        grid_plan(d0, std::min(D - d0, blocks), B, T, H, true, blocks);
    err = grid_map(&hp_map, h_prev, H, T, static_cast<uint64_t>(D) * B,
                   2ull * H, 2ull * T * H, L.R, true);
    if (err != cudaSuccess) return err;
    // the exchanged dgates (2, Dg, B, 3H)
    CUtensorMap dg_map;
    err = grid_map(&dg_map, dgx, 3ull * H, static_cast<uint64_t>(L.Dg) * B,
                   2, 6ull * H, 6ull * L.Dg * B * H, L.R, false);
    if (err != cudaSuccess) return err;
    err = grid_launch(
        gru_grid_bwd_kernel<>, L, workspace, s,
        static_cast<const __nv_bfloat16*>(xw),
        static_cast<const __nv_bfloat16*>(h_prev),
        static_cast<const __nv_bfloat16*>(w_gate),
        static_cast<const __nv_bfloat16*>(w_dh),
        static_cast<const float*>(b_hh), static_cast<const float*>(g),
        static_cast<__nv_bfloat16*>(dxw), static_cast<__nv_bfloat16*>(r),
        static_cast<float*>(dh0), dgx, static_cast<unsigned int*>(workspace),
        L, hp_map, dg_map);
  }
  return err;
}

// The design query's answer for this design (3: the grid design), as
// pbsed_gru_design (gru.cu) reports it, for the first launch of the shape:
// *cluster: blocks a direction; *rows: rows a row tile; *smem: dynamic
// shared memory a block; *coresident: blocks of the launch (the grid);
// *units: hidden units of the largest block; *resident, *streamed: bytes of
// its slice of w_hh kept in shared memory and read from L2 at every step
// (both products of the backward).
template <bool BACKWARD>
int gru_grid_design(int D, int B, int T, int H, int* cluster, int* rows,
                    int* smem, int* coresident, int* units, int* resident,
                    int* streamed) {
  int blocks = 0;
  const cudaError_t err = grid_blocks(&blocks);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const GridPlan L =
      grid_plan(0, std::min(D, blocks), B, T, H, BACKWARD, blocks);
  const int nut = (L.NUT + L.P - 1) / L.P;
  const long long slice = 2ll * H * 3 * 16 * nut;  // bytes, one product
  const long long kept = 2ll * 64 * 48 * L.CT * L.nres1 +
                         2ll * 16 * L.CT * 64 * L.nres2;
  *cluster = L.P;
  *rows = L.R;
  *smem = L.smem;
  *coresident = L.P * L.Dg;
  *units = 16 * nut;
  *resident = static_cast<int>(std::min(kept, slice * (BACKWARD ? 2 : 1)));
  *streamed = static_cast<int>(slice * (BACKWARD ? 2 : 1) - *resident);
  return 3;
}

}  // namespace
