// The f32 SAME convolution's two GEMMs redesigned for Hopper: 3xTF32 on
// the tensor cores (wgmma .tf32), fed by TMA copies into rings of
// shared-memory stages, filled by a producer warp while consumer
// warpgroups compute. conv2d_f32.cu launches them for every pass of a
// layer that the entry kernels (conv2d_f32_entry.cuh, Cin < 16) do not
// take.
//
// Replaces: no Pallas site. The JAX package convolves a
// compute_dtype='float32' tower with lax.conv_general_dilated on f32
// operands (pb_sed_tpu/ops/cnn.py:113-119) and differentiates it with
// XLA; this is the port's f32 conv pair for those towers.
//
// 3xTF32: each f32 operand v becomes hi = tf32(v) and lo = tf32(v - hi)
// (round to 10 mantissa bits, ties away from zero; an activation's lo is
// truncated to tf32 by the tensor cores instead, tf32_split_act), so
// that v = hi + lo up to ~2^-22 of |v|, and a product is taken as hi*lo
// + lo*hi + hi*hi, the two small ones first; lo*lo (~2^-22 of it) is
// dropped. The
// result is within f32 rounding of an f32 GEMM, where plain TF32 (hi*hi
// alone) misses it by ~1e-3. The tensor cores' f32 accumulate is not a
// chain of round-to-nearest FFMAs (it truncates), so no run of products
// accumulates for long in them: each run starts a fresh accumulator
// (wgmma scale-d = 0) and is added to an f32 register sum with one
// round-to-nearest FADD per element, after every K slice of the forward
// (up to 9 taps x 32 channels; at BN <= 64 the even and the odd k8 steps
// in two runs) and after every tap of a tile of the dw pass.
//
// 1. conv2d_f32_wgmma_kernel, the implicit GEMM of the forward and of the
//    backward's dx (the same kernel on gy with the flipped, transposed
//    weights and the pads mirrored):
//
//      y[p, n] = sum_{dt, df, c} x[p + (dt - lo_t, df - lo_f), c]
//                * w[dt, df, c, n] + bias[n]
//
//    A tile is `rows` frames of W frequencies of one clip (rows = 128 / W,
//    floor: rows * W <= 128 output pixels, 120 at F = 40, 125 at F = 5)
//    x BN <= 128 output channels, W = F up to 128 and 128 above (a tile
//    is then 128 pixels of one frame at a frequency offset f0), halved
//    only where the halo ring would not fit shared memory (the bf16
//    pair's wg_plan); persistent blocks walk the tiles. Per K slice of KC
//    in {16, 32} input channels the producer stages ONE f32 halo tile
//    (rows + kt - 1) x (W + kf - 1) x KC with a 4-D TMA box at (c0, f0 -
//    lo_f, t0 - lo_t, b) into a ring of 2-4 stages; TMA's zero fill is
//    the SAME halo. A fragment row past rows * W computes the tile's
//    last pixel and the epilogue stores nothing of it. All taps read
//    that tile: each consumer thread
//    loads its tap's A fragment values (scalar loads, conflict-free under
//    the TMA swizzle) and splits them in registers; the wgmmas are
//    m64 x BN x k8 with A from registers. The weights are split once per
//    call by conv2d_f32_split_kernel into hi and lo copies, K-major
//    (taps, N, Cin): wgmma reads 32-bit operands from shared memory only
//    K-major. They stream per (K slice, taps) through a 4-stage ring.
//    Stacked members (x (M, B, T, F, Cin), w (M, kt, kf, Cin, N), bias
//    (M, N)) are one (M B)-clip batch of tiles; a tile never straddles
//    two clips, so never two members, and its sums do not depend on M.
//
// 2. conv2d_f32_dw_wgmma_kernel, the weight gradient's f32 partials:
//
//      dw[tap, ci, co] = sum_p x[p + shift(tap), ci] * gy[p, co]
//
//    per tap a GEMM with M = Cin, N = Cout, K = pixels. A block owns up
//    to 64 input channels x BN <= 32 output channels x up to 9 taps and
//    walks the tiles (the forward's geometry) of its chunk; per tile the
//    producer stages the x halo tile and the rows x W gy tile once,
//    through a ring of 2-6 stages. A = x^T comes from the halo tile in
//    registers, split as above; B = gy must be K-major (pixels
//    contiguous), so once per tile the consumers split gy and write its
//    hi and lo transposed, in wgmma's 128-byte swizzle, into one of two
//    buffers that all taps read. The k8 steps cover the tile's P = rows
//    * W pixels rounded up to 16: past P both operands are exact zeros
//    (A's values not read, gy^T's rows written as 0, whatever the stage
//    held), so the partials are those of the tile's own pixels.
//    Consumer warpgroup g owns the taps 3g .. 3g + 2. Each chunk's
//    partials go to their own slot of the workspace, and conv2d_f32.cu's
//    reduce adds them in chunk order: dw is bit-identical between runs.
//
// Bounds on the H100: the TF32 tensor rate x 3 (495 TFLOP/s: a 3xTF32
// product costs 3 TF32 products, so 165 TFLOP/s of f32 work, against
// 67 for FFMA), or at the narrow layers the activations' bytes. The
// weights' hi and lo come from L2 for every pixel tile.
//
// What this design takes: Cin and N (or Cout) >= 16 at multiples of 4
// (the wrappers pad other counts with zeros, ops/kernels/conv.py:
// _f32_channels; Cin < 16 and a dx from fewer than 16 channels run the
// entry kernels), any F, and any extent whose halo ring fits 227 KB at
// some tile (conv2d_f32_wgmma_plan, conv2d_f32_dw_wgmma_plan). A kernel
// whose halo fits no tile launches nothing here; the wrappers run it as
// tap blocks that fit (ops/kernels/conv.py:_f32_tap_blocks), and
// pbsed_conv2d_f32_design reports the choice.
#pragma once

#include "conv2d_wgmma.cuh"

namespace {

constexpr int kF32WStages = 4;        // weight ring of the forward
constexpr int kF32MaxHalo = 4;        // halo tiles of the forward, at most
constexpr int kF32DwMaxStages = 6;    // (x halo, gy) ring of the dw pass

// ---- 3xTF32 -------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo + (a remainder below lo's last bit); v - hi is exact. The
// weights' split, once a call
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// An activation's split in registers, v = hi + lo + (a remainder below
// lo's tf32 bits): hi = tf32(v) rounded to nearest, ties away from zero
// (the f32 bits + half a tf32 ulp, the low 13 bits cleared: cvt.rna's
// result, in three integer and float operations where cvt.rna is
// emulated in some ten), lo = v - hi (exact) left as f32, whose low 13
// bits the tensor cores do not read (a tf32 truncation of lo). At the
// shallow tower's layers it took the 3xTF32 pair's forward 10% and its dw
// 15% faster than a split by cvt.rna, at the same gates
// (scripts/perf/f32_conv_probe.py)
__device__ __forceinline__ void tf32_split_act(float v, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ float lds_f32(const uint8_t* p) {
  return *reinterpret_cast<const float*>(p);
}

// d[64 x N] (+)= a[64 x 8] (tf32 registers) * B[8 x N] (tf32 shared
// memory, K-major), f32 accumulators; scale_d = 0 starts a fresh sum. The
// operand lists are spelled out for each N the kernels use.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// taps of weights (hi and lo) per ring stage of the forward: as many as
// fit in 32 KB, up to 9
__host__ __device__ constexpr int f32_taps_per_stage(int kc, int bn) {
  return 32768 / (2 * bn * kc * 4) < 1   ? 1
         : 32768 / (2 * bn * kc * 4) > 9 ? 9
                                         : 32768 / (2 * bn * kc * 4);
}

// ---- the weights' split --------------------------------------------------

// w (G, K, N) f32 -> hi (G, N, K) and lo (G, N, K) at hi + G N K: each
// group's matrix transposed to K-major and split into its two tf32 parts
__global__ void conv2d_f32_split_kernel(const float* __restrict__ w,
                                        uint32_t* __restrict__ out, int G,
                                        int K, int N) {
  const long long n_all = static_cast<long long>(G) * K * N;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n_all; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e % K);
    const long long gn = e / K;
    const int n = static_cast<int>(gn % N);
    const long long g = gn / N;
    uint32_t hi, lo;
    tf32_split(w[(g * K + k) * N + n], hi, lo);
    out[e] = hi;
    out[n_all + e] = lo;
  }
}

// ---- 1. the implicit GEMM ------------------------------------------------

template <int KC, int BN>
__global__ void __launch_bounds__(288, 1)
conv2d_f32_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,  // (MB,T,F,Cin)
                        const __grid_constant__ CUtensorMap w_map,  // (2G,N,Cin)
                        const float* __restrict__ bias,  // (members, N) or null
                        float* __restrict__ y,           // (MB, T, F, N)
                        int B, int T, int F, int Cin, int N, int kt, int kf,
                        int lo_t, int lo_f, int W, int rows, int halo_stride,
                        int hstages, int members) {
  constexpr int ROWB = KC * 4;              // bytes of a staged row (swizzle)
  constexpr int W_TILE = BN * ROWB;         // one tap's hi (or lo) weights
  constexpr int TPS = f32_taps_per_stage(KC, BN);
  constexpr int W_STRIDE = align1024(2 * TPS * W_TILE);
  constexpr int KSTEPS = KC / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* halo = smem;
  uint8_t* wbuf = halo + hstages * halo_stride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wbuf + kF32WStages * W_STRIDE);
  uint64_t* halo_full = bars;
  uint64_t* halo_empty = bars + kF32MaxHalo;
  uint64_t* b_full = bars + 2 * kF32MaxHalo;
  uint64_t* b_empty = b_full + kF32WStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int P = rows * W;                   // a tile: rows x W pixels
  const int tiles_t = (T + rows - 1) / rows;
  const int f_tiles = (F + W - 1) / W;
  const int per_clip = tiles_t * f_tiles;
  const int n_tiles = (N + BN - 1) / BN;
  // walked by the grid in turn: B clips of each of the members
  const int tiles = members * B * per_clip * n_tiles;
  const int kk = kt * kf;
  const int G = members * kk;               // lo weights start at row G
  const int HF = W + kf - 1;
  const int HR = rows + kt - 1;
  const int k_slices = (Cin + KC - 1) / KC;
  // a pixel tile's clip b and first frame and frequency
  auto tile_origin = [&](int mt, int& b, int& t0, int& f0) {
    b = mt / per_clip;
    const int r = mt - b * per_clip;
    const int ti = r / f_tiles;
    t0 = ti * rows;
    f0 = (r - ti * f_tiles) * W;
  };

  if (tid == 0) {
    for (int i = 0; i < hstages; ++i) {
      mbar_init(&halo_full[i], 1);
      mbar_init(&halo_empty[i], 8);         // one arrival per consumer warp
    }
    for (int i = 0; i < kF32WStages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warp: lane 0 starts the halo copies, lane 1 the
    // weights' (hi and lo of each tap), each as far ahead as its ring
    // allows
    if (tid == 256) {
      int hc = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, t0, f0;
        tile_origin(tile / n_tiles, b, t0, f0);
        for (int ks = 0; ks < k_slices; ++ks, ++hc) {
          const int hs = hc % hstages;
          mbar_wait(&halo_empty[hs], ((hc / hstages) & 1) ^ 1);
          mbar_expect_tx(&halo_full[hs], HR * HF * ROWB);
          tma_load_4d(halo + hs * halo_stride, &x_map, &halo_full[hs],
                      ks * KC, f0 - lo_f, t0 - lo_t, b);
        }
      }
    } else if (tid == 257) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN;
        const int w_row = (tile / n_tiles / per_clip / B) * kk;  // member
        for (int ks = 0; ks < k_slices; ++ks) {
          for (int tap0 = 0; tap0 < kk; tap0 += TPS, ++it) {
            const int bs = it % kF32WStages;
            const int nt = min(TPS, kk - tap0);
            mbar_wait(&b_empty[bs], ((it / kF32WStages) & 1) ^ 1);
            mbar_expect_tx(&b_full[bs], nt * 2 * W_TILE);
            for (int u = 0; u < nt; ++u) {
              uint8_t* dst = wbuf + bs * W_STRIDE + u * 2 * W_TILE;
              tma_load_3d(dst, &w_map, &b_full[bs], ks * KC, n0,
                          w_row + tap0 + u);
              tma_load_3d(dst + W_TILE, &w_map, &b_full[bs], ks * KC, n0,
                          G + w_row + tap0 + u);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64);
    // this thread's fragment rows are pixels ma and ma + 8, at frame r and
    // frequency f of the tile; a row past P computes the tile's last
    // pixel and stores nothing
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int ma = 64 * wg + 16 * warp + g;
    const int mb = ma + 8;
    const uint32_t wmagic = wg_div_magic(W);
    // the frame of a fragment row in the tile (the last pixel's past P)
    auto frame = [&](int m) {
      return static_cast<int>((min(m, P - 1) * wmagic) >> 16);
    };
    // the rows' halo rows at tap (0, 0): (p / W) HF + p % W
    const int ha = min(ma, P - 1) + frame(ma) * (kf - 1);
    const int hb = min(mb, P - 1) + frame(mb) * (kf - 1);
    float acc[BN / 2];    // the f32 register sum
    // the tensor cores' sums of one K slice: two, the even and the odd k8
    // steps apart (shorter runs), where the registers hold them
    constexpr int PARTS = BN <= 64 ? 2 : 1;
    float part[PARTS][BN / 2];
    uint32_t ahi[2][4], alo[2][4];
    int it = 0;           // weight stages consumed
    int hc = 0;           // halo tiles consumed
    int to_release = -1;  // a weight stage whose last products are in flight

    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&b_empty[stage]);
    };
    // one k8 step of a tap: A at channels 8 s .. 8 s + 7 of the tap's
    // shifted pixel rows, split into a[SET] (the step two back has
    // finished with them), then hi*lo, lo*hi, hi*hi; once the step before
    // is done, release its stage if it was that stage's last
    auto k_step = [&](auto set_tag, const uint8_t* hstage, int rowa,
                      int rowb, int s, uint32_t whi, int fresh,
                      int stage_done) {
      constexpr int SET = decltype(set_tag)::value;
      const int c = (8 * s + tq) * 4;
      const float v0 = lds_f32(hstage + swz<ROWB>(rowa * ROWB + c));
      const float v1 = lds_f32(hstage + swz<ROWB>(rowb * ROWB + c));
      const float v2 = lds_f32(hstage + swz<ROWB>(rowa * ROWB + c + 16));
      const float v3 = lds_f32(hstage + swz<ROWB>(rowb * ROWB + c + 16));
      tf32_split_act(v0, ahi[SET][0], alo[SET][0]);
      tf32_split_act(v1, ahi[SET][1], alo[SET][1]);
      tf32_split_act(v2, ahi[SET][2], alo[SET][2]);
      tf32_split_act(v3, ahi[SET][3], alo[SET][3]);
      const uint64_t dhi = gmma_desc(whi + s * 32, 16, 8 * ROWB,
                                     swizzle_layout<ROWB>());
      const uint64_t dlo = gmma_desc(whi + W_TILE + s * 32, 16, 8 * ROWB,
                                     swizzle_layout<ROWB>());
      wgmma_fence();
      wgmma_tf32<BN>(part[SET % PARTS], ahi[SET], dlo, fresh ? 0 : 1);
      wgmma_tf32<BN>(part[SET % PARTS], alo[SET], dhi, 1);
      wgmma_tf32<BN>(part[SET % PARTS], ahi[SET], dhi, 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (to_release >= 0) release(to_release);
      to_release = stage_done;
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < k_slices; ++ks, ++hc) {
        const int hs = hc % hstages;
        const uint8_t* hstage = halo + hs * halo_stride;
        mbar_wait(&halo_full[hs], (hc / hstages) & 1);
        int fresh = 1;
        for (int tap0 = 0; tap0 < kk; tap0 += TPS, ++it) {
          const int bs = it % kF32WStages;
          const int nt = min(TPS, kk - tap0);
          mbar_wait(&b_full[bs], (it / kF32WStages) & 1);
          const uint32_t wbase = smem_u32(wbuf + bs * W_STRIDE);
          for (int u = 0; u < nt; ++u) {
            const int tap = tap0 + u;
            const int dt = tap / kf;
            const int df = tap - dt * kf;
            const int rowa = ha + dt * HF + df;
            const int rowb = hb + dt * HF + df;
            const uint32_t whi = wbase + u * 2 * W_TILE;
            const int done = u == nt - 1 ? bs : -1;
#pragma unroll
            for (int s = 0; s < KSTEPS; s += 2) {
              k_step(std::integral_constant<int, 0>{}, hstage, rowa, rowb, s,
                     whi, fresh, -1);
              k_step(std::integral_constant<int, 1>{}, hstage, rowa, rowb,
                     s + 1, whi, PARTS == 2 ? fresh : 0,
                     s + 2 == KSTEPS ? done : -1);
              fresh = 0;
            }
          }
        }
        // the slice's run ends: its sum joins the register sum
        wgmma_wait<0>();
#pragma unroll
        for (int q = 0; q < PARTS; ++q) fence_regs(part[q]);
        if (to_release >= 0) release(to_release);
        to_release = -1;
        __syncwarp();
        if (lane == 0) mbar_arrive(&halo_empty[hs]);
#pragma unroll
        for (int q = 0; q < PARTS; ++q)
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[q][i];
      }

      // ---- epilogue: + bias, float2 stores of rows ma and ma + 8 where
      // they are pixels of the tile inside the clip (the tile's origin
      // found only now: nothing of it stays live through the K loop)
      const int mt = tile / n_tiles;
      const int n0 = (tile - mt * n_tiles) * BN;
      int b, t0, f0;
      tile_origin(mt, b, t0, f0);
      const int member = b / B;
      const int ra = frame(ma), fa = min(ma, P - 1) - ra * W;
      const int rb = frame(mb), fb = min(mb, P - 1) - rb * W;
      const int ta = t0 + ra;
      const int tb = t0 + rb;
      const bool in_a = ma < P && ta < T && f0 + fa < F;
      const bool in_b = mb < P && tb < T && f0 + fb < F;
      float* ya =
          y + ((static_cast<long long>(b) * T + ta) * F + f0 + fa) * N;
      float* yb =
          y + ((static_cast<long long>(b) * T + tb) * F + f0 + fb) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * tq;
        if (n >= N) continue;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          b0 = __ldg(bias + member * N + n);
          b1 = __ldg(bias + member * N + n + 1);
        }
        if (in_a)
          *reinterpret_cast<float2*>(ya + n) =
              make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
        if (in_b)
          *reinterpret_cast<float2*>(yb + n) =
              make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
    }
  }
}

// ---- 2. the weight gradient's partials ----------------------------------

template <int XC, int BN>
__global__ void __launch_bounds__(416, 1)
conv2d_f32_dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,   // (B,T,F,Cin), SUBC box
    const __grid_constant__ CUtensorMap gy_map,  // (B,T,F,Cout), BN box
    float* __restrict__ partial,                 // (chunks, kk, Cin, Cout)
    int T, int F, int Cin, int Cout, int kt, int kf, int lo_t, int lo_f,
    int W, int rows, int tiles, int tiles_per_chunk, int ci_tiles,
    int co_tiles, int sub_stride, int stages) {
  constexpr int SUBC = XC < 32 ? XC : 32;   // channels of a halo sub-tile
  constexpr int SW = SUBC * 4;              // its row bytes (swizzle)
  constexpr int NSUB = XC / SUBC;
  constexpr int GROW = BN * 4;              // bytes of a staged gy row
  constexpr int G_BYTES = kWgTileM * GROW;
  constexpr int GT_BYTES = 4 * BN * 128;    // gy^T hi (or lo): 4 k blocks
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_stride = NSUB * sub_stride + align1024(G_BYTES);
  uint8_t* gyt = smem + stages * stage_stride;  // [2 buffers][hi, lo]
  uint64_t* full = reinterpret_cast<uint64_t*>(gyt + 4 * GT_BYTES);
  uint64_t* empty = full + kF32DwMaxStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int P = rows * W;                   // a tile: rows x W pixels
  const int tiles_t = (T + rows - 1) / rows;
  const int f_tiles = (F + W - 1) / W;
  const int kk = kt * kf;
  const int HF = W + kf - 1;
  const int HR = rows + kt - 1;
  const int ci0 = (blockIdx.x % ci_tiles) * XC;
  const int co0 = ((blockIdx.x / ci_tiles) % co_tiles) * BN;
  const int tap0 = (blockIdx.x / (ci_tiles * co_tiles)) * 9;
  const int ntaps = min(9, kk - tap0);
  const int chunk = blockIdx.y;
  const int tile_begin = min(tiles, chunk * tiles_per_chunk);
  const int tile_end = min(tiles, tile_begin + tiles_per_chunk);
  // a tile's clip b and first frame and frequency
  auto tile_origin = [&](int tile, int& b, int& t0, int& f0) {
    b = tile / (tiles_t * f_tiles);
    const int r = tile - b * tiles_t * f_tiles;
    const int ti = r / f_tiles;
    t0 = ti * rows;
    f0 = (r - ti * f_tiles) * W;
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 12);             // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 3) {
    if (tid == 384) {
      for (int tile = tile_begin, it = 0; tile < tile_end; ++tile, ++it) {
        const int s = it % stages;
        int b, t0, f0;
        tile_origin(tile, b, t0, f0);
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], NSUB * HR * HF * SW + P * GROW);
        uint8_t* stage = smem + s * stage_stride;
        for (int u = 0; u < NSUB; ++u)
          tma_load_4d(stage + u * sub_stride, &x_map, &full[s],
                      ci0 + u * SUBC, f0 - lo_f, t0 - lo_t, b);
        tma_load_4d(stage + NSUB * sub_stride, &gy_map, &full[s], co0, f0,
                    t0, b);
      }
    }
  } else {
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int tq = lane & 3;
    // this warp's A rows are input channels ci0 + 16 warp + (0 .. 15):
    // staged when 16 warp < XC, else zeros (Cin below 64)
    const bool staged = 16 * warp < XC;
    const int sub = staged ? 16 * warp / SUBC : 0;
    const int cs = (16 * warp) % SUBC + g;
    // taps 3 wg .. 3 wg + 2 of this block's group; a warpgroup with fewer
    // (nq < 3) computes the group's first tap in their place and stores
    // nothing of it, so no wgmma sits in a branch
    const int nq = max(0, min(3, ntaps - 3 * wg));
    int toff[3];   // a tap's shift in halo rows
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int tap = q < nq ? tap0 + 3 * wg + q : tap0;
      toff[q] = (tap / kf) * HF + tap % kf;
    }
    float acc[3][BN / 2];
    float part[BN / 2];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[q][i] = 0.f;
    uint32_t ahi[2][4], alo[2][4];
    // the k8 steps that cover the tile's P pixels, an even count (steps
    // run in pairs): the pixels past P add exact zeros, A's values there
    // and B's rows (gy^T below) both 0
    const int k_steps = (P + 15) / 16 * 2;
    const uint32_t wmagic = wg_div_magic(W);

    // one k8 step (pixels 8 s .. 8 s + 7) of tap q, split into a[SET]
    // (the step two back has finished with them)
    auto k_step = [&](auto set_tag, int q, int s, const uint8_t* xs,
                      uint32_t bhi, uint32_t blo) {
      constexpr int SET = decltype(set_tag)::value;
      const int pa = 8 * s + tq;
      const int pb = pa + 4;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      // pixel p's halo row at tap (0, 0): (p / W) HF + p % W = p + (p /
      // W) (kf - 1)
      if (staged && pa < P) {
        const int row = pa + static_cast<int>((pa * wmagic) >> 16) *
                                 (kf - 1) + toff[q];
        v0 = lds_f32(xs + swz<SW>(row * SW + cs * 4));
        v1 = lds_f32(xs + swz<SW>(row * SW + cs * 4 + 32));
      }
      if (staged && pb < P) {
        const int row = pb + static_cast<int>((pb * wmagic) >> 16) *
                                 (kf - 1) + toff[q];
        v2 = lds_f32(xs + swz<SW>(row * SW + cs * 4));
        v3 = lds_f32(xs + swz<SW>(row * SW + cs * 4 + 32));
      }
      tf32_split_act(v0, ahi[SET][0], alo[SET][0]);
      tf32_split_act(v1, ahi[SET][1], alo[SET][1]);
      tf32_split_act(v2, ahi[SET][2], alo[SET][2]);
      tf32_split_act(v3, ahi[SET][3], alo[SET][3]);
      const uint32_t koff = (s >> 2) * BN * 128 + (s & 3) * 32;
      const uint64_t dhi = gmma_desc(bhi + koff, 16, 1024, 1);
      const uint64_t dlo = gmma_desc(blo + koff, 16, 1024, 1);
      wgmma_fence();
      wgmma_tf32<BN>(part, ahi[SET], dlo, s == 0 ? 0 : 1);
      wgmma_tf32<BN>(part, alo[SET], dhi, 1);
      wgmma_tf32<BN>(part, ahi[SET], dhi, 1);
      wgmma_commit();
      wgmma_wait<1>();
    };

    for (int tile = tile_begin, it = 0; tile < tile_end; ++tile, ++it) {
      const int s = it % stages;
      uint8_t* stage = smem + s * stage_stride;
      mbar_wait(&full[s], (it / stages) & 1);
      // gy's hi and lo, transposed to (k block of 32 pixels, co, pixel)
      // in the 128-byte swizzle, into buffer it & 1: every warpgroup has
      // finished tile it - 2, which read it, before the barrier of tile
      // it - 1. The stage's rows past P, which this tile's copy did not
      // write (an earlier tile's pixels or never written), become zeros
      const uint8_t* graw = stage + NSUB * sub_stride;
      uint8_t* ghi = gyt + (it & 1) * 2 * GT_BYTES;
      uint8_t* glo = ghi + GT_BYTES;
      for (int e = tid; e < kWgTileM * (BN / 4); e += 384) {
        const int p = e % kWgTileM;
        const int quad = e / kWgTileM;
        const float4 v =
            p < P ? *reinterpret_cast<const float4*>(
                        graw + swz<GROW>(p * GROW + quad * 16))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int co = 4 * quad + i;
          const uint32_t off =
              (p >> 5) * BN * 128 + swz<128>(co * 128 + (p & 31) * 4);
          uint32_t hi, lo;
          tf32_split_act(vs[i], hi, lo);
          *reinterpret_cast<uint32_t*>(ghi + off) = hi;
          *reinterpret_cast<uint32_t*>(glo + off) = lo;
        }
      }
      fence_proxy_async();
      consumer_sync(384);
      const uint8_t* xs = stage + sub * sub_stride;
      const uint32_t bhi = smem_u32(ghi);
      const uint32_t blo = smem_u32(glo);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
#pragma unroll 1
        for (int k = 0; k < k_steps; k += 2) {
          k_step(std::integral_constant<int, 0>{}, q, k, xs, bhi, blo);
          k_step(std::integral_constant<int, 1>{}, q, k + 1, xs, bhi, blo);
        }
        // the tap's run over this tile ends: its sum joins the register
        // sum
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[q][i] += part[i];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // ---- epilogue: this chunk's f32 partials, rows ci < Cin, cols < Cout;
    // a warp past the block's XC channels (Cin below 64, or a plan's
    // narrower slice) computed zeros and stores nothing: its rows are
    // another block's channels
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (q >= nq || !staged) continue;
      const int tap = tap0 + 3 * wg + q;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int co = co0 + 8 * j + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = ci0 + 16 * warp + g + 8 * h;
          if (ci < Cin && co < Cout)
            *reinterpret_cast<float2*>(
                partial +
                ((static_cast<long long>(chunk) * kk + tap) * Cin + ci) *
                    Cout + co) =
                make_float2(acc[q][4 * j + 2 * h], acc[q][4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

inline int f32_kc(int Cin) { return Cin <= 16 ? 16 : 32; }
// 128 at most: the register sum and the slice's sum of an m64 x 128 tile
// are 128 registers a thread
inline int f32_bn(int N) {
  return N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
}
inline int f32_dw_xc(int Cin) { return Cin <= 16 ? 16 : Cin <= 32 ? 32 : 64; }
// 32 at most: three taps' register sums, a tap's tensor-core sum and two
// sets of split A fragments fit the 152 registers of a 13-warp block
inline int f32_dw_bn(int Cout) { return Cout <= 16 ? 16 : 32; }

// shared memory of the forward kernel with ``hstages`` halo tiles of kc
// channels at a tile of rows x W pixels
inline int conv2d_f32_wgmma_smem(int W, int rows, int kc, int N, int kt,
                                 int kf, int hstages) {
  const int bn = f32_bn(N);
  return 1024 + hstages * align1024(halo_bytes(W, kt, kf, 4 * kc, rows)) +
         kF32WStages * align1024(2 * f32_taps_per_stage(kc, bn) * bn * kc * 4) +
         2 * (kF32MaxHalo + kF32WStages) * 8;
}

// the dw pass's, x in slices of xc channels (sub-tiles of 32 at most)
inline int conv2d_f32_dw_wgmma_smem(int W, int rows, int xc, int Cout, int kt,
                                    int kf, int stages) {
  const int subc = xc < 32 ? xc : 32;
  const int bn = f32_dw_bn(Cout);
  return 1024 +
         stages * ((xc / subc) *
                       align1024(halo_bytes(W, kt, kf, 4 * subc, rows)) +
                   align1024(kWgTileM * bn * 4)) +
         16 * bn * 128 + 2 * kF32DwMaxStages * 8;
}

// The forward-type GEMM (x with Cin channels -> N): Cin and N >= 16 and
// multiples of 4 (TMA's rows are 16-byte multiples; the wrappers pad
// other counts, ops/kernels/conv.py:_f32_channels). The tile as the bf16
// pair picks it (wg_plan): rows = 128 / W whole frames of W = min(F, 128)
// frequencies, narrower only where the halo ring would not fit; K slices
// of 32 channels (16 at Cin = 16, or where 32 fit no tile); up to 4 halo
// stages, one block an SM. width = 0 where no tile fits.
inline WgPlan conv2d_f32_wgmma_plan(int F, int Cin, int N, int kt, int kf) {
  if (F < 1 || Cin < 16 || Cin % 4 != 0 || N < 16 || N % 4 != 0)
    return {0, 0, 0, 0, 0};
  return wg_plan(F, kt, kf, f32_kc(Cin), kF32MaxHalo, kWgMaxSmem,
                 [&](int w, int rows, int kc, int s) {
                   return conv2d_f32_wgmma_smem(w, rows, kc, N, kt, kf, s);
                 });
}

// The dw pass: Cin and Cout >= 16, multiples of 4; x in slices of 64
// input channels (32, 16 at Cin <= 32, or where the wider fit no tile);
// up to 6 (x halo, gy) stages.
inline WgPlan conv2d_f32_dw_wgmma_plan(int F, int Cin, int Cout, int kt,
                                       int kf) {
  if (F < 1 || Cin < 16 || Cin % 4 != 0 || Cout < 16 || Cout % 4 != 0)
    return {0, 0, 0, 0, 0};
  return wg_plan(F, kt, kf, f32_dw_xc(Cin), kF32DwMaxStages, kWgMaxSmem,
                 [&](int w, int rows, int xc, int s) {
                   return conv2d_f32_dw_wgmma_smem(w, rows, xc, Cout, kt, kf,
                                                   s);
                 });
}

// whether the forward-type GEMM (x with Cin channels -> N channels) runs
// the 3xTF32 kernel, and the dw pass the dw one
inline bool conv2d_f32_wgmma_ok(int F, int Cin, int N, int kt, int kf) {
  return conv2d_f32_wgmma_plan(F, Cin, N, kt, kf).width > 0;
}

inline bool conv2d_f32_dw_wgmma_ok(int F, int Cin, int Cout, int kt,
                                   int kf) {
  return conv2d_f32_dw_wgmma_plan(F, Cin, Cout, kt, kf).width > 0;
}

// hi and lo of w (G, K, N) into ``split`` (2, G, N, K)
inline cudaError_t conv2d_f32_split(const float* w, void* split, int G, int K,
                                    int N, cudaStream_t s) {
  const long long n = static_cast<long long>(G) * K * N;
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  conv2d_f32_split_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      w, static_cast<uint32_t*>(split), G, K, N);
  return cudaGetLastError();
}

template <int KC, int BN>
cudaError_t conv2d_f32_wgmma_launch(const float* x, const void* split,
                                    const float* b, float* y, int members,
                                    int B, int T, int F, int Cin, int N,
                                    int kt, int kf, int lo_t, int lo_f,
                                    const WgPlan& plan, cudaStream_t stream) {
  const int W = plan.width;
  const int rows = plan.rows;
  CUtensorMap x_map, w_map;
  cudaError_t err = act_map(&x_map, x, members * B, T, F, Cin, KC,
                            W + kf - 1, rows + kt - 1, 4);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Cin),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(2 * members * kt * kf)};
  const cuuint64_t strides[2] = {4ull * Cin, 4ull * Cin * N};
  const cuuint32_t box[3] = {KC, BN, 1};
  err = make_map(&w_map, split, 3, dims, strides, box, KC * 4,
                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  auto kernel = conv2d_f32_wgmma_kernel<KC, BN>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  // persistent blocks, one an SM (the rings fill its shared memory)
  const long long tiles = static_cast<long long>(members) * B *
                          ((T + rows - 1) / rows) * ((F + W - 1) / W) *
                          ((N + BN - 1) / BN);
  const long long blocks = std::min<long long>(tiles, sms);
  kernel<<<static_cast<unsigned>(blocks), 288, plan.smem, stream>>>(
      x_map, w_map, b, y, B, T, F, Cin, N, kt, kf, lo_t, lo_f, W, rows,
      align1024(halo_bytes(W, kt, kf, 4 * KC, rows)), plan.stages, members);
  return cudaGetLastError();
}

template <int KC>
cudaError_t conv2d_f32_wgmma_bn(const float* x, const void* split,
                                const float* b, float* y, int members, int B,
                                int T, int F, int Cin, int N, int kt, int kf,
                                int lo_t, int lo_f, const WgPlan& plan,
                                cudaStream_t s) {
  switch (f32_bn(N)) {
    case 16:
      return conv2d_f32_wgmma_launch<KC, 16>(x, split, b, y, members, B, T,
                                             F, Cin, N, kt, kf, lo_t, lo_f,
                                             plan, s);
    case 32:
      return conv2d_f32_wgmma_launch<KC, 32>(x, split, b, y, members, B, T,
                                             F, Cin, N, kt, kf, lo_t, lo_f,
                                             plan, s);
    case 64:
      return conv2d_f32_wgmma_launch<KC, 64>(x, split, b, y, members, B, T,
                                             F, Cin, N, kt, kf, lo_t, lo_f,
                                             plan, s);
    default:
      return conv2d_f32_wgmma_launch<KC, 128>(x, split, b, y, members, B, T,
                                              F, Cin, N, kt, kf, lo_t, lo_f,
                                              plan, s);
  }
}

// the forward-type GEMM on the 3xTF32 kernel: w (members kt kf, Cin, N)
// is split into ``split`` (2 members kt kf N Cin f32) first; x (members,
// B, T, F, Cin), b (members, N) or null, y (members, B, T, F, N)
inline cudaError_t conv2d_f32_wgmma(const float* x, const float* w,
                                    void* split, const float* b, float* y,
                                    int members, int B, int T, int F,
                                    int Cin, int N, int kt, int kf, int lo_t,
                                    int lo_f, cudaStream_t s) {
  const WgPlan plan = conv2d_f32_wgmma_plan(F, Cin, N, kt, kf);
  if (plan.width == 0) return cudaErrorInvalidValue;
  cudaError_t err = conv2d_f32_split(w, split, members * kt * kf, Cin, N, s);
  if (err != cudaSuccess) return err;
  if (plan.kc == 16)
    return conv2d_f32_wgmma_bn<16>(x, split, b, y, members, B, T, F, Cin, N,
                                   kt, kf, lo_t, lo_f, plan, s);
  return conv2d_f32_wgmma_bn<32>(x, split, b, y, members, B, T, F, Cin, N,
                                 kt, kf, lo_t, lo_f, plan, s);
}

// pixel chunks of the 3xTF32 dw pass: one wave of blocks (one an SM) over
// the (input channel, output channel, tap group) tiles
inline int conv2d_f32_dw_wgmma_chunks(int B, int T, int F, int Cin, int Cout,
                                      int kt, int kf, int sms) {
  const WgPlan plan = conv2d_f32_dw_wgmma_plan(F, Cin, Cout, kt, kf);
  if (plan.width == 0) return 1;
  const int per_chunk = ((Cin + plan.kc - 1) / plan.kc) *
                        ((Cout + f32_dw_bn(Cout) - 1) / f32_dw_bn(Cout)) *
                        ((kt * kf + 8) / 9);
  const long long tiles = static_cast<long long>(B) *
                          ((T + plan.rows - 1) / plan.rows) *
                          ((F + plan.width - 1) / plan.width);
  long long chunks = sms / per_chunk;
  if (chunks > tiles) chunks = tiles;
  return chunks < 1 ? 1 : static_cast<int>(chunks);
}

template <int XC, int BN>
cudaError_t conv2d_f32_dw_wgmma_launch(const float* x, const float* gy,
                                       float* ws, int B, int T, int F,
                                       int Cin, int Cout, int kt, int kf,
                                       int lo_t, int lo_f, int chunks,
                                       const WgPlan& plan, cudaStream_t s) {
  constexpr int SUBC = XC < 32 ? XC : 32;
  const int W = plan.width;
  const int rows = plan.rows;
  CUtensorMap x_map, gy_map;
  cudaError_t err = act_map(&x_map, x, B, T, F, Cin, SUBC, W + kf - 1,
                            rows + kt - 1, 4);
  if (err != cudaSuccess) return err;
  err = act_map(&gy_map, gy, B, T, F, Cout, BN, W, rows, 4);
  if (err != cudaSuccess) return err;
  auto kernel = conv2d_f32_dw_wgmma_kernel<XC, BN>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.smem);
  if (err != cudaSuccess) return err;
  const int tiles = B * ((T + rows - 1) / rows) * ((F + W - 1) / W);
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const int ci_tiles = (Cin + XC - 1) / XC;
  const int co_tiles = (Cout + BN - 1) / BN;
  const dim3 grid(ci_tiles * co_tiles * ((kt * kf + 8) / 9), chunks);
  kernel<<<grid, 416, plan.smem, s>>>(
      x_map, gy_map, ws, T, F, Cin, Cout, kt, kf, lo_t, lo_f, W, rows, tiles,
      per_chunk, ci_tiles, co_tiles,
      align1024(halo_bytes(W, kt, kf, 4 * SUBC, rows)), plan.stages);
  return cudaGetLastError();
}

template <int XC>
cudaError_t conv2d_f32_dw_wgmma_bn(const float* x, const float* gy, float* ws,
                                   int B, int T, int F, int Cin, int Cout,
                                   int kt, int kf, int lo_t, int lo_f,
                                   int chunks, const WgPlan& plan,
                                   cudaStream_t s) {
  if (f32_dw_bn(Cout) == 16)
    return conv2d_f32_dw_wgmma_launch<XC, 16>(x, gy, ws, B, T, F, Cin, Cout,
                                              kt, kf, lo_t, lo_f, chunks,
                                              plan, s);
  return conv2d_f32_dw_wgmma_launch<XC, 32>(x, gy, ws, B, T, F, Cin, Cout,
                                            kt, kf, lo_t, lo_f, chunks, plan,
                                            s);
}

// the dw partials on the 3xTF32 kernel into ws (chunks, kt kf, Cin, Cout)
inline cudaError_t conv2d_f32_dw_wgmma(const float* x, const float* gy,
                                       float* ws, int B, int T, int F,
                                       int Cin, int Cout, int kt, int kf,
                                       int lo_t, int lo_f, int chunks,
                                       cudaStream_t s) {
  const WgPlan plan = conv2d_f32_dw_wgmma_plan(F, Cin, Cout, kt, kf);
  switch (plan.kc) {
    case 16:
      return conv2d_f32_dw_wgmma_bn<16>(x, gy, ws, B, T, F, Cin, Cout, kt,
                                        kf, lo_t, lo_f, chunks, plan, s);
    case 32:
      return conv2d_f32_dw_wgmma_bn<32>(x, gy, ws, B, T, F, Cin, Cout, kt,
                                        kf, lo_t, lo_f, chunks, plan, s);
    case 64:
      return conv2d_f32_dw_wgmma_bn<64>(x, gy, ws, B, T, F, Cin, Cout, kt,
                                        kf, lo_t, lo_f, chunks, plan, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
