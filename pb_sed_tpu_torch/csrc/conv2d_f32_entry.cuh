// The f32 conv's entry layer on Hopper: every forward-type GEMM and every
// weight gradient of a compute_dtype='float32' layer with fewer than 16
// input channels (the log-mel input, Cin = 1, and the tag-conditioned
// BiCRNN's 1 + 10 channels), on 3xTF32 tensor-core products, at any F, any
// kernel extent (XLA's SAME pads) and any member count.
//
// 1. conv2d_f32_entry_kernel, the forward-type GEMM:
//
//      y[p, n] = sum_{dt, df, c} x[p + (dt - lo_t, df - lo_f), c]
//                * w[dt, df, c, n] + bias[n]
//
//    It runs the forward of a layer with Cin < 16 (C = Cin input channels,
//    N = Cout), and the backward's dx of such a layer: the same GEMM on gy
//    (C = Cout) with the flipped, transposed weights and the pads mirrored
//    (N = Cin = 1 or 11), and the dx of a layer with Cout < 16 (C = Cout,
//    N = Cin).
//
// 2. conv2d_f32_dw_entry_kernel, the weight gradient's partials:
//
//      dw[(tap, c), co] = sum_p x[p + shift(tap), c] * gy[p, co]
//
//    one GEMM with M = Cout (gy^T), N = the packed (tap, c) rows and K =
//    pixels, cut into pixel chunks; each chunk writes its own slot of the
//    workspace (chunks, K, Cout) and conv2d_f32.cu's reduce adds the
//    chunks in chunk order, so dw is bit-identical between runs.
//
// Replaces: no Pallas site. The JAX package convolves a compute_dtype=
// 'float32' tower with lax.conv_general_dilated on f32 operands and
// differentiates it with XLA (pb_sed_tpu/ops/cnn.py:115-119); these are
// the port's kernels for that layer where it has fewer than 16 input
// channels, and for the dx of a layer with fewer than 16 output channels
// (a GEMM from Cout < 16 channels), which conv2d_f32_wgmma.cuh's 3xTF32
// pair takes only padded.
//
// What bounds it on the H100: bytes. At B = 32, T = 500, F = 128 each pass
// moves (Cin + Cout) * 4 bytes a pixel: 0.042 ms at shallow L0 (1 -> 16),
// 0.081 at deep L0 (1 -> 32), 0.066 at the BiCRNN's (11 -> 16), where the
// BiCRNN's 2 * 99 * 16 f32 products a pixel take 0.039 ms as 3xTF32 (three
// TF32 products each at 495 TFLOP/s) and 0.097 ms on FFMA (67 TFLOP/s).
//
// What the design does about it (after conv2d_entry.cuh, the bf16 pair):
//
// - The taps and channels are packed into ONE K, k = (dt * kf + df) * C +
//   c, padded once to a multiple of 16 (not per tap): 9 -> 16 at Cin = 1,
//   99 -> 112 at Cin = 11, 144 and 288 for the dx of a 16- and a
//   32-channel layer. Element (p, k) of the implicit im2col matrix is
//   halo[base(p) + off(k)], two tables in shared memory (off -1 past K: a
//   zero, whatever the halo holds).
// - A tile is `rows` frames x `width` frequencies of one clip (rows *
//   width a multiple of 16): whole frequency rows at any F, or, where a
//   wide gy's halo (the dx of a 32-channel layer) would leave too few
//   blocks an SM, windows of 64, 32 or 16. Each block copies the tile's
//   halo (rows + kt - 1 frame rows of width + kf - 1 columns) with cp.async
//   straight into a stage of a two-stage ring, so the next tile loads
//   while this one computes; the copies zero-fill frames and columns
//   outside the clip (the SAME halo; with whole rows the pad columns are
//   zeroed once). Persistent blocks walk the tiles of all members; a tile
//   lies in one clip of one member, so its sums do not depend on M or B:
//   one member-axis launch equals M single launches in every bit.
// - 3xTF32: each f32 operand v is split into hi = tf32(v) (cvt.rna) and lo
//   = tf32(v - hi), and a product taken as hi*lo + lo*hi + hi*hi, the small
//   terms first (lo*lo dropped). The weights are split once a call
//   (conv2d_f32_entry_split_kernel) into the image the kernel copies to
//   shared memory: n-major, a row of 2 Kp + 16 floats (conflict-free
//   16-byte loads), each float4 a lane's {hi, hi, lo, lo} of its two k; at
//   N <= 8 only the N rows that are not zero. The activations (the A
//   fragments, and both operands of the dw) are split in registers.
// - mma.sync m16n8k8 .tf32, N padded to 8 (not 16: the dx at N = 1 wastes
//   7 of 8 columns, not 15 of 16). The tensor cores' f32 accumulate
//   truncates (conv2d_f32_wgmma.cuh), so a run of products is short: each
//   k8 step's three products start from zero and join an f32 register sum
//   with one round-to-nearest FADD an element. The runs of consecutive k8
//   steps and of the n8 tiles are independent chains, issued interleaved
//   (a chain of three dependent mma.sync alone would leave a warp waiting
//   on each product's latency).
// - k is permuted within a k8 step where C % 8 == 0 (the dx): a lane's A
//   registers (t, t + 4) take staged k (2t, 2t + 1), one aligned 8-byte
//   load a row, with the weights' rows permuted alike; the halo's pixels
//   are then C + 8 floats apart, so that the eight rows of a fragment fall
//   in distinct banks. Elsewhere (Cin = 1, 11) each A register is one
//   4-byte load.
// - The output columns are permuted (the weights' columns with them) so
//   that a lane ends with 4 consecutive channels of each 16 (2 at N <= 8)
//   of each of its two pixels: float4 / float2 stores straight from
//   registers, + the f32 bias, a quad's stores of a row side by side.
// - The dw pass: a block of 8 warps owns up to 128 packed rows x 16 or 32
//   output channels and one chunk of tiles of whole frequency rows; each
//   tile's x halo and gy rows (gy padded to 24 or 40 floats a pixel:
//   conflict-free fragment loads) stream through a 3-stage cp.async ring,
//   once for all its rows: up to 64 rows are one group of warps' (half the
//   warps each where there are two), each warp taking every eighth (or
//   fourth) 8-pixel step and keeping every (co, row) sum of its group in
//   registers; at the end each group's warps' sums are added in warp order
//   through shared memory into the chunk's slot.
#pragma once

#include "conv2d_f32_wgmma.cuh"

namespace {

constexpr int kF32eThreads = 128;     // the forward: 4 warps, an m16 tile each
constexpr int kF32eDwThreads = 256;   // the dw pass: 8 warps
constexpr int kF32eFwdStages = 2;
constexpr int kF32eDwStages = 3;
constexpr int kF32eFwdPixels = 1024;  // a forward tile aims at this many
constexpr int kF32eDwPixels = 256;    // a dw tile
// shared memory a block stays under where it can: four forward blocks an
// SM, two dw blocks (228 KB an SM, 1 KB of it reserved a block)
constexpr int kF32eFwdCap = 56 * 1024;
constexpr int kF32eDwCap = 112 * 1024;

__host__ __device__ inline int f32e_round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// A tile in shared memory: `rows` output frames x `width` frequencies
// (whole rows where width == F; the dw pass pads its pixels to `kpix`, a
// multiple of 16, the forward takes rows * width a multiple of 16); the
// halo's (rows + kt - 1) frame rows of
// `rs` floats, `cs` floats a pixel, its first column (frequency f0 - lo_f)
// at `lead` (the interior starts 16-byte aligned); a stage of `stage`
// floats; the packed K and its padding to 16; how a halo row is copied
// (`copy`: 0 whole rows in copies of `cb` bytes, 1 a pixel's C floats in
// 16-byte units to its slot of cs, 2 float by float); pair loads (C % 8
// == 0, the forward-type GEMM only).
struct F32EntryGeom {
  int rows, width, pixels, kpix, cs, lead, rs, stage, K, Kp, copy, cb,
      pairs;
};

inline F32EntryGeom f32e_geom(int F, int C, int kt, int kf, int lo_f,
                              int rows, int width, bool dw) {
  F32EntryGeom g;
  g.rows = rows;
  g.width = width;
  g.pixels = rows * width;
  g.kpix = f32e_round_up(g.pixels, 16);
  g.pairs = !dw && C % 8 == 0;
  g.cs = g.pairs ? C + 8 : C;
  const int interior = f32e_round_up(lo_f * g.cs, 4);
  g.lead = interior - lo_f * g.cs;
  int rs = f32e_round_up(interior + (width + kf - 1 - lo_f) * g.cs, 4);
  // rows 16 (forward) or 8 (dw) banks apart: a fragment's taps in
  // distinct banks at Cin = 1
  rs += ((dw ? 8 : 16) - rs % 32 + 32) % 32;
  g.rs = rs;
  g.stage = f32e_round_up((rows + kt - 1) * rs, 32);
  g.K = kt * kf * C;
  g.Kp = f32e_round_up(g.K, 16);
  g.copy = g.pairs ? 1 : width == F ? 0 : 2;
  const int row_bytes = F * C * 4;
  g.cb = g.copy == 1 ? 16
         : g.copy == 2 ? 4
         : row_bytes % 16 == 0 ? 16
         : row_bytes % 8 == 0 ? 8
                               : 4;
  return g;
}

// the weights' image: columns padded to 8 (N <= 8) or 16, computed in
// chunks of NB = 8, 16 or 32 columns; rows of 2 Kp + 16 floats; of which
// the kernel keeps the N rows that are not zero at N <= 8
__host__ __device__ inline int f32e_npad(int N) {
  return N <= 8 ? 8 : f32e_round_up(N, 16);
}
__host__ __device__ inline int f32e_wrows(int N) {
  return N <= 8 ? N : f32e_npad(N);
}
inline int f32e_nb(int N) {
  return N <= 8 ? 8 : f32e_npad(N) % 32 == 0 ? 32 : 16;
}
__host__ __device__ inline int f32e_ldb(int Kp) { return 2 * Kp + 16; }

// the ring, the weights, the off, base and output-pixel tables
inline int f32e_fwd_smem(const F32EntryGeom& g, int N) {
  return 4 * (kF32eFwdStages * g.stage + f32e_wrows(N) * f32e_ldb(g.Kp) +
              g.Kp + 2 * g.pixels);
}

inline int f32e_dw_mt(int Cout) {
  return Cout > 16 && f32e_round_up(Cout, 16) % 32 == 0 ? 2 : 1;
}

// packed rows (n8 tiles) a dw block owns: 2, 4 or 8, and 4 at most with
// 32 output channels (8 runs of 4 registers a step)
inline int f32e_dw_nt(int K, int Cout) {
  const int n8 = (K + 7) / 8;
  return n8 <= 2 ? 2 : n8 <= 4 || f32e_dw_mt(Cout) == 2 ? 4 : 8;
}

// floats of a dw stage: the x halo, then the gy rows at 16 MT + 8 floats
// a pixel
inline int f32e_dw_stage(const F32EntryGeom& g, int Cout) {
  return g.stage + f32e_round_up(g.kpix * (16 * f32e_dw_mt(Cout) + 8), 32);
}

inline int f32e_dw_smem(const F32EntryGeom& g, int Cout) {
  const int red = kF32eDwThreads / 32 * f32e_dw_nt(g.K, Cout) * 8 * 16 *
                  f32e_dw_mt(Cout);
  return 4 * (std::max(kF32eDwStages * f32e_dw_stage(g, Cout), red) +
              g.kpix);
}

// the frames a tile of `width` frequencies steps by: rows * width must be
// a multiple of 16
inline int f32e_row_step(int width) {
  int a = width, b = 16;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return 16 / a;
}

// The tile of a pass: whole frequency rows (the dw pass always), else
// windows of 64, 32 or 16 frequencies, the widest whose tile stays under
// the cap at one row step (one frame for the dw pass); then as many frames
// as reach the pass's target pixels while the shared memory stays under
// the cap (one row step at least).
inline F32EntryGeom f32e_pick(int F, int C, int N, int kt, int kf, int lo_f,
                              bool dw) {
  const int target = dw ? kF32eDwPixels : kF32eFwdPixels;
  const int cap = dw ? kF32eDwCap : kF32eFwdCap;
  auto smem = [&](const F32EntryGeom& g) {
    return dw ? f32e_dw_smem(g, N) : f32e_fwd_smem(g, N);
  };
  const int widths[4] = {F, 64, 32, 16};
  F32EntryGeom g{};
  for (int i = 0; i < (dw ? 1 : 4); ++i) {
    const int width = widths[i];
    if (i > 0 && width >= F) continue;
    const int step = dw ? 1 : f32e_row_step(width);
    int rows = step * std::max(1, (target + step * width - 1) /
                                      (step * width));
    g = f32e_geom(F, C, kt, kf, lo_f, rows, width, dw);
    while (rows > step && smem(g) > cap) {
      rows -= step;
      g = f32e_geom(F, C, kt, kf, lo_f, rows, width, dw);
    }
    if (smem(g) <= cap) break;
  }
  return g;
}

inline bool f32e_takes(int F, int C, int N, int kt, int kf) {
  return C >= 1 && N >= 1 && F >= 1 && F < (1 << 15) && kt >= 1 &&
         kf >= 1 && static_cast<long long>(F) * C * 4 < (1LL << 30) &&
         static_cast<long long>(kt) * kf * C < (1 << 20);
}

// whether the forward-type GEMM (x with C channels -> N, pads lo_f before
// the frequencies) fits the entry kernel; the caller routes Cin < 16 to it
inline bool conv2d_f32_entry_ok(int F, int C, int N, int kt, int kf,
                                int lo_f) {
  return f32e_takes(F, C, N, kt, kf) &&
         f32e_fwd_smem(f32e_pick(F, C, N, kt, kf, lo_f, false), N) <=
             kWgMaxSmem;
}

inline bool conv2d_f32_dw_entry_ok(int F, int Cin, int Cout, int kt,
                                   int kf) {
  return f32e_takes(F, Cin, Cout, kt, kf) &&
         f32e_dw_smem(f32e_pick(F, Cin, Cout, kt, kf, (kf - 1) / 2, true),
                      Cout) <= kWgMaxSmem;
}

// ---- device helpers -----------------------------------------------------

// one copy of `bytes` (16, 8 or 4) from global to shared memory, zeros
// where !valid (cp.async's zero fill)
__device__ __forceinline__ void f32e_copy(void* dst, const void* src,
                                          int bytes, bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void f32e_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void f32e_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d = a (16 x 8, tf32) * b (8 x 8, tf32), a fresh f32 sum
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// d += a * b
__device__ __forceinline__ void mma_tf32_next(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a tile's halo to the stage `st`: the hrows frame rows from t0 -
// lo_t of `clip`, frames outside the clip zero-filled; with whole rows
// (copy 0) each row's F * C floats to the interior (the pad columns were
// zeroed once), else the columns f0 - lo_f .. f0 - lo_f + width + kf - 2,
// those outside the clip zero-filled, a pixel's C floats in 16-byte units
// to its slot of cs floats (copy 1) or float by float (copy 2)
template <int THREADS>
__device__ __forceinline__ void f32e_copy_halo(float* st,
                                               const F32EntryGeom& g,
                                               const float* __restrict__ x,
                                               long long clip, int t0,
                                               int f0, int hrows, int kf,
                                               int lo_t, int lo_f, int T,
                                               int F, int C) {
  if (g.copy == 0) {
    // each row's F * C floats to the interior
    const int units = F * C * 4 / g.cb;
    for (int hr = 0; hr < hrows; ++hr) {
      const int t = t0 - lo_t + hr;
      const bool in = t >= 0 && t < T;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(
          x + (clip * T + (in ? t : 0)) * F * C);
      uint8_t* dst =
          reinterpret_cast<uint8_t*>(st + hr * g.rs + g.lead + lo_f * g.cs);
      for (int u = threadIdx.x; u < units; u += THREADS)
        f32e_copy(dst + u * g.cb, src + u * g.cb, g.cb, in);
    }
    return;
  }
  // a thread a halo pixel: its C floats in 16-byte units (copy 1) or one
  // by one (copy 2)
  const int ncols = g.width + kf - 1;
  const int step = g.copy == 1 ? 4 : 1;
  for (int i = threadIdx.x; i < hrows * ncols; i += THREADS) {
    const int hr = i / ncols;
    const int col = i - hr * ncols;
    const int t = t0 - lo_t + hr;
    const int f = f0 - lo_f + col;
    const bool in = t >= 0 && t < T && f >= 0 && f < F;
    const float* src = x + ((clip * T + (in ? t : 0)) * F + (in ? f : 0)) * C;
    float* dst = st + hr * g.rs + g.lead + col * g.cs;
    for (int e = 0; e < C; e += step)
      f32e_copy(dst + e, src + e, 4 * step, in);
  }
}

// ---- the weights' split -------------------------------------------------

// w (G, K, N) f32 (K = kt kf C, packed) -> the image (G, npad, ldb): the
// row of mma column `col` (chunks of nb columns, lane t of a quad ending
// with channels 2 J t .. 2 J t + 2 J - 1 of its chunk, J = nb / 8) holds,
// per k8 step s and quad lane t, the float4 {hi(ka), hi(kb), lo(ka),
// lo(kb)} of the staged k that the lane's B registers take: ka = 8 s + 2 t,
// kb = ka + 1 with pair loads, else ka = 8 s + t, kb = ka + 4; zero past
// K, past N and in the row's 16 padding floats
__global__ void conv2d_f32_entry_split_kernel(const float* __restrict__ w,
                                              float4* __restrict__ out,
                                              int G, int K, int N, int npad,
                                              int Kp, int nb, int pairs) {
  const int q4 = f32e_ldb(Kp) / 4;  // float4s a row
  const long long total = static_cast<long long>(G) * npad * q4;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(e % q4);
    const long long rest = e / q4;
    const int col = static_cast<int>(rest % npad);
    const long long gi = rest / npad;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    const int r = col % nb;
    const int t8 = (r % 8) / 2;  // the quad lane that ends with column r
    const int n = col - r + (r & 1) +
                  (nb == 8 ? 2 * t8 : 16 * (r / 16) + 4 * t8 + 2 * (r / 8 % 2));
    if (q < Kp / 2 && n < N) {
      const int s = q / 4;
      const int t = q % 4;
      const int ka = pairs ? 8 * s + 2 * t : 8 * s + t;
      const int kb = pairs ? ka + 1 : ka + 4;
      uint32_t hi, lo;
      if (ka < K) {
        tf32_split(w[(gi * K + ka) * N + n], hi, lo);
        v.x = __uint_as_float(hi);
        v.z = __uint_as_float(lo);
      }
      if (kb < K) {
        tf32_split(w[(gi * K + kb) * N + n], hi, lo);
        v.y = __uint_as_float(hi);
        v.w = __uint_as_float(lo);
      }
    }
    out[e] = v;
  }
}

// ---- 1. the forward-type GEMM -------------------------------------------

// E (2 or 4) consecutive output floats of one pixel: a float2 / float4
// store where `vec`, else those below n_valid one by one
template <int E>
__device__ __forceinline__ void f32e_store(float* dst, const float (&v)[E],
                                           int n_valid, bool vec) {
  if (vec) {
    if constexpr (E == 2)
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < n_valid) dst[e] = v[e];
  }
}

template <int NB, bool PAIRS>
__global__ void __launch_bounds__(kF32eThreads, 4)
conv2d_f32_entry_kernel(const float* __restrict__ x,      // (M,B,T,F,C)
                        const float4* __restrict__ image,  // (M,npad,ldb)
                        const float* __restrict__ bias,   // (M, N) or null
                        float* __restrict__ y,            // (M,B,T,F,N)
                        int B, int T, int F, int C, int N, int kt, int kf,
                        int lo_t, int lo_f, F32EntryGeom g, int members) {
  constexpr int J = NB / 8;
  constexpr int H = J <= 2 ? 2 : 1;  // k8 steps an iteration (Kp % 16 == 0)
  constexpr int WARPS = kF32eThreads / 32;
  extern __shared__ __align__(128) uint8_t smem[];
  const int npad = f32e_npad(N);
  const int wrows = f32e_wrows(N);
  const int ldb = f32e_ldb(g.Kp);
  float* ring = reinterpret_cast<float*>(smem);
  float* wt = ring + kF32eFwdStages * g.stage;
  int* off = reinterpret_cast<int*>(wt + wrows * ldb);
  int* base = off + g.Kp;
  int* outp = base + g.pixels;  // a tile pixel's (row << 16) | column

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // the fragment's row group
  const int tq = lane & 3;   // its lane in the quad
  const int hrows = g.rows + kt - 1;
  const int W = g.width;

  for (int i = tid * 4; i < kF32eFwdStages * g.stage; i += kF32eThreads * 4)
    *reinterpret_cast<float4*>(ring + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = tid; k < g.Kp; k += kF32eThreads) {
    int v = -1;
    if (k < g.K) {
      const int tap = k / C;
      v = (tap / kf) * g.rs + (tap % kf) * g.cs + (k - tap * C);
    }
    off[k] = v;
  }
  for (int p = tid; p < g.pixels; p += kF32eThreads) {
    const int r = p / W;
    base[p] = r * g.rs + g.lead + (p - r * W) * g.cs;
    outp[p] = (r << 16) | (p - r * W);
  }
  __syncthreads();  // the zeros land before any copy

  const int wpr = (F + W - 1) / W;                // windows a frame row
  const int tpc = (T + g.rows - 1) / g.rows * wpr;  // tiles a clip
  const long long tiles = static_cast<long long>(members) * B * tpc;
  auto stage = [&](long long tile, int buf) {
    const long long clip = tile / tpc;
    const int rem = static_cast<int>(tile - clip * tpc);
    const int tr = rem / wpr;
    f32e_copy_halo<kF32eThreads>(ring + buf * g.stage, g, x, clip,
                                 tr * g.rows, (rem - tr * wpr) * W, hrows,
                                 kf, lo_t, lo_f, T, F, C);
  };
  if (blockIdx.x < tiles) stage(blockIdx.x, 0);
  f32e_commit();

  const int m16 = g.pixels / 16;
  const int nchunks = npad / NB;
  const int ksteps = g.Kp / 8;
  // N % 4 == 0 (N % 2 == 0 for 2-channel lanes): a lane's channels of a
  // chunk whole inside N are aligned vectors
  const bool vec_n = J == 1 ? N % 2 == 0 : N % 4 == 0;
  int member = -1;
  for (long long it = 0;; ++it) {
    const long long tile = blockIdx.x + it * gridDim.x;
    if (tile >= tiles) break;
    const long long clip = tile / tpc;
    const int rem = static_cast<int>(tile - clip * tpc);
    const int tr = rem / wpr;
    const int t0 = tr * g.rows;
    const int f0 = (rem - tr * wpr) * W;
    const int m = static_cast<int>(clip / B);
    f32e_wait<0>();
    __syncthreads();  // this tile landed; every warp is done with the last
    if (m != member) {
      // this member's weights: the image's first wrows rows
      const float4* src =
          image + static_cast<long long>(m) * npad * ldb / 4;
      for (int i = tid; i < wrows * ldb / 4; i += kF32eThreads)
        reinterpret_cast<float4*>(wt)[i] = src[i];
      member = m;
      __syncthreads();
    }
    // the next tile, into the stage the last one freed
    if (tile + gridDim.x < tiles)
      stage(tile + gridDim.x, static_cast<int>((it + 1) & 1));
    f32e_commit();

    const float* hs = ring + static_cast<int>(it & 1) * g.stage;
    const float* bm = bias == nullptr ? nullptr : bias + m * N;
    float* yclip = y + clip * T * static_cast<long long>(F) * N;
    for (int mt = warp; mt < m16; mt += WARPS) {
      const int b0 = base[mt * 16 + gq];
      const int b1 = base[mt * 16 + gq + 8];
      for (int nc = 0; nc < nchunks; ++nc) {
        // this lane's weight rows (column gq of each n8 tile) and quad slot
        int wr[J];
        bool wok[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int row = nc * NB + 8 * j + gq;
          wok[j] = row < wrows;
          wr[j] = (wok[j] ? row : 0) * ldb + 4 * tq;
        }
        float acc[J][4];
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
        for (int ks = 0; ks < ksteps; ks += H) {
          uint32_t ahi[H][4], alo[H][4];
          float4 bw[H][J];
#pragma unroll
          for (int h = 0; h < H; ++h) {
            const int kk = 8 * (ks + h);
            float v[4];
            if constexpr (PAIRS) {
              // staged k (2t, 2t + 1) of rows g and g + 8: mma k (t, t + 4)
              const int o = off[kk + 2 * tq];
              float2 lo = make_float2(0.f, 0.f), hi = lo;
              if (o >= 0) {
                lo = *reinterpret_cast<const float2*>(hs + b0 + o);
                hi = *reinterpret_cast<const float2*>(hs + b1 + o);
              }
              v[0] = lo.x;
              v[1] = hi.x;
              v[2] = lo.y;
              v[3] = hi.y;
            } else {
              const int o0 = off[kk + tq];
              const int o4 = off[kk + tq + 4];
              v[0] = o0 < 0 ? 0.f : hs[b0 + o0];
              v[1] = o0 < 0 ? 0.f : hs[b1 + o0];
              v[2] = o4 < 0 ? 0.f : hs[b0 + o4];
              v[3] = o4 < 0 ? 0.f : hs[b1 + o4];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
              tf32_split_act(v[r], ahi[h][r], alo[h][r]);
#pragma unroll
            for (int j = 0; j < J; ++j)
              bw[h][j] = wok[j] ? *reinterpret_cast<const float4*>(
                                      wt + wr[j] + 2 * kk)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          // each (step, n8 tile) a run: hi*lo, lo*hi, hi*hi from zero,
          // the runs' products interleaved, then one rounding each, in
          // step order
          float d[H][J][4];
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int j = 0; j < J; ++j)
              mma_tf32_first(d[h][j], ahi[h], __float_as_uint(bw[h][j].z),
                             __float_as_uint(bw[h][j].w));
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int j = 0; j < J; ++j)
              mma_tf32_next(d[h][j], alo[h], __float_as_uint(bw[h][j].x),
                            __float_as_uint(bw[h][j].y));
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int j = 0; j < J; ++j)
              mma_tf32_next(d[h][j], ahi[h], __float_as_uint(bw[h][j].x),
                            __float_as_uint(bw[h][j].y));
#pragma unroll
          for (int h = 0; h < H; ++h)
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[j][r] += d[h][j][r];
        }
        // epilogue, + bias: lane t's channels of the chunk, 2t, 2t + 1
        // (J = 1) or 4t .. 4t + 3 of each 16 (tiles 2q, 2q + 1), of rows g
        // and g + 8: the quad's 16-byte stores of a row side by side
        constexpr int Q = J == 1 ? 1 : J / 2;
        constexpr int E = J == 1 ? 2 : 4;
        int pix[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = outp[mt * 16 + gq + 8 * half];
          const int t = t0 + (o >> 16);
          const int f = f0 + (o & 0xffff);
          pix[half] = t < T && f < F ? t * F + f : -1;
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int n0 = nc * NB + 16 * q + E * tq;
          const int n_valid = N - n0;
          if (n_valid <= 0) continue;
          float lo[E], hi[E];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int j = J == 1 ? 0 : 2 * q + e / 2;
            const int n = n0 + e;
            const float bv = bm != nullptr && n < N ? __ldg(bm + n) : 0.f;
            lo[e] = acc[j][e % 2] + bv;
            hi[e] = acc[j][2 + e % 2] + bv;
          }
          const bool vec = vec_n && n_valid >= E;
#pragma unroll
          for (int half = 0; half < 2; ++half)
            if (pix[half] >= 0)
              f32e_store<E>(
                  yclip + static_cast<long long>(pix[half]) * N + n0,
                  half ? hi : lo, n_valid, vec);
        }
      }
    }
  }
  f32e_wait<0>();
}

// ---- 2. the weight gradient ---------------------------------------------

template <int NT, int MT>
__global__ void __launch_bounds__(kF32eDwThreads, 2)
conv2d_f32_dw_entry_kernel(const float* __restrict__ x,   // (B,T,F,Cin)
                           const float* __restrict__ gy,  // (B,T,F,Cout)
                           float* __restrict__ ws,  // (chunks, K, Cout)
                           int B, int T, int F, int Cin, int Cout, int kt,
                           int kf, int lo_t, int lo_f, F32EntryGeom g,
                           int per_chunk, int kblocks) {
  constexpr int CB = 16 * MT;  // output channels a block
  constexpr int S = CB + 8;    // floats a staged gy pixel
  // k8 steps (8 pixels each) a warp's iteration: two where its tiles give
  // only one or two runs a step
  constexpr int H = NT * MT <= 2 ? 2 : 1;
  constexpr int WARPS = kF32eDwThreads / 32;
  extern __shared__ __align__(128) uint8_t smem[];
  const int stage_floats = g.stage + f32e_round_up(g.kpix * S, 32);
  float* ring = reinterpret_cast<float*>(smem);
  int* base = reinterpret_cast<int*>(
      ring + max(kF32eDwStages * stage_floats, WARPS * NT * 8 * CB));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int hrows = g.rows + kt - 1;
  // the block's groups of NT n8 tiles of packed rows: 2 kb and 2 kb + 1,
  // each taken by half the warps where there are two
  const int n8 = (g.K + 7) / 8;
  const int groups = (n8 + NT - 1) / NT;
  const int kb = blockIdx.x % kblocks;
  const int co0 = (blockIdx.x / kblocks) * CB;
  const int here = min(2, groups - 2 * kb);  // groups in this block
  const int wn = WARPS / here;               // warps a group
  const int grp = warp / wn;
  const int j0 = (2 * kb + grp) * NT;        // this warp's first n8 tile

  for (int i = tid * 4; i < kF32eDwStages * stage_floats;
       i += kF32eDwThreads * 4)
    *reinterpret_cast<float4*>(ring + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  // the tile's pixels, then those padding it to a multiple of 16 (their
  // gy rows stay zero: they add nothing)
  for (int p = tid; p < g.kpix; p += kF32eDwThreads)
    base[p] = p < g.pixels ? (p / F) * g.rs + g.lead + (p % F) * Cin : 0;
  // this lane's packed row in each n8 tile (column gq of the B fragment;
  // a row past K reads the pixel's first element, into sums never stored)
  int offk[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k = 8 * (j0 + j) + gq;
    const int tap = k / Cin;
    offk[j] = k < g.K ? (tap / kf) * g.rs + (tap % kf) * Cin + (k - tap * Cin)
                      : 0;
  }
  __syncthreads();  // the zeros land before any copy

  const int tpc = (T + g.rows - 1) / g.rows;
  const int tiles = B * tpc;
  const int t_begin = blockIdx.y * per_chunk;
  const int t_end = min(tiles, t_begin + per_chunk);
  const bool quads = Cout % 4 == 0;  // gy in 16-byte units, else floats

  // stage tile `tile`: the x halo, then gy's channels co0 .. co0 + CB of
  // its pixels (frames past T and channels past Cout zero-filled)
  auto stage_tile = [&](int tile, float* st) {
    const int clip = tile / tpc;
    const int t0 = (tile - clip * tpc) * g.rows;
    f32e_copy_halo<kF32eDwThreads>(st, g, x, clip, t0, 0, hrows, kf, lo_t,
                                   lo_f, T, F, Cin);
    for (int r = 0; r < g.rows; ++r) {
      const bool t_in = t0 + r < T;
      const float* src = gy + (static_cast<long long>(clip) * T +
                               (t_in ? t0 + r : 0)) * F * Cout;
      float* gs = st + g.stage + r * F * S;
      if (quads) {
        for (int i = tid; i < F * (CB / 4); i += kF32eDwThreads) {
          const int f = i / (CB / 4);
          const int co = co0 + 4 * (i % (CB / 4));
          const bool in = t_in && co < Cout;
          f32e_copy(gs + f * S + co - co0, src + (in ? f * Cout + co : 0),
                    16, in);
        }
      } else {
        for (int i = tid; i < F * CB; i += kF32eDwThreads) {
          const int f = i / CB;
          const int co = co0 + i % CB;
          const bool in = t_in && co < Cout;
          f32e_copy(gs + f * S + co - co0, src + (in ? f * Cout + co : 0),
                    4, in);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kF32eDwStages - 1; ++s) {
    if (t_begin + s < t_end)
      stage_tile(t_begin + s, ring + s * stage_floats);
    f32e_commit();
  }

  float acc[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][mt][r] = 0.f;

  const int steps = g.kpix / (8 * H);  // a group's iterations a tile
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int it = tile - t_begin;
    const float* st = ring + (it % kF32eDwStages) * stage_floats;
    f32e_wait<kF32eDwStages - 2>();
    __syncthreads();
    if (tile + kF32eDwStages - 1 < t_end)
      stage_tile(tile + kF32eDwStages - 1,
                 ring + ((it + kF32eDwStages - 1) % kF32eDwStages) *
                            stage_floats);
    f32e_commit();

    const float* gs = st + g.stage;
    for (int s = warp - grp * wn; s < steps; s += wn) {
      uint32_t ahi[H][MT][4], alo[H][MT][4];
      uint32_t bhi[H][NT][2], blo[H][NT][2];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        // A = gy^T: rows co, k = pixels p and p + 4
        const int p = 8 * (H * s + h) + tq;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* ga = gs + p * S + 16 * mt + gq;
          tf32_split_act(ga[0], ahi[h][mt][0], alo[h][mt][0]);
          tf32_split_act(ga[8], ahi[h][mt][1], alo[h][mt][1]);
          tf32_split_act(ga[4 * S], ahi[h][mt][2], alo[h][mt][2]);
          tf32_split_act(ga[4 * S + 8], ahi[h][mt][3], alo[h][mt][3]);
        }
        // B = the x halo: k = the same pixels, column gq = packed row
        const int pb0 = base[p];
        const int pb1 = base[p + 4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          tf32_split_act(st[pb0 + offk[j]], bhi[h][j][0], blo[h][j][0]);
          tf32_split_act(st[pb1 + offk[j]], bhi[h][j][1], blo[h][j][1]);
        }
      }
      // each (step, row tile, co tile) a run: hi*lo, lo*hi, hi*hi from
      // zero, the runs' products interleaved, then one rounding each, in
      // step order
      float d[H][NT][MT][4];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32_first(d[h][j][mt], ahi[h][mt], blo[h][j][0],
                           blo[h][j][1]);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32_next(d[h][j][mt], alo[h][mt], bhi[h][j][0],
                          bhi[h][j][1]);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma_tf32_next(d[h][j][mt], ahi[h][mt], bhi[h][j][0],
                          bhi[h][j][1]);
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[j][mt][r] += d[h][j][mt][r];
    }
  }
  f32e_wait<0>();
  __syncthreads();

  // each group's warps' sums, added in warp order: red[warp][row][co]
  float* red = ring;
  constexpr int ROWS8 = NT * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int co = 16 * mt + gq;
      const int r = 8 * j + 2 * tq;
      float* dst = red + warp * ROWS8 * CB;
      dst[r * CB + co] = acc[j][mt][0];
      dst[(r + 1) * CB + co] = acc[j][mt][1];
      dst[r * CB + co + 8] = acc[j][mt][2];
      dst[(r + 1) * CB + co + 8] = acc[j][mt][3];
    }
  __syncthreads();
  float* slot = ws + static_cast<long long>(blockIdx.y) * g.K * Cout;
  for (int e = tid; e < here * ROWS8 * CB; e += kF32eDwThreads) {
    const int gi = e / (ROWS8 * CB);
    const int rem = e - gi * (ROWS8 * CB);
    const int k = 8 * (2 * kb + gi) * NT + rem / CB;
    const int co = co0 + rem % CB;
    if (k >= g.K || co >= Cout) continue;
    const float* src = red + gi * wn * ROWS8 * CB + rem;
    float v = src[0];
    for (int wi = 1; wi < wn; ++wi) v += src[wi * ROWS8 * CB];
    slot[static_cast<long long>(k) * Cout + co] = v;
  }
}

// ---- host side ----------------------------------------------------------

// floats of the weights' split image for `members` members
inline long long conv2d_f32_entry_split_floats(int C, int N, int kt, int kf,
                                               int members) {
  return static_cast<long long>(members) * f32e_npad(N) *
         f32e_ldb(f32e_round_up(kt * kf * C, 16));
}

template <int NB, bool PAIRS>
cudaError_t conv2d_f32_entry_launch(const float* x, const void* image,
                                    const float* b, float* y, int members,
                                    int B, int T, int F, int C, int N,
                                    int kt, int kf, int lo_t, int lo_f,
                                    cudaStream_t stream) {
  const F32EntryGeom g = f32e_pick(F, C, N, kt, kf, lo_f, false);
  const int smem = f32e_fwd_smem(g, N);
  auto kernel = conv2d_f32_entry_kernel<NB, PAIRS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kF32eThreads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(members) * B *
                          ((T + g.rows - 1) / g.rows) *
                          ((F + g.width - 1) / g.width);
  const long long blocks = std::min<long long>(
      tiles, static_cast<long long>(std::max(per_sm, 1)) * sms);
  kernel<<<static_cast<unsigned>(blocks), kF32eThreads, smem, stream>>>(
      x, static_cast<const float4*>(image), b, y, B, T, F, C, N, kt, kf,
      lo_t, lo_f, g, members);
  return cudaGetLastError();
}

template <int NB>
cudaError_t conv2d_f32_entry_pairs(const float* x, const void* image,
                                   const float* b, float* y, int members,
                                   int B, int T, int F, int C, int N, int kt,
                                   int kf, int lo_t, int lo_f,
                                   cudaStream_t s) {
  if (C % 8 == 0)
    return conv2d_f32_entry_launch<NB, true>(x, image, b, y, members, B, T,
                                             F, C, N, kt, kf, lo_t, lo_f, s);
  return conv2d_f32_entry_launch<NB, false>(x, image, b, y, members, B, T,
                                            F, C, N, kt, kf, lo_t, lo_f, s);
}

// the forward-type GEMM on the entry kernel (conv2d_f32_entry_ok): w
// (members, kt, kf, C, N) is split into ``split``
// (conv2d_f32_entry_split_floats) first; x (members, B, T, F, C), b
// (members, N) or null, y (members, B, T, F, N)
inline cudaError_t conv2d_f32_entry(const float* x, const float* w,
                                    void* split, const float* b, float* y,
                                    int members, int B, int T, int F, int C,
                                    int N, int kt, int kf, int lo_t,
                                    int lo_f, cudaStream_t s) {
  const int K = kt * kf * C;
  const int Kp = f32e_round_up(K, 16);
  const int npad = f32e_npad(N);
  const long long n4 = static_cast<long long>(members) * npad *
                       (f32e_ldb(Kp) / 4);
  const long long blocks = std::min<long long>((n4 + 255) / 256, 4096);
  conv2d_f32_entry_split_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                                  s>>>(w, static_cast<float4*>(split),
                                       members, K, N, npad, Kp, f32e_nb(N),
                                       C % 8 == 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (f32e_nb(N)) {
    case 8:
      return conv2d_f32_entry_pairs<8>(x, split, b, y, members, B, T, F, C,
                                       N, kt, kf, lo_t, lo_f, s);
    case 16:
      return conv2d_f32_entry_pairs<16>(x, split, b, y, members, B, T, F, C,
                                        N, kt, kf, lo_t, lo_f, s);
    default:
      return conv2d_f32_entry_pairs<32>(x, split, b, y, members, B, T, F, C,
                                        N, kt, kf, lo_t, lo_f, s);
  }
}

// blocks of the dw pass besides its chunks: packed-row groups x channel
// groups
inline int f32e_dw_kblocks(int K, int Cout) {
  const int nt = f32e_dw_nt(K, Cout);
  return (((K + 7) / 8 + nt - 1) / nt + 1) / 2;
}

inline int f32e_dw_blocks_per_chunk(int Cin, int Cout, int kt, int kf) {
  const int K = kt * kf * Cin;
  const int cb = 16 * f32e_dw_mt(Cout);
  return f32e_dw_kblocks(K, Cout) * ((Cout + cb - 1) / cb);
}

// the entry dw pass's pixel chunks: about two blocks an SM
inline int conv2d_f32_dw_entry_chunks(int B, int T, int F, int Cin, int Cout,
                                      int kt, int kf, int sms) {
  const F32EntryGeom g = f32e_pick(F, Cin, Cout, kt, kf, (kf - 1) / 2, true);
  const long long tiles =
      static_cast<long long>(B) * ((T + g.rows - 1) / g.rows);
  long long chunks =
      std::max(1, 2 * sms / f32e_dw_blocks_per_chunk(Cin, Cout, kt, kf));
  if (chunks > tiles) chunks = tiles;
  return chunks < 1 ? 1 : static_cast<int>(chunks);
}

template <int NT, int MT>
cudaError_t conv2d_f32_dw_entry_launch(const float* x, const float* gy,
                                       float* ws, int B, int T, int F,
                                       int Cin, int Cout, int kt, int kf,
                                       int chunks, cudaStream_t s) {
  const int lo_f = (kf - 1) / 2;
  const F32EntryGeom g = f32e_pick(F, Cin, Cout, kt, kf, lo_f, true);
  const int smem = f32e_dw_smem(g, Cout);
  auto kernel = conv2d_f32_dw_entry_kernel<NT, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = B * ((T + g.rows - 1) / g.rows);
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const int kblocks = f32e_dw_kblocks(g.K, Cout);
  // a chunk's blocks side by side: they share its x and gy through L2
  const dim3 grid(kblocks * ((Cout + 16 * MT - 1) / (16 * MT)), chunks);
  kernel<<<grid, kF32eDwThreads, smem, s>>>(x, gy, ws, B, T, F, Cin, Cout,
                                            kt, kf, (kt - 1) / 2, lo_f, g,
                                            per_chunk, kblocks);
  return cudaGetLastError();
}

template <int NT>
cudaError_t conv2d_f32_dw_entry_mt(const float* x, const float* gy,
                                   float* ws, int B, int T, int F, int Cin,
                                   int Cout, int kt, int kf, int chunks,
                                   cudaStream_t s) {
  if constexpr (NT < 8) {
    if (f32e_dw_mt(Cout) == 2)
      return conv2d_f32_dw_entry_launch<NT, 2>(x, gy, ws, B, T, F, Cin, Cout,
                                               kt, kf, chunks, s);
  }
  return conv2d_f32_dw_entry_launch<NT, 1>(x, gy, ws, B, T, F, Cin, Cout, kt,
                                           kf, chunks, s);
}

// the dw partials at Cin < 16 (conv2d_f32_dw_entry_ok) into ws (chunks,
// kt kf Cin, Cout), chunks = conv2d_f32_dw_entry_chunks
inline cudaError_t conv2d_f32_dw_entry(const float* x, const float* gy,
                                       float* ws, int B, int T, int F,
                                       int Cin, int Cout, int kt, int kf,
                                       int chunks, cudaStream_t s) {
  switch (f32e_dw_nt(kt * kf * Cin, Cout)) {
    case 2:
      return conv2d_f32_dw_entry_mt<2>(x, gy, ws, B, T, F, Cin, Cout, kt, kf,
                                       chunks, s);
    case 4:
      return conv2d_f32_dw_entry_mt<4>(x, gy, ws, B, T, F, Cin, Cout, kt, kf,
                                       chunks, s);
    default:
      return conv2d_f32_dw_entry_mt<8>(x, gy, ws, B, T, F, Cin, Cout, kt, kf,
                                       chunks, s);
  }
}

}  // namespace
