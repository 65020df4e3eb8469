// The entry layer's two conv passes on Hopper: every forward-type GEMM and
// every weight gradient whose input has fewer than 16 channels (the log-mel
// input, Cin = 1, and the tag-conditioned BiCRNN's 1 + 10 channels), plain
// and BN+ReLU-fused (AFFINE), at any F, any odd extent and any member count.
//
// 1. conv2d_entry_kernel, the forward:
//
//      y[p, n] = bf16(sum_{dt, df, c} x[p + (dt - ht, df - hf), c]
//                     * w[dt, df, c, n] + bias[n])
//
//    Replaces: pb_sed_tpu/ops/pallas/conv.py:_fwd_kernel at the entry layer
//    (conv2d_packed_fm with Cin padded to the packed buffer's channel
//    count, pb_sed_tpu/ops/cnn.py:74-80), and _fwd_kernel_bn for the fused
//    conv at such a width.
//
//    What bounds it on the H100: bytes. K = kt * kf * Cin is 9 at Cin = 1
//    and 99 at Cin = 11, so a pixel costs 2 * K * N flops against
//    2 * Cin + 2 * N bytes; the output's 16-32 channels are almost all of
//    the traffic (shallow L0: 34 bytes and 288 flops a pixel).
//
//    What the design does about it: the taps and channels are packed into
//    ONE K, k = (dt * kf + df) * cs + c, padded once to a multiple of 16
//    (not per tap): Cin = 1 takes one k16 step a pixel tile, Cin = 11
//    seven. cs is 1 at Cin = 1, else Cin rounded up to 4 (zero channels):
//    every four k of a tap, (k .. k + 3), are then one aligned 8-byte word
//    of the staged tile, and within each k16 step the mma's k order is
//    permuted (the weights' rows with it) so that a lane's two A registers
//    of a row, (2q, 2q + 1) and (2q + 8, 2q + 9), are such a word. A tile
//    is `rows` whole frequency rows of one clip (rows * F a multiple of
//    16). Each block copies the tile's rows + kt - 1 frame rows once, with
//    cp.async (16 bytes where F * Cin % 8 == 0, else 8, 4 or, as plain
//    loads, 2: chosen by alignment), into a ring of 2 raw stages;
//    persistent blocks walk the tiles, and the next tile's rows load while
//    this one computes (a third stage was no faster at Cin = 1 and, at
//    Cin = 11, left room for a smaller tile only: 100 against 91 us on
//    the H100). Frames outside the clip are zero-filled by the copy. One
//    pass then lays the tile out as its halo (rows + kt - 1)
//    x (F + kf - 1) x cs, whose columns outside the image were zeroed once
//    (the SAME halo), applying bnrelu once per in-image element with
//    AFFINE (the zero halo stays 0 whatever the shift). Element (p, k) of
//    the implicit im2col matrix is halo[base(p) + off(k)] with two tables
//    in shared memory (base: per tile pixel, off: per packed k, -1 past
//    K), so a warp builds its mma.sync m16n8k16 A fragments with one
//    64-bit shared load a row (four 16-bit ones at Cin = 1). The
//    weights of the member in use sit in shared memory n-major (a row of
//    K + 8 elements: conflict-free ldmatrix), zero past K, their columns
//    permuted so that lane q of a quad ends with output channels 8q .. 8q
//    + 7 of its pixel (4q .. 4q + 3 for 16-channel chunks). mma.sync and
//    not FFMA: at Cin = 11 a pixel needs 1 584 multiply-adds a 16-channel
//    output, which FFMA would spend ~3x the byte bound on. The epilogue
//    adds the f32 bias in registers, rounds once to bf16 and stores 16
//    bytes a lane straight from registers (16-channel chunks swap half
//    their words with the neighbouring lane first); no staging tile.
//    Members: x (M, B, T, F, Cin), w (M, kt, kf, Cin, N), bias (M, N),
//    scale and shift (M, Cin), y (M, B, T, F, N). The tiles of all members
//    are one sequence; a tile lies in one clip of one member, and the
//    block restages the weights when its member changes. A tile's sums do
//    not depend on M or B: one member-axis launch equals M single launches
//    in every bit.
//
// 2. conv2d_dw_entry_kernel, the weight gradient's f32 partials:
//
//      dw[(tap, c), co] = sum_p x[p + shift(tap), c] * gy[p, co]
//
//    Replaces: the dw half of pb_sed_tpu/ops/pallas/conv.py:_bwd_kernel
//    (and _bwd_kernel_bn) at these widths. One GEMM with M = Cout (gy^T,
//    A fragments by ldmatrix.trans from the staged gy tile), N = the packed
//    (tap, c) rows (the B fragments from the x halo through the same base
//    and off tables, padded to a multiple of 8: 9 -> 16 rows at Cin = 1,
//    99 -> 104 at Cin = 11) and K = pixels. Bound by bytes: it reads x and
//    gy once. A block owns up to 128 packed rows (64 at Cout % 32 == 0) x
//    16 or 32 output channels and one chunk of pixel tiles; each tile's x
//    halo and gy rows stream through a 3-stage cp.async ring, and each warp
//    accumulates every (row, co) product of its pixel steps in registers.
//    At the end the four warps' sums are added in warp order through
//    shared memory and written to the chunk's own slot of the workspace
//    (chunks, K, Cout); conv2d_dw_entry_reduce_kernel adds the chunks, a
//    warp an element, in a fixed order, so dw is bit-identical between
//    runs. AFFINE transforms the x halo in place as above. Measured on the
//    H100 at Cin = 1: the products alone (no copies) take about half the
//    pass, and halving their instructions (pixel pairs as 32-bit words)
//    did not shorten it: the gy stream through the ring is the limit.
#pragma once

#include "conv2d_wgmma.cuh"

namespace {

constexpr int kEntryThreads = 128;    // 4 warps
constexpr int kEntryFwdStages = 2;    // the forward's cp.async ring depth
constexpr int kEntryDwStages = 3;     // the dw pass's
constexpr int kEntryFwdPixels = 1024;  // a forward tile aims at this many
constexpr int kEntryDwPixels = 256;    // a dw tile (its gy tile is wider)

// A tile's shape in shared memory: `rows` output frames of F pixels each
// (rows * F a multiple of 16); the halo's frame rows of `rs` elements, cs
// a pixel, with the first column at `lead` (the interior starts 16-byte
// aligned); the forward's raw frame rows of `raw_rs` elements; the packed
// K (kt * kf * cs) and its k16 steps.
struct EntryGeom {
  int rows, pixels, cs, lead, rs, halo_bytes, raw_rs, raw_bytes, K, ks;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

inline int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// the tile geometry at `rows` frames; the forward (quads) lays a Cin > 1
// out with its channels rounded up to 4, the dw pass as it is
inline EntryGeom entry_geom(int F, int Cin, int kt, int kf, int rows,
                            bool quads) {
  EntryGeom g;
  const int hf = (kf - 1) / 2;
  const int hrows = rows + kt - 1;
  g.rows = rows;
  g.pixels = rows * F;
  g.cs = quads && Cin > 1 ? round_up(Cin, 4) : Cin;
  const int interior = round_up(hf * g.cs, 8);
  g.lead = interior - hf * g.cs;
  g.rs = round_up(interior + (F + hf) * g.cs, 8);
  g.halo_bytes = round_up(hrows * g.rs * 2, 128);
  g.raw_rs = round_up(F * Cin, 8);
  g.raw_bytes = round_up(hrows * g.raw_rs * 2, 128);
  g.K = kt * kf * g.cs;
  g.ks = (g.K + 15) / 16;
  return g;
}

// the frames a tile steps by: rows * F must be a multiple of 16
inline int entry_row_step(int F) { return 16 / gcd_int(F, 16); }

// raw ring, the laid-out halo, the weights, scale and shift, off and base
inline int entry_fwd_smem(const EntryGeom& g, int N) {
  return kEntryFwdStages * g.raw_bytes + g.halo_bytes +
         N * (16 * g.ks + 8) * 2 + 2 * 16 * 4 + 16 * g.ks * 4 +
         g.pixels * 4;
}

inline int entry_dw_mt(int Cout) { return Cout % 32 == 0 ? 2 : 1; }

// packed rows (n8 tiles) a dw block owns: 2, 4, 8, or 16 where its
// accumulators (16 x 16 channels, 64 registers) fit
inline int entry_dw_nt(int K, int Cout) {
  const int n8 = (K + 7) / 8;
  return n8 <= 2 ? 2 : n8 <= 4 ? 4 : n8 <= 8 || entry_dw_mt(Cout) == 2 ? 8
                                                                     : 16;
}

inline int entry_dw_stage(const EntryGeom& g, int Cout) {
  return g.halo_bytes + round_up(g.pixels * (2 * entry_dw_mt(Cout) + 1) * 16,
                                 128);
}

inline int entry_dw_smem(const EntryGeom& g, int Cout) {
  const int red = kEntryThreads / 32 * entry_dw_nt(g.K, Cout) * 8 *
                  entry_dw_mt(Cout) * 16 * 4;
  return std::max(kEntryDwStages * entry_dw_stage(g, Cout), red) +
         g.pixels * 4;
}

// the shared memory a block should stay under: three blocks an SM for the
// forward and for the dw pass at 16 n8 tiles (whose registers allow no
// more), five for the dw pass below that (measured on the H100: larger
// tiles at fewer blocks an SM, and smaller ones, were slower)
inline int entry_smem_cap(int K, int Cout, bool dw) {
  return (dw && entry_dw_nt(K, Cout) < 16 ? 44 : 74) * 1024;
}

// the tile of a pass: as many frames as reach `target` pixels, fewer
// while the shared memory passes entry_smem_cap (one row step at least)
inline EntryGeom entry_pick(int F, int Cin, int Cout, int kt, int kf,
                            bool dw) {
  const int step = entry_row_step(F);
  const int target = dw ? kEntryDwPixels : kEntryFwdPixels;
  int rows = step * std::max(1, (target + step * F - 1) / (step * F));
  EntryGeom g = entry_geom(F, Cin, kt, kf, rows, !dw);
  const int cap = entry_smem_cap(kt * kf * Cin, Cout, dw);
  while (rows > step && (dw ? entry_dw_smem(g, Cout)
                            : entry_fwd_smem(g, Cout)) > cap) {
    rows -= step;
    g = entry_geom(F, Cin, kt, kf, rows, !dw);
  }
  return g;
}

inline bool entry_takes(int F, int Cin, int kt, int kf) {
  return Cin >= 1 && Cin < 16 && F >= 1 && kt >= 1 && kf >= 1 &&
         static_cast<long long>(F) * Cin * 2 < (1 << 30);
}

// whether the forward-type GEMM (x with Cin channels -> N) runs the entry
// kernel: Cin < 16 where its rings and the weights fit
inline bool conv2d_entry_ok(int F, int Cin, int N, int kt, int kf) {
  return entry_takes(F, Cin, kt, kf) && N % 16 == 0 &&
         entry_fwd_smem(entry_pick(F, Cin, N, kt, kf, false), N) <=
             kWgMaxSmem;
}

inline bool conv2d_dw_entry_ok(int F, int Cin, int Cout, int kt, int kf) {
  return entry_takes(F, Cin, kt, kf) && Cout % 16 == 0 &&
         entry_dw_smem(entry_pick(F, Cin, Cout, kt, kf, true), Cout) <=
             kWgMaxSmem;
}

// ---- device helpers -----------------------------------------------------

// one copy of `bytes` (16, 8 or 4) from global to shared memory, zeros
// where !valid (cp.async's zero fill); 2 bytes as a plain load and store
__device__ __forceinline__ void entry_copy(void* dst, const void* src,
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
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    *static_cast<uint16_t*>(dst) =
        valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the widest copy that keeps every frame row's start aligned
__host__ __device__ __forceinline__ int entry_copy_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16
         : row_bytes % 8 == 0 ? 8
         : row_bytes % 4 == 0 ? 4
                              : 2;
}

// Copy the hrows frame rows from t0 - ht of `clip` (member * B + b), F *
// Cin elements each, to dst + hr * row_stride elements; frames outside
// [0, T) zero-filled
__device__ __forceinline__ void entry_copy_rows(
    __nv_bfloat16* dst, int row_stride, const __nv_bfloat16* __restrict__ x,
    long long clip, int t0, int hrows, int ht, int T, int F, int Cin,
    int cb) {
  const int per_row = F * Cin * 2 / cb;
  for (int hr = 0; hr < hrows; ++hr) {
    const int t = t0 - ht + hr;
    const bool in = t >= 0 && t < T;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(
        x + (clip * T + (in ? t : 0)) * F * Cin);
    uint8_t* d = reinterpret_cast<uint8_t*>(dst + hr * row_stride);
    for (int c = threadIdx.x; c < per_row; c += kEntryThreads)
      entry_copy(d + c * cb, src + c * cb, cb, in);
  }
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The mma column (within the whole N) that computes output channel n when
// N is computed in chunks of NB: lane q of a quad then holds channels
// 2 J q .. 2 J q + 2 J - 1 of a chunk (J = NB / 8 n8 tiles), in order
template <int NB>
__device__ __forceinline__ int entry_mma_column(int n) {
  constexpr int J = NB / 8;
  const int r = n % NB;
  return n - r + 8 * ((r >> 1) % J) + 2 * (r / (2 * J)) + (r & 1);
}

// The mma k (within a k16 step) that multiplies staged k `j` with QUADS:
// lane q's registers (2q, 2q + 1) and (2q + 8, 2q + 9) take the staged
// word (4q .. 4q + 3)
__device__ __forceinline__ int entry_mma_k(int k) {
  const int j = k & 15;
  return k - j + 2 * (j >> 2) + (j & 1) + 8 * ((j >> 1) & 1);
}

// A fragment register: the (k, k + 1) pair at elements o0, o1 past `b`,
// zero past K (o < 0)
__device__ __forceinline__ uint32_t entry_pair(const uint16_t* h, int b,
                                               int o0, int o1) {
  return pack2(o0 < 0 ? uint16_t(0) : h[b + o0],
               o1 < 0 ? uint16_t(0) : h[b + o1]);
}

// Both A registers of a row with QUADS: the 8-byte word at element o past
// b, zero past K (o < 0)
__device__ __forceinline__ uint2 entry_quad(const uint16_t* h, int b, int o) {
  return o < 0 ? make_uint2(0u, 0u)
               : *reinterpret_cast<const uint2*>(h + b + o);
}

// bnrelu on both halves of a word, of channels c and c_hi (the high half
// only where `hi`, else 0)
__device__ __forceinline__ uint32_t bnrelu2(uint32_t v, int c, int c_hi,
                                            bool hi, const float* scale,
                                            const float* shift) {
  const uint16_t lo = __bfloat16_as_ushort(bnrelu(
      __ushort_as_bfloat16(static_cast<uint16_t>(v)), scale[c], shift[c]));
  const uint16_t up =
      hi ? __bfloat16_as_ushort(
               bnrelu(__ushort_as_bfloat16(static_cast<uint16_t>(v >> 16)),
                      scale[c_hi], shift[c_hi]))
         : uint16_t(0);
  return pack2(lo, up);
}

// Lay the forward's raw frame rows (raw_rs elements each, F * Cin used)
// out as the halo's interiors, in 32-bit words: a row copy where cs ==
// Cin, else a pixel's Cin channels shifted into place (a funnel shift
// where its first element is odd) with zeros at channels Cin .. cs - 1.
// With AFFINE bnrelu acts on the in-clip frames (from frame t_first on);
// frames outside the clip stay 0, as the copies left them.
template <bool AFFINE>
__device__ __forceinline__ void entry_layout(
    const uint32_t* raw, uint32_t* halo, const EntryGeom& g, int interior,
    int t_first, int hrows, int T, int F, int Cin, const float* scale,
    const float* shift) {
  const int cs = g.cs;
  const int raw_words = g.raw_rs / 2;
  if (cs == Cin) {
    const int n = F * Cin;
    const int words = (n + 1) / 2;
    for (int i = threadIdx.x; i < hrows * words; i += kEntryThreads) {
      const int hr = i / words;
      const int j = i - hr * words;
      uint32_t v = raw[hr * raw_words + j];
      const bool hi = 2 * j + 1 < n;
      if (!hi) v &= 0xffffu;  // past an odd row's last element
      const int t = t_first + hr;
      if (AFFINE && t >= 0 && t < T)
        v = bnrelu2(v, (2 * j) % Cin, (2 * j + 1) % Cin, hi, scale, shift);
      halo[(hr * g.rs + interior) / 2 + j] = v;
    }
    return;
  }
  const int nw = cs / 2;  // <= 8
  for (int i = threadIdx.x; i < hrows * F; i += kEntryThreads) {
    const int hr = i / F;
    const int f = i - hr * F;
    const int e0 = f * Cin;
    const uint32_t* src = raw + hr * raw_words + (e0 >> 1);
    uint32_t* dst = halo + (hr * g.rs + interior + f * cs) / 2;
    const uint32_t sh = (e0 & 1) * 16;
    const int t = t_first + hr;
    const bool act = AFFINE && t >= 0 && t < T;
    uint32_t cur = src[0];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= nw) break;
      // the word past a row's end may be read: its bits land at channels
      // >= Cin, which are zeroed
      const uint32_t nxt = src[q + 1];
      uint32_t v = __funnelshift_r(cur, nxt, sh);
      cur = nxt;
      const int c = 2 * q;
      const bool hi = c + 1 < Cin;
      if (c >= Cin) {
        v = 0u;
      } else {
        if (!hi) v &= 0xffffu;
        if (act) v = bnrelu2(v, c, c + 1, hi, scale, shift);
      }
      dst[q] = v;
    }
  }
}

// ---- 1. the forward -----------------------------------------------------

template <int NB, bool AFFINE, bool QUADS>
__global__ void __launch_bounds__(kEntryThreads, 4)
conv2d_entry_kernel(const __nv_bfloat16* __restrict__ x,  // (M,B,T,F,Cin)
                    const __nv_bfloat16* __restrict__ w,  // (M,kt,kf,Cin,N)
                    const float* __restrict__ bias,       // (M, N) or null
                    const float* __restrict__ scale,      // (M, Cin) AFFINE
                    const float* __restrict__ shift,      // (M, Cin) AFFINE
                    __nv_bfloat16* __restrict__ y,        // (M,B,T,F,N)
                    int B, int T, int F, int Cin, int N, int kt, int kf,
                    EntryGeom g, int members) {
  constexpr int MTW = 2;  // m16 tiles a warp's item
  constexpr int J = NB / 8;
  extern __shared__ __align__(128) uint8_t smem[];
  const int Kp = 16 * g.ks;
  const int ldb = Kp + 8;
  const int cs = g.cs;
  uint8_t* ring = smem;
  __nv_bfloat16* halo =
      reinterpret_cast<__nv_bfloat16*>(smem + kEntryFwdStages * g.raw_bytes);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<uint8_t*>(halo) + g.halo_bytes);
  float* s_scale = reinterpret_cast<float*>(wt + N * ldb);
  float* s_shift = s_scale + 16;
  int* off = reinterpret_cast<int*>(s_shift + 16);
  int* base = off + Kp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // the fragment's row group
  const int tq = lane & 3;   // its lane in the quad
  const int ht = (kt - 1) / 2;
  const int hf = (kf - 1) / 2;
  const int hrows = g.rows + kt - 1;
  const int interior = g.lead + hf * cs;
  const int cb = entry_copy_bytes(F * Cin * 2);

  for (int i = tid * 16; i < g.halo_bytes; i += kEntryThreads * 16)
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(halo) + i) =
        make_uint4(0u, 0u, 0u, 0u);
  for (int k = tid; k < Kp; k += kEntryThreads) {
    int v = -1;
    if (k < g.K) {
      const int tap = k / cs;
      v = (tap / kf) * g.rs + (tap % kf) * cs + (k - tap * cs);
    }
    off[k] = v;
  }
  for (int p = tid; p < g.pixels; p += kEntryThreads)
    base[p] = (p / F) * g.rs + g.lead + (p % F) * cs;

  const int tpc = (T + g.rows - 1) / g.rows;  // tiles a clip
  const long long tiles = static_cast<long long>(members) * B * tpc;
  const long long first = blockIdx.x;
  const long long stride = gridDim.x;
  auto stage = [&](long long tile, int buf) {
    const long long clip = tile / tpc;
    entry_copy_rows(
        reinterpret_cast<__nv_bfloat16*>(ring + buf * g.raw_bytes), g.raw_rs,
        x, clip, static_cast<int>(tile - clip * tpc) * g.rows, hrows, ht, T,
        F, Cin, cb);
  };

  // the ring's first two tiles
#pragma unroll
  for (int s = 0; s < kEntryFwdStages - 1; ++s) {
    if (first + s * stride < tiles) stage(first + s * stride, s);
    cp_async_commit();
  }

  const int m16 = g.pixels / 16;
  const int mgroups = (m16 + MTW - 1) / MTW;
  const int nchunks = N / NB;
  const uint16_t* hs = reinterpret_cast<const uint16_t*>(halo);
  int member = -1;
  for (long long it = 0;; ++it) {
    const long long tile = first + it * stride;
    if (tile >= tiles) break;
    const long long clip = tile / tpc;
    const int t0 = static_cast<int>(tile - clip * tpc) * g.rows;
    const int m = static_cast<int>(clip / B);
    cp_async_wait<kEntryFwdStages - 2>();
    __syncthreads();  // this tile landed; every warp is done with the last
    if (m != member) {
      // this member's weights, n-major in mma column order, zero past K
      // and at the padding channel; its scale and shift
      const __nv_bfloat16* wm =
          w + static_cast<long long>(m) * kt * kf * Cin * N;
      for (int e = tid; e < Kp * N; e += kEntryThreads) {
        const int k = e / N;
        const int n = e - k * N;
        const int tap = k / cs;
        const int c = k - tap * cs;
        wt[entry_mma_column<NB>(n) * ldb + (QUADS ? entry_mma_k(k) : k)] =
            k < g.K && c < Cin ? wm[(tap * Cin + c) * N + n]
                               : __float2bfloat16(0.f);
      }
      if constexpr (AFFINE) {
        for (int c = tid; c < Cin; c += kEntryThreads) {
          s_scale[c] = scale[m * Cin + c];
          s_shift[c] = shift[m * Cin + c];
        }
      }
      member = m;
      __syncthreads();
    }
    entry_layout<AFFINE>(
        reinterpret_cast<const uint32_t*>(
            ring + static_cast<int>(it % kEntryFwdStages) * g.raw_bytes),
        reinterpret_cast<uint32_t*>(halo), g, interior, t0 - ht, hrows, T,
        F, Cin, s_scale, s_shift);
    __syncthreads();
    // the tile two ahead, into the stage the last tile freed
    if (tile + (kEntryFwdStages - 1) * stride < tiles)
      stage(tile + (kEntryFwdStages - 1) * stride,
            static_cast<int>((it + kEntryFwdStages - 1) % kEntryFwdStages));
    cp_async_commit();

    const int valid_px = min(g.rows, T - t0) * F;
    const float* bm = bias == nullptr ? nullptr : bias + m * N;
    __nv_bfloat16* ytile =
        y + (clip * T + t0) * static_cast<long long>(F) * N;
    for (int nc = 0; nc < nchunks; ++nc) {
      const int n0 = nc * NB;
      // this lane's bias: channels n0 + 2 J tq + 2 j + (0, 1)
      float bv[J][2];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = n0 + 2 * J * tq + 2 * j;
        bv[j][0] = bm == nullptr ? 0.f : bm[c];
        bv[j][1] = bm == nullptr ? 0.f : bm[c + 1];
      }
      // this lane's ldmatrix row of the weights: n and k half
      const int bq = lane >> 3;
      const __nv_bfloat16* wrow =
          wt + (n0 + 8 * (bq >> 1) + (lane & 7)) * ldb + 8 * (bq & 1);
      for (int mg = warp; mg < mgroups; mg += kEntryThreads / 32) {
        float acc[MTW][J][4];
        int b0[MTW], b1[MTW];
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          const int mt = min(mg * MTW + i, m16 - 1);
          b0[i] = base[mt * 16 + gq];
          b1[i] = base[mt * 16 + gq + 8];
#pragma unroll
          for (int j = 0; j < J; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
        }
        for (int ks = 0; ks < g.ks; ++ks) {
          int2 o01, o89;
          if constexpr (QUADS) {
            o01.x = off[16 * ks + 4 * tq];
          } else {
            o01 = *reinterpret_cast<const int2*>(off + 16 * ks + 2 * tq);
            o89 = *reinterpret_cast<const int2*>(off + 16 * ks + 2 * tq + 8);
          }
          uint32_t bfr[J][2];
#pragma unroll
          for (int jj = 0; jj < J / 2; ++jj) {
            uint32_t r[4];
            ldsm_x4(r, smem_u32(wrow + 16 * jj * ldb + 16 * ks));
            bfr[2 * jj][0] = r[0];
            bfr[2 * jj][1] = r[1];
            bfr[2 * jj + 1][0] = r[2];
            bfr[2 * jj + 1][1] = r[3];
          }
#pragma unroll
          for (int i = 0; i < MTW; ++i) {
            uint32_t a[4];
            if constexpr (QUADS) {
              const uint2 lo = entry_quad(hs, b0[i], o01.x);
              const uint2 hi = entry_quad(hs, b1[i], o01.x);
              a[0] = lo.x;
              a[1] = hi.x;
              a[2] = lo.y;
              a[3] = hi.y;
            } else {
              a[0] = entry_pair(hs, b0[i], o01.x, o01.y);
              a[1] = entry_pair(hs, b1[i], o01.x, o01.y);
              a[2] = entry_pair(hs, b0[i], o89.x, o89.y);
              a[3] = entry_pair(hs, b1[i], o89.x, o89.y);
            }
#pragma unroll
            for (int j = 0; j < J; ++j)
              mma_bf16_16816(acc[i][j], a, bfr[j][0], bfr[j][1]);
          }
        }
        // epilogue: + bias, one rounding, 16-byte stores
#pragma unroll
        for (int i = 0; i < MTW; ++i) {
          const int mt = mg * MTW + i;
          if (mt >= m16) break;
          const int p_lo = mt * 16 + gq;
          uint32_t lo[J], hi[J];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            lo[j] = bf16x2_bits(acc[i][j][0] + bv[j][0],
                                acc[i][j][1] + bv[j][1]);
            hi[j] = bf16x2_bits(acc[i][j][2] + bv[j][0],
                                acc[i][j][3] + bv[j][1]);
          }
          if constexpr (NB == 32) {
            // channels n0 + 8 tq .. + 7 of both rows
            __nv_bfloat16* dst = ytile + n0 + 8 * tq;
            if (p_lo < valid_px)
              *reinterpret_cast<uint4*>(dst + static_cast<long long>(p_lo) *
                                                  N) =
                  make_uint4(lo[0], lo[1], lo[2], lo[3]);
            if (p_lo + 8 < valid_px)
              *reinterpret_cast<uint4*>(
                  dst + static_cast<long long>(p_lo + 8) * N) =
                  make_uint4(hi[0], hi[1], hi[2], hi[3]);
          } else {
            // channels 4 tq .. + 3 of both rows; the even lane of a pair
            // takes row g's eight, the odd one row g + 8's
            const bool odd = tq & 1;
            const uint32_t r0 =
                __shfl_xor_sync(0xffffffffu, odd ? lo[0] : hi[0], 1);
            const uint32_t r1 =
                __shfl_xor_sync(0xffffffffu, odd ? lo[1] : hi[1], 1);
            const int p = p_lo + (odd ? 8 : 0);
            if (p < valid_px)
              *reinterpret_cast<uint4*>(ytile + static_cast<long long>(p) * N +
                                        n0 + 4 * (tq & ~1)) =
                  odd ? make_uint4(r0, r1, hi[0], hi[1])
                      : make_uint4(lo[0], lo[1], r0, r1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- 2. the weight gradient ---------------------------------------------

// bnrelu in place on the staged halo's in-clip frame rows (interior
// elements only: the SAME halo stays 0)
__device__ __forceinline__ void entry_affine(__nv_bfloat16* h, int t0, int T,
                                            int F, int Cin, int kt,
                                            const EntryGeom& g, int interior,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ shift) {
  const int ht = (kt - 1) / 2;
  for (int hr = 0; hr < g.rows + kt - 1; ++hr) {
    const int t = t0 - ht + hr;
    if (t < 0 || t >= T) continue;
    __nv_bfloat16* row = h + hr * g.rs + interior;
    for (int f = threadIdx.x; f < F; f += kEntryThreads)
      for (int c = 0; c < Cin; ++c)
        row[f * Cin + c] = bnrelu(row[f * Cin + c], scale[c], shift[c]);
  }
}

template <int NT, int MT, bool AFFINE>
__global__ void __launch_bounds__(kEntryThreads, 3)
conv2d_dw_entry_kernel(const __nv_bfloat16* __restrict__ x,   // (B,T,F,Cin)
                       const __nv_bfloat16* __restrict__ gy,  // (B,T,F,Cout)
                       const float* __restrict__ scale,  // (Cin,) if AFFINE
                       const float* __restrict__ shift,  // (Cin,) if AFFINE
                       float* __restrict__ ws,  // (chunks, K, Cout)
                       int B, int T, int F, int Cin, int Cout, int kt, int kf,
                       EntryGeom g, int per_chunk, int kgroups) {
  constexpr int CU = 2 * MT + 1;  // 16-byte units a staged gy pixel row
  constexpr int CB = 16 * MT;     // output channels a block
  extern __shared__ __align__(128) uint8_t smem[];
  const int stage_bytes =
      g.halo_bytes + round_up(g.pixels * CU * 16, 128);
  uint8_t* ring = smem;
  int* base = reinterpret_cast<int*>(
      smem + max(kEntryDwStages * stage_bytes,
                 kEntryThreads / 32 * NT * 8 * CB * 4));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int ht = (kt - 1) / 2;
  const int hf = (kf - 1) / 2;
  const int hrows = g.rows + kt - 1;
  const int interior = g.lead + hf * Cin;
  const int cb = entry_copy_bytes(F * Cin * 2);
  const int kg = blockIdx.y % kgroups;
  const int co0 = (blockIdx.y / kgroups) * CB;
  const int n8 = (g.K + 7) / 8;  // packed rows in n8 tiles
  const int j0 = kg * NT;        // this block's first n8 tile

  for (int i = tid * 16; i < kEntryDwStages * stage_bytes;
       i += kEntryThreads * 16)
    *reinterpret_cast<uint4*>(ring + i) = make_uint4(0u, 0u, 0u, 0u);
  for (int p = tid; p < g.pixels; p += kEntryThreads)
    base[p] = (p / F) * g.rs + g.lead + (p % F) * Cin;
  // this lane's packed row in each n8 tile (column gq of the B fragment;
  // a row past K reads the pixel's first element, unused)
  int offk[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int k = 8 * (j0 + j) + gq;
    const int tap = k / Cin;
    offk[j] = k < g.K ? (tap / kf) * g.rs + (tap % kf) * Cin + (k - tap * Cin)
                      : 0;
  }
  __syncthreads();

  const int tpc = (T + g.rows - 1) / g.rows;
  const int tiles = B * tpc;
  const int t_begin = blockIdx.x * per_chunk;
  const int t_end = min(tiles, t_begin + per_chunk);

  // stage tile `tile`: the x halo, then the gy rows of channels co0 ..
  // co0 + CB (frames past T zero-filled)
  auto stage_tile = [&](int tile, uint8_t* stage) {
    const int clip = tile / tpc;
    const int t0 = (tile - clip * tpc) * g.rows;
    entry_copy_rows(reinterpret_cast<__nv_bfloat16*>(stage) + interior, g.rs,
                    x, clip, t0, hrows, ht, T, F, Cin, cb);
    uint8_t* gs = stage + g.halo_bytes;
    for (int r = 0; r < g.rows; ++r) {
      const int t = t0 + r;
      const bool in = t < T;
      const __nv_bfloat16* src =
          gy + ((static_cast<long long>(clip) * T + (in ? t : 0)) * F) *
                   Cout + co0;
      uint8_t* d = gs + r * F * CU * 16;
      for (int i = tid; i < F * 2 * MT; i += kEntryThreads) {
        const int f = i / (2 * MT);
        const int u = i - f * (2 * MT);
        entry_copy(d + (f * CU + u) * 16, src + f * Cout + 8 * u, 16, in);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kEntryDwStages - 1; ++s) {
    if (t_begin + s < t_end) stage_tile(t_begin + s, ring + s * stage_bytes);
    cp_async_commit();
  }

  float acc[NT][MT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][mt][r] = 0.f;

  const int steps = g.pixels / 16;
  const int aq = lane >> 3;  // this lane's ldmatrix matrix
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int it = tile - t_begin;
    uint8_t* stage = ring + (it % kEntryDwStages) * stage_bytes;
    cp_async_wait<kEntryDwStages - 2>();
    __syncthreads();
    if constexpr (AFFINE) {
      const int clip = tile / tpc;
      entry_affine(reinterpret_cast<__nv_bfloat16*>(stage),
                   (tile - clip * tpc) * g.rows, T, F, Cin, kt, g, interior,
                   scale, shift);
      __syncthreads();
    }
    if (tile + kEntryDwStages - 1 < t_end)
      stage_tile(tile + kEntryDwStages - 1,
                 ring + ((it + kEntryDwStages - 1) % kEntryDwStages) *
                            stage_bytes);
    cp_async_commit();

    const uint16_t* hs = reinterpret_cast<const uint16_t*>(stage);
    const uint8_t* gs = stage + g.halo_bytes;
    for (int s = warp; s < steps; s += kEntryThreads / 32) {
      // A = gy^T: co rows, 16 pixels; ldmatrix.trans of [pixel][co]
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_trans(a[mt], smem_u32(gs + ((16 * s + (lane & 7) +
                                             8 * (aq >> 1)) * CU +
                                            2 * mt + (aq & 1)) * 16));
      const int2 p01 = *reinterpret_cast<const int2*>(base + 16 * s + 2 * tq);
      const int2 p89 =
          *reinterpret_cast<const int2*>(base + 16 * s + 2 * tq + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j0 + j >= n8) break;
        const uint32_t bl = pack2(hs[p01.x + offk[j]], hs[p01.y + offk[j]]);
        const uint32_t bh = pack2(hs[p89.x + offk[j]], hs[p89.y + offk[j]]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16_16816(acc[j][mt], a[mt], bl, bh);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' sums, added in warp order: red[warp][row][co]
  float* red = reinterpret_cast<float*>(smem);
  const int rows8 = NT * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int co = 16 * mt + gq;
      const int r = 8 * j + 2 * tq;
      float* dst = red + warp * rows8 * CB;
      dst[r * CB + co] = acc[j][mt][0];
      dst[(r + 1) * CB + co] = acc[j][mt][1];
      dst[r * CB + co + 8] = acc[j][mt][2];
      dst[(r + 1) * CB + co + 8] = acc[j][mt][3];
    }
  __syncthreads();
  const int rows_here = min(rows8, g.K - 8 * j0);
  float* slot = ws + static_cast<long long>(blockIdx.x) * g.K * Cout;
  for (int e = tid; e < rows_here * CB; e += kEntryThreads) {
    const int r = e / CB;
    const int co = e - r * CB;
    float v = red[e];
#pragma unroll
    for (int wi = 1; wi < kEntryThreads / 32; ++wi)
      v += red[wi * rows8 * CB + e];
    slot[static_cast<long long>(8 * j0 + r) * Cout + co0 + co] = v;
  }
}

// dw[e] = the sum over the chunks of ws[c][e] (e < n = K * Cout): a warp
// an element, lane l adding chunks l, l + 32, ... in order, then the lanes
// in a fixed butterfly; the same bits every run. (The entry pass has some
// 500 chunks of a few thousand elements, where conv2d_bwd.cu's reduce, a
// thread an element over the chunks in turn, took 22 us against 4 at
// shallow L0; that one suits the wgmma pass's few chunks of many.)
__global__ void conv2d_dw_entry_reduce_kernel(const float* __restrict__ ws,
                                              float* __restrict__ dw,
                                              int chunks, int n) {
  const int lane = threadIdx.x & 31;
  for (long long e = (blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x) / 32;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x / 32) {
    float s = 0.f;
    for (int c = lane; c < chunks; c += 32)
      s += ws[static_cast<long long>(c) * n + e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) dw[e] = s;
  }
}

// ---- host side ----------------------------------------------------------

template <int NB, bool AFFINE, bool QUADS>
cudaError_t conv2d_entry_launch(const void* x, const void* w, const float* b,
                                const float* scale, const float* shift,
                                void* y, int B, int T, int F, int Cin, int N,
                                int kt, int kf, cudaStream_t stream,
                                int members) {
  const EntryGeom g = entry_pick(F, Cin, N, kt, kf, false);
  const int smem = entry_fwd_smem(g, N);
  auto kernel = conv2d_entry_kernel<NB, AFFINE, QUADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kEntryThreads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(members) * B *
                          ((T + g.rows - 1) / g.rows);
  const long long blocks = std::min<long long>(
      tiles, static_cast<long long>(std::max(per_sm, 1)) * sms);
  kernel<<<static_cast<unsigned>(blocks), kEntryThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), b, scale, shift,
      static_cast<__nv_bfloat16*>(y), B, T, F, Cin, N, kt, kf, g, members);
  return cudaGetLastError();
}

template <int NB, bool AFFINE>
cudaError_t conv2d_entry_quads(const void* x, const void* w, const float* b,
                               const float* scale, const float* shift,
                               void* y, int B, int T, int F, int Cin, int N,
                               int kt, int kf, cudaStream_t s, int members) {
  if (Cin > 1)
    return conv2d_entry_launch<NB, AFFINE, true>(
        x, w, b, scale, shift, y, B, T, F, Cin, N, kt, kf, s, members);
  return conv2d_entry_launch<NB, AFFINE, false>(
      x, w, b, scale, shift, y, B, T, F, Cin, N, kt, kf, s, members);
}

// the forward-type GEMM at Cin < 16 (conv2d_entry_ok); with scale and
// shift ((M, Cin) f32) through bnrelu; ``members`` stacked members
template <bool AFFINE>
cudaError_t conv2d_entry(const void* x, const void* w, const float* b,
                         const float* scale, const float* shift, void* y,
                         int B, int T, int F, int Cin, int N, int kt, int kf,
                         cudaStream_t s, int members) {
  if (N % 32 == 0)
    return conv2d_entry_quads<32, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                          Cin, N, kt, kf, s, members);
  return conv2d_entry_quads<16, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                        Cin, N, kt, kf, s, members);
}

// blocks of the dw pass besides its chunks: packed-row groups x channel
// groups
inline int entry_dw_blocks_per_chunk(int Cin, int Cout, int kt, int kf) {
  const int K = kt * kf * Cin;
  const int nt = entry_dw_nt(K, Cout);
  return ((K + 7) / 8 + nt - 1) / nt * (Cout / (16 * entry_dw_mt(Cout)));
}

// the entry dw pass's pixel chunks: about four blocks an SM
inline int entry_dw_chunks(int B, int T, int F, int Cin, int Cout, int kt,
                           int kf, int sms) {
  const EntryGeom g = entry_pick(F, Cin, Cout, kt, kf, true);
  const long long tiles =
      static_cast<long long>(B) * ((T + g.rows - 1) / g.rows);
  const int per = entry_dw_blocks_per_chunk(Cin, Cout, kt, kf);
  long long chunks = std::max(1, 4 * sms / per);
  if (chunks > tiles) chunks = tiles;
  return chunks < 1 ? 1 : static_cast<int>(chunks);
}

template <int NT, int MT, bool AFFINE>
cudaError_t conv2d_dw_entry_launch(const void* x, const void* gy,
                                   const float* scale, const float* shift,
                                   void* ws, int B, int T, int F, int Cin,
                                   int Cout, int kt, int kf, int chunks,
                                   cudaStream_t s) {
  const EntryGeom g = entry_pick(F, Cin, Cout, kt, kf, true);
  const int smem = entry_dw_smem(g, Cout);
  auto kernel = conv2d_dw_entry_kernel<NT, MT, AFFINE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = B * ((T + g.rows - 1) / g.rows);
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const int kgroups = ((g.K + 7) / 8 + NT - 1) / NT;
  const dim3 grid(chunks, kgroups * (Cout / (16 * MT)));
  kernel<<<grid, kEntryThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), scale, shift,
      static_cast<float*>(ws), B, T, F, Cin, Cout, kt, kf, g, per_chunk,
      kgroups);
  return cudaGetLastError();
}

template <int NT, bool AFFINE>
cudaError_t conv2d_dw_entry_mt(const void* x, const void* gy,
                               const float* scale, const float* shift,
                               void* ws, int B, int T, int F, int Cin,
                               int Cout, int kt, int kf, int chunks,
                               cudaStream_t s) {
  if constexpr (NT == 16) {
    return conv2d_dw_entry_launch<16, 1, AFFINE>(
        x, gy, scale, shift, ws, B, T, F, Cin, Cout, kt, kf, chunks, s);
  } else {
    if (entry_dw_mt(Cout) == 2)
      return conv2d_dw_entry_launch<NT, 2, AFFINE>(
          x, gy, scale, shift, ws, B, T, F, Cin, Cout, kt, kf, chunks, s);
    return conv2d_dw_entry_launch<NT, 1, AFFINE>(
        x, gy, scale, shift, ws, B, T, F, Cin, Cout, kt, kf, chunks, s);
  }
}

// dw at Cin < 16 (conv2d_dw_entry_ok): the partials into ws (chunks,
// kt * kf * Cin, Cout) f32, then their reduce into dw (kt, kf, Cin, Cout)
template <bool AFFINE>
cudaError_t conv2d_dw_entry(const void* x, const void* gy, const float* scale,
                            const float* shift, void* ws, void* dw, int B,
                            int T, int F, int Cin, int Cout, int kt, int kf,
                            int chunks, cudaStream_t s) {
  cudaError_t err;
  switch (entry_dw_nt(kt * kf * Cin, Cout)) {
    case 2:
      err = conv2d_dw_entry_mt<2, AFFINE>(x, gy, scale, shift, ws, B, T, F,
                                          Cin, Cout, kt, kf, chunks, s);
      break;
    case 4:
      err = conv2d_dw_entry_mt<4, AFFINE>(x, gy, scale, shift, ws, B, T, F,
                                          Cin, Cout, kt, kf, chunks, s);
      break;
    case 8:
      err = conv2d_dw_entry_mt<8, AFFINE>(x, gy, scale, shift, ws, B, T, F,
                                          Cin, Cout, kt, kf, chunks, s);
      break;
    default:
      err = conv2d_dw_entry_mt<16, AFFINE>(x, gy, scale, shift, ws, B, T, F,
                                           Cin, Cout, kt, kf, chunks, s);
  }
  if (err != cudaSuccess) return err;
  const int n = kt * kf * Cin * Cout;
  const int blocks = std::min((n + 7) / 8, 4096);
  conv2d_dw_entry_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), chunks, n);
  return cudaGetLastError();
}

// y = conv(x, w) + b for M members, on the kernel the shape takes: the
// entry kernel where conv2d_entry_ok (Cin < 16), else the wgmma kernel
// where conv2d_wgmma_ok; cudaErrorInvalidValue, before any launch, for a
// shape neither takes; with scale and shift (both (M, Cin) f32) the input
// goes through bnrelu on the way (the BN+ReLU-fused conv). The backward's
// dx runs it too (conv2d_bwd.cu).
inline bool conv2d_gemm_takes(int F, int Cin, int N, int kt, int kf) {
  return conv2d_entry_ok(F, Cin, N, kt, kf) ||
         conv2d_wgmma_ok(F, Cin, N, kt, kf);
}

inline cudaError_t conv2d_gemm(const void* x, const void* w, const void* b,
                               void* y, int M, int B, int T, int F, int Cin,
                               int N, int kt, int kf, cudaStream_t stream,
                               const float* scale = nullptr,
                               const float* shift = nullptr) {
  const float* bias = static_cast<const float*>(b);
  if (conv2d_entry_ok(F, Cin, N, kt, kf))
    return scale != nullptr
               ? conv2d_entry<true>(x, w, bias, scale, shift, y, B, T, F, Cin,
                                    N, kt, kf, stream, M)
               : conv2d_entry<false>(x, w, bias, nullptr, nullptr, y, B, T,
                                     F, Cin, N, kt, kf, stream, M);
  if (scale != nullptr)
    return conv2d_wgmma<true>(x, w, bias, scale, shift, y, B, T, F, Cin, N,
                              kt, kf, stream, M);
  return conv2d_wgmma<false>(x, w, bias, nullptr, nullptr, y, B, T, F, Cin,
                             N, kt, kf, stream, M);
}

// The dw pass's pixel chunks (the workspace's first dimension): the entry
// kernel about four blocks an SM; the wgmma kernel one wave of ``sms``
// blocks over its tiles (its ring fills most of shared memory); 1 for a
// shape neither takes
inline int conv2d_dw_chunks(int B, int T, int F, int Cin, int Cout, int kt,
                            int kf, int sms) {
  const long long P = static_cast<long long>(B) * T * F;
  if (P == 0) return 1;
  if (conv2d_dw_entry_ok(F, Cin, Cout, kt, kf))
    return entry_dw_chunks(B, T, F, Cin, Cout, kt, kf, sms);
  const WgPlan plan = conv2d_dw_wgmma_plan(F, Cin, Cout, kt, kf);
  if (plan.width == 0) return 1;
  const int rows = plan.rows;
  const int per_chunk = ((Cin + 63) / 64) *
                        ((Cout + dw_bn(Cout) - 1) / dw_bn(Cout)) *
                        ((kt * kf + 8) / 9);
  const long long tiles = static_cast<long long>(B) * ((T + rows - 1) / rows) *
                          ((F + plan.width - 1) / plan.width);
  long long chunks = sms / per_chunk;
  if (chunks > tiles) chunks = tiles;
  return chunks < 1 ? 1 : static_cast<int>(chunks);
}

// the input channels of one tap in the dw workspace (chunks, kt * kf,
// cin_pad, Cout): Cin for the entry kernel (its rows are packed), Cin
// rounded up to 16 for the wgmma one
inline int conv2d_dw_cin_pad(int F, int Cin, int Cout, int kt, int kf) {
  return conv2d_dw_entry_ok(F, Cin, Cout, kt, kf) ? Cin : (Cin + 15) / 16 * 16;
}

}  // namespace
