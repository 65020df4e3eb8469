// Stride-1 SAME 2-D convolution in float32 on the channels-last
// (B, T, F, C) layout, any kernel extent (XLA's SAME pads, even extents
// too) and any channel counts, forward and backward (dx, dw):
//
//   y[b, t, f, n] = sum_{dt, df, c} x[b, t + dt - lo_t, f + df - lo_f, c]
//                   * w[dt, df, c, n] + bias[n],  lo = (k - 1) / 2
//
// f32 operands and f32 sums, no rounding to a narrower type: not plain
// TF32, which would round each operand to 10 mantissa bits and miss an
// f32 reference by ~1e-3.
//
// Replaces: no Pallas site. It is the f32 counterpart of the conv layers
// that conv2d.cu / conv2d_bwd.cu serve in bf16
// (pb_sed_tpu/ops/pallas/conv.py:_fwd_kernel, _bwd_kernel), for
// CNN2d(compute_dtype='float32'), where the JAX package convolves with
// lax.conv_general_dilated on f32 operands (pb_sed_tpu/ops/cnn.py:113-119).
//
// Three designs, chosen by shape before the launch
// (pbsed_conv2d_f32_design reports which):
//
// - 3xTF32 on the tensor cores (conv2d_f32_wgmma.cuh): wgmma .tf32 fed by
//   TMA halo rings, each operand split into a TF32 hi and lo part and a
//   product taken as hi*lo + lo*hi + hi*hi, runs of products kept short
//   and added to f32 register sums. It takes the forward, dx and dw of
//   every layer with Cin and Cout >= 16 (multiples of 4) and F a power of
//   two dividing 128: the shallow tower's L1-L8.
// - The entry kernels (conv2d_f32_entry.cuh): 3xTF32 on mma.sync m16n8k8,
//   taps and channels packed into one K, fed by cp.async rings of whole
//   frequency rows at any F. They take the forward, dx and dw of every
//   layer with Cin < 16 (the entry layer, Cin = 1, and the tag-conditioned
//   BiCRNN's, Cin = 11) whose tiles fit shared memory.
// - FFMA (below) for the rest: F off the 3xTF32 tile with Cin >= 16, and
//   channel counts off a multiple of 4. An implicit GEMM (the im2col patch
//   never exists in device memory): M = B * T * F output pixels, N = Cout,
//   K = kt * kf * Cin, flattened as k = (dt * kf + df) * Cin + c, the
//   weights' own layout. A block of 256 threads owns 128 pixels x BN (16,
//   32 or 64) channels and walks K in slices of 16: it stages the slice's
//   input values (the SAME halo and K's tail as zeros) k-major and the
//   weights' 16 rows in shared memory, and each thread accumulates 8
//   pixels x BN / 16 channels in registers.
//
// The input gradient is the forward's GEMM on the cotangent with the
// flipped, transposed weights and the pads mirrored (lo' = k - 1 - lo);
// it is skipped when the caller passes no dx. The weight gradient is a
// GEMM of K rows x N columns over the pixels, cut into pixel chunks: each
// chunk's block writes its partial sums, and a second kernel adds the
// chunks in chunk order, so reruns are bit-identical (no float atomics).
// Stacked members (x (M, B, T, F, Cin), w (M, kt, kf, Cin, Cout), bias
// (M, Cout)) run in one launch of the forward.
//
// What bounds it on the H100: the shallow tower's 3x3 layers are 284
// GFLOP a forward at B = 32, T = 500: 1.72 ms at the TF32 tensor rate x 3
// (495 TFLOP/s) against 4.23 at the FFMA rate (67 TFLOP/s); the entry
// layer and L1's dw by bytes.
#include "conv2d_f32_entry.cuh"
#include "conv2d_f32_wgmma.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32BM = 128;     // output pixels (dw: K rows) a block
constexpr int kF32BK = 16;      // K slice (dw: pixels) a step
constexpr int kF32Threads = 256;
constexpr int kF32TM = kF32BM / 16;  // rows a thread
constexpr int kF32MaxChunks = 256;

// The shared product of a staged slice: acc (TM x TN) += As[:, rows] x
// Bs[:, cols] over the slice's 16 k.
template <int BN>
__device__ __forceinline__ void f32_slice_product(
    float (*As)[kF32BM + 4], float (*Bs)[BN + 4], int ty, int tx,
    float (&acc)[kF32TM][BN / 16]) {
  constexpr int TN = BN / 16;
#pragma unroll
  for (int kk = 0; kk < kF32BK; ++kk) {
    float a[kF32TM], b[TN];
#pragma unroll
    for (int i = 0; i < kF32TM; ++i) a[i] = As[kk][ty * kF32TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
    for (int i = 0; i < kF32TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// y (Mpix, N) = conv(x, w) [+ bias] for one member per grid z; grid
// (ceil(Mpix / 128), ceil(N / BN), members).
template <int BN>
__global__ void __launch_bounds__(kF32Threads)
conv2d_f32_kernel(const float* __restrict__ x,     // (B, T, F, Cin)
                  const float* __restrict__ w,     // (kt, kf, Cin, N)
                  const float* __restrict__ bias,  // (N,) or null
                  float* __restrict__ y,           // (B, T, F, N)
                  int T, int F, int Cin, int N, int kt, int kf, int lo_t,
                  int lo_f, long long Mpix) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float As[kF32BK][kF32BM + 4];
  __shared__ __align__(16) float Bs[kF32BK][BN + 4];
  const long long mb = blockIdx.z;
  x += mb * Mpix * Cin;
  w += mb * kt * kf * Cin * N;
  y += mb * Mpix * N;
  if (bias != nullptr) bias += mb * N;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kF32BM;
  const int n0 = blockIdx.y * BN;
  const int K = kt * kf * Cin;

  // staging of the input slice: pixel a_m of the tile, k's a_k0 .. + 8
  const int a_m = tid % kF32BM;
  const int a_k0 = (tid / kF32BM) * 8;
  const long long p = m0 + a_m;
  const bool p_ok = p < Mpix;
  int pb = 0, pt = 0, pf = 0;
  if (p_ok) {
    pf = static_cast<int>(p % F);
    const long long q = p / F;
    pt = static_cast<int>(q % T);
    pb = static_cast<int>(q / T);
  }

  float acc[kF32TM][TN];
#pragma unroll
  for (int i = 0; i < kF32TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32BK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + a_k0 + i;
      float v = 0.f;
      if (p_ok && k < K) {
        const int tap = k / Cin;
        const int c = k - tap * Cin;
        const int dt = tap / kf;
        const int st = pt + dt - lo_t;
        const int sf = pf + (tap - dt * kf) - lo_f;
        if (st >= 0 && st < T && sf >= 0 && sf < F)
          v = x[((static_cast<long long>(pb) * T + st) * F + sf) * Cin + c];
      }
      As[a_k0 + i][a_m] = v;
    }
    for (int e = tid; e < kF32BK * BN; e += kF32Threads) {
      const int r = e / BN;
      const int col = e % BN;
      const int k = k0 + r;
      Bs[r][col] = (k < K && n0 + col < N)
                       ? w[static_cast<long long>(k) * N + n0 + col]
                       : 0.f;
    }
    __syncthreads();
    f32_slice_product<BN>(As, Bs, ty, tx, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kF32TM; ++i) {
    const long long m = m0 + ty * kF32TM + i;
    if (m >= Mpix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) y[m * N + n] = acc[i][j] + (bias == nullptr ? 0.f : bias[n]);
    }
  }
}

// dw partials: part[chunk] (K, N) = sum over the chunk's pixels p of
// x[p shifted by tap(k), c(k)] * gy[p, n]; grid (ceil(K / 128),
// ceil(N / BN), chunks), chunk_len pixels a chunk (a multiple of 16).
template <int BN>
__global__ void __launch_bounds__(kF32Threads)
conv2d_f32_dw_kernel(const float* __restrict__ x,   // (B, T, F, Cin)
                     const float* __restrict__ gy,  // (B, T, F, N)
                     float* __restrict__ part,      // (chunks, K, N)
                     int T, int F, int Cin, int N, int kt, int kf, int lo_t,
                     int lo_f, long long Mpix, long long chunk_len) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float As[kF32BK][kF32BM + 4];
  __shared__ __align__(16) float Bs[kF32BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int K = kt * kf * Cin;
  const int r0 = blockIdx.x * kF32BM;
  const int n0 = blockIdx.y * BN;
  const long long p_begin = blockIdx.z * chunk_len;
  const long long p_end = min(Mpix, p_begin + chunk_len);

  // staging: K row a_k of the tile, the slice's pixels a_p0 .. + 8
  const int a_k = r0 + tid % kF32BM;
  const int a_p0 = (tid / kF32BM) * 8;
  const bool k_ok = a_k < K;
  int c = 0, dt = 0, df = 0;
  if (k_ok) {
    const int tap = a_k / Cin;
    c = a_k - tap * Cin;
    dt = tap / kf;
    df = tap - dt * kf;
  }

  float acc[kF32TM][TN];
#pragma unroll
  for (int i = 0; i < kF32TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (long long q0 = p_begin; q0 < p_end; q0 += kF32BK) {
    // the first of this thread's 8 pixels, then step through (b, t, f)
    long long p = q0 + a_p0;
    int pf = static_cast<int>(p % F);
    long long rest = p / F;
    int pt = static_cast<int>(rest % T);
    long long pb = rest / T;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = 0.f;
      if (k_ok && p + i < p_end) {
        const int st = pt + dt - lo_t;
        const int sf = pf + df - lo_f;
        if (st >= 0 && st < T && sf >= 0 && sf < F)
          v = x[((pb * T + st) * F + sf) * Cin + c];
      }
      As[a_p0 + i][tid % kF32BM] = v;
      if (++pf == F) {
        pf = 0;
        if (++pt == T) {
          pt = 0;
          ++pb;
        }
      }
    }
    for (int e = tid; e < kF32BK * BN; e += kF32Threads) {
      const int r = e / BN;
      const int col = e % BN;
      const long long q = q0 + r;
      Bs[r][col] = (q < p_end && n0 + col < N) ? gy[q * N + n0 + col] : 0.f;
    }
    __syncthreads();
    // each slice's 16 products summed apart, then added to the chunk's
    // sum: a chunk's thousands of pixels would otherwise add one by one
    // into a sum far larger than each
    float slice[kF32TM][TN];
#pragma unroll
    for (int i = 0; i < kF32TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) slice[i][j] = 0.f;
    f32_slice_product<BN>(As, Bs, ty, tx, slice);
#pragma unroll
    for (int i = 0; i < kF32TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += slice[i][j];
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * K * N;
#pragma unroll
  for (int i = 0; i < kF32TM; ++i) {
    const int k = r0 + ty * kF32TM + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[static_cast<long long>(k) * N + n] = acc[i][j];
    }
  }
}

// dw[e] = sum over the chunks, in chunk order, of part[chunk][e]; the
// loads of 16 chunks are issued before their adds (the entry dw pass adds
// some 260 chunks of 144-1584 elements: a thread an element)
__global__ void conv2d_f32_dw_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ dw,
                                            int chunks, long long n) {
  constexpr int kAhead = 16;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    int i = 0;
    for (; i + kAhead <= chunks; i += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) v[u] = part[(i + u) * n + e];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) s += v[u];
    }
    for (; i < chunks; ++i) s += part[i * n + e];
    dw[e] = s;
  }
}

// BN of a GEMM with N output columns: the smallest tile of 16, 32, 64
// that holds N, 64 above
inline int f32_tile_n(int N) { return N <= 16 ? 16 : N <= 32 ? 32 : 64; }

cudaError_t conv2d_f32(const float* x, const float* w, const float* b,
                       float* y, int members, int B, int T, int F, int Cin,
                       int N, int kt, int kf, int lo_t, int lo_f,
                       cudaStream_t s) {
  const long long Mpix = static_cast<long long>(B) * T * F;
  const int bn = f32_tile_n(N);
  const dim3 grid(static_cast<unsigned>((Mpix + kF32BM - 1) / kF32BM),
                  (N + bn - 1) / bn, members);
  if (bn == 16)
    conv2d_f32_kernel<16><<<grid, kF32Threads, 0, s>>>(
        x, w, b, y, T, F, Cin, N, kt, kf, lo_t, lo_f, Mpix);
  else if (bn == 32)
    conv2d_f32_kernel<32><<<grid, kF32Threads, 0, s>>>(
        x, w, b, y, T, F, Cin, N, kt, kf, lo_t, lo_f, Mpix);
  else
    conv2d_f32_kernel<64><<<grid, kF32Threads, 0, s>>>(
        x, w, b, y, T, F, Cin, N, kt, kf, lo_t, lo_f, Mpix);
  return cudaGetLastError();
}

// Pixels a dw chunk: enough chunks for two blocks an SM over the (K, N)
// tiles, at most kF32MaxChunks, each a multiple of 16 pixels.
long long f32_dw_chunk_len(int B, int T, int F, int Cin, int Cout, int kt,
                           int kf, int sms) {
  const long long Mpix = static_cast<long long>(B) * T * F;
  const int bn = f32_tile_n(Cout);
  const long long tiles = static_cast<long long>(
                              (kt * kf * Cin + kF32BM - 1) / kF32BM) *
                          ((Cout + bn - 1) / bn);
  long long chunks = (2LL * sms + tiles - 1) / tiles;
  chunks = chunks < 1 ? 1 : chunks > kF32MaxChunks ? kF32MaxChunks : chunks;
  const long long len = (Mpix + chunks - 1) / chunks;
  return (len + kF32BK - 1) / kF32BK * kF32BK;
}

// The design of each pass of a (F, Cin -> Cout, kt x kf) layer: 2 the
// entry kernels (Cin < 16 where they fit), 1 3xTF32 on wgmma, 0 FFMA.
// The dx runs the forward's GEMM on gy: C = Cout channels in, N = Cin
// out, the frequency pads mirrored.
int f32_fwd_design(int F, int Cin, int Cout, int kt, int kf) {
  if (Cin < 16 && conv2d_f32_entry_ok(F, Cin, Cout, kt, kf, (kf - 1) / 2))
    return 2;
  return conv2d_f32_wgmma_ok(F, Cin, Cout, kt, kf) ? 1 : 0;
}

int f32_dx_design(int F, int Cin, int Cout, int kt, int kf) {
  if (Cin < 16 &&
      conv2d_f32_entry_ok(F, Cout, Cin, kt, kf, kf - 1 - (kf - 1) / 2))
    return 2;
  return conv2d_f32_wgmma_ok(F, Cout, Cin, kt, kf) ? 1 : 0;
}

int f32_dw_design(int F, int Cin, int Cout, int kt, int kf) {
  if (Cin < 16 && conv2d_f32_dw_entry_ok(F, Cin, Cout, kt, kf)) return 2;
  return conv2d_f32_dw_wgmma_ok(F, Cin, Cout, kt, kf) ? 1 : 0;
}

// pixel chunks of the dw pass at this shape for each design
int f32_dw_chunks(int B, int T, int F, int Cin, int Cout, int kt, int kf,
                  int sms) {
  const long long Mpix = static_cast<long long>(B) * T * F;
  if (Mpix == 0) return 1;
  const int design = f32_dw_design(F, Cin, Cout, kt, kf);
  if (design == 2)
    return conv2d_f32_dw_entry_chunks(B, T, F, Cin, Cout, kt, kf, sms);
  if (design == 1)
    return conv2d_f32_dw_wgmma_chunks(B, T, F, Cin, Cout, kt, kf, sms);
  const long long len = f32_dw_chunk_len(B, T, F, Cin, Cout, kt, kf, sms);
  return static_cast<int>((Mpix + len - 1) / len);
}

}  // namespace

// x (M, B, T, F, Cin) f32, w (M, kt, kf, Cin, Cout) f32, b (M, Cout) f32 or
// null, y (M, B, T, F, Cout) f32; contiguous. Any kt, kf >= 1 (XLA's SAME
// pads: (k - 1) / 2 before, k / 2 after), Cin, Cout >= 1. ``split`` holds
// pbsed_conv2d_f32_split_floats(0, ...) f32 (the weights' hi and lo) where
// that is not 0, else may be null. Returns a cudaError_t.
extern "C" int pbsed_conv2d_same_f32(const void* x, const void* w,
                                     const void* b, void* y, void* split,
                                     int M, int B, int T, int F, int Cin,
                                     int Cout, int kt, int kf, void* stream) {
  if (kt < 1 || kf < 1 || Cin < 1 || Cout < 1 || M < 1 || M > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * F == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ws = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  const int design = f32_fwd_design(F, Cin, Cout, kt, kf);
  if (design != 0 && split == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (design == 2)
    return static_cast<int>(conv2d_f32_entry(xs, ws, split, bs, ys, M, B, T,
                                             F, Cin, Cout, kt, kf,
                                             (kt - 1) / 2, (kf - 1) / 2, s));
  if (design == 1)
    return static_cast<int>(conv2d_f32_wgmma(xs, ws, split, bs, ys, M, B, T,
                                             F, Cin, Cout, kt, kf,
                                             (kt - 1) / 2, (kf - 1) / 2, s));
  return static_cast<int>(conv2d_f32(xs, ws, bs, ys, M, B, T, F, Cin, Cout,
                                     kt, kf, (kt - 1) / 2, (kf - 1) / 2, s));
}

// Which design a pass of the f32 conv of a (F, Cin -> Cout, kt x kf)
// layer runs: pass 0 the forward, 1 dx, 2 dw. Returns 2 for the entry
// kernels (conv2d_f32_entry.cuh), 1 for 3xTF32 on wgmma, each with its
// ring depth and dynamic shared memory in bytes written to the pointers,
// 0 for FFMA (0 and 0).
extern "C" int pbsed_conv2d_f32_design(int pass, int F, int Cin, int Cout,
                                       int kt, int kf, int* stages,
                                       int* smem) {
  *stages = 0;
  *smem = 0;
  const int lo_f = (kf - 1) / 2;
  if (pass == 2) {
    const int design = f32_dw_design(F, Cin, Cout, kt, kf);
    if (design == 2) {
      *stages = kF32eDwStages;
      *smem = f32e_dw_smem(f32e_pick(F, Cin, Cout, kt, kf, lo_f, true),
                           Cout);
    } else if (design == 1) {
      *stages = conv2d_f32_dw_wgmma_stages(F, Cin, Cout, kt, kf);
      *smem = conv2d_f32_dw_wgmma_smem(F, Cin, Cout, kt, kf, *stages);
    }
    return design;
  }
  const int design = pass == 0 ? f32_fwd_design(F, Cin, Cout, kt, kf)
                               : f32_dx_design(F, Cin, Cout, kt, kf);
  const int c_in = pass == 0 ? Cin : Cout;
  const int n = pass == 0 ? Cout : Cin;
  if (design == 2) {
    *stages = kF32eFwdStages;
    *smem = f32e_fwd_smem(
        f32e_pick(F, c_in, n, kt, kf, pass == 0 ? lo_f : kf - 1 - lo_f,
                  false),
        n);
  } else if (design == 1) {
    *stages = conv2d_f32_wgmma_stages(F, c_in, n, kt, kf);
    *smem = conv2d_f32_wgmma_smem(F, c_in, n, kt, kf, *stages);
  }
  return design;
}

// The f32 floats of the buffer the weights of pass 0 (the forward, M
// members) or 1 (dx, M = 1) are split into: 2 M kt kf Cin Cout on 3xTF32,
// the entry kernels' image (conv2d_f32_entry_split_floats), 0 on FFMA and
// for pass 2 (dw splits no weights).
extern "C" long long pbsed_conv2d_f32_split_floats(int pass, int F, int Cin,
                                                   int Cout, int kt, int kf,
                                                   int M) {
  if (pass == 2) return 0;
  const int design = pass == 0 ? f32_fwd_design(F, Cin, Cout, kt, kf)
                               : f32_dx_design(F, Cin, Cout, kt, kf);
  if (design == 2)
    return pass == 0 ? conv2d_f32_entry_split_floats(Cin, Cout, kt, kf, M)
                     : conv2d_f32_entry_split_floats(Cout, Cin, kt, kf, M);
  if (design == 1) return 2LL * M * kt * kf * Cin * Cout;
  return 0;
}

// The dw pass's chunks at this shape on a card of `sms` SMs: the first
// dimension of pbsed_conv2d_same_f32_bwd's workspace.
extern "C" int pbsed_conv2d_f32_dw_chunks(int B, int T, int F, int Cin,
                                          int Cout, int kt, int kf, int sms) {
  return f32_dw_chunks(B, T, F, Cin, Cout, kt, kf, sms);
}

// Backward of pbsed_conv2d_same_f32 for one member: x (B, T, F, Cin) f32,
// gy (B, T, F, Cout) f32, w_flip (kt, kf, Cout, Cin) f32 (the weights
// flipped in both extents, channels transposed); dx (B, T, F, Cin) f32 or
// null (then no dx pass, and w_flip may be null), dw (kt, kf, Cin, Cout)
// f32, workspace (chunks, kt * kf * Cin, Cout) f32 with chunks =
// pbsed_conv2d_f32_dw_chunks(..., sms) for this card's sms, split
// pbsed_conv2d_f32_split_floats(1, ...) f32 where that is not 0 and dx is
// asked for, else may be null. Contiguous. Returns a cudaError_t.
extern "C" int pbsed_conv2d_same_f32_bwd(const void* x, const void* gy,
                                         const void* w_flip, void* dx,
                                         void* dw, void* workspace,
                                         void* split, int B, int T, int F,
                                         int Cin, int Cout, int kt, int kf,
                                         int sms, void* stream) {
  if (kt < 1 || kf < 1 || Cin < 1 || Cout < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long Mpix = static_cast<long long>(B) * T * F;
  const long long n = static_cast<long long>(kt) * kf * Cin * Cout;
  if (Mpix == 0)
    return static_cast<int>(cudaMemsetAsync(dw, 0, sizeof(float) * n, s));
  const int lo_t = (kt - 1) / 2;
  const int lo_f = (kf - 1) / 2;
  const float* xs = static_cast<const float*>(x);
  const float* gs = static_cast<const float*>(gy);
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) {
    // the forward's GEMM on gy with the flipped weights, pads mirrored
    const float* wf = static_cast<const float*>(w_flip);
    float* dxs = static_cast<float*>(dx);
    const int design = f32_dx_design(F, Cin, Cout, kt, kf);
    if (design != 0 && split == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (design == 2) {
      err = conv2d_f32_entry(gs, wf, split, nullptr, dxs, 1, B, T, F, Cout,
                             Cin, kt, kf, kt - 1 - lo_t, kf - 1 - lo_f, s);
    } else if (design == 1) {
      err = conv2d_f32_wgmma(gs, wf, split, nullptr, dxs, 1, B, T, F, Cout,
                             Cin, kt, kf, kt - 1 - lo_t, kf - 1 - lo_f, s);
    } else {
      err = conv2d_f32(gs, wf, nullptr, dxs, 1, B, T, F, Cout, Cin, kt, kf,
                       kt - 1 - lo_t, kf - 1 - lo_f, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = f32_dw_chunks(B, T, F, Cin, Cout, kt, kf, sms);
  float* part = static_cast<float*>(workspace);
  const int dw_design = f32_dw_design(F, Cin, Cout, kt, kf);
  if (dw_design == 2) {
    err = conv2d_f32_dw_entry(xs, gs, part, B, T, F, Cin, Cout, kt, kf,
                              chunks, s);
  } else if (dw_design == 1) {
    err = conv2d_f32_dw_wgmma(xs, gs, part, B, T, F, Cin, Cout, kt, kf,
                              lo_t, lo_f, chunks, s);
  } else {
    const long long len = f32_dw_chunk_len(B, T, F, Cin, Cout, kt, kf, sms);
    const int K = kt * kf * Cin;
    const int bn = f32_tile_n(Cout);
    const dim3 grid((K + kF32BM - 1) / kF32BM, (Cout + bn - 1) / bn, chunks);
    if (bn == 16)
      conv2d_f32_dw_kernel<16><<<grid, kF32Threads, 0, s>>>(
          xs, gs, part, T, F, Cin, Cout, kt, kf, lo_t, lo_f, Mpix, len);
    else if (bn == 32)
      conv2d_f32_dw_kernel<32><<<grid, kF32Threads, 0, s>>>(
          xs, gs, part, T, F, Cin, Cout, kt, kf, lo_t, lo_f, Mpix, len);
    else
      conv2d_f32_dw_kernel<64><<<grid, kF32Threads, 0, s>>>(
          xs, gs, part, T, F, Cin, Cout, kt, kf, lo_t, lo_f, Mpix, len);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  conv2d_f32_dw_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      part, static_cast<float*>(dw), chunks, n);
  return static_cast<int>(cudaGetLastError());
}
