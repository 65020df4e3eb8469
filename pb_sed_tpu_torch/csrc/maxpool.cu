// (2, 1) frequency max-pool on the channels-last (B, T, F, C) layout:
// y[b, t, f, c] = max(x[b, t, 2f, c], x[b, t, 2f + 1, c]), bf16 in and out,
// and its backward: the cotangent goes to the row that won, ties (and a
// NaN in the second row) to the FIRST row.
//
// Replaces: pb_sed_tpu/ops/pallas/conv.py:_pool_fwd_kernel (reached
// through _pool_fwd / maxpool2_rows_packed), the row-pair max of the
// freq-major packed tower, and conv.py:_pool_bwd_kernel (its custom VJP,
// _pool_vjp_bwd): keep = f32(a) >= f32(b), dx_a = keep ? gy : 0,
// dx_b = keep ? 0 : gy, in bf16.
//
// What bounds it on the H100: both are pure data movement (forward 1.5
// bytes moved per input byte, backward 2.5), so device-memory bandwidth.
//
// What the design does about it: with F = 2 * Fo, output row
// r = (b * T + t) * Fo + f reads input rows 2r and 2r + 1, so the pool is a
// max over adjacent C-vectors of a (R, 2, C) view: one contiguous read
// stream and one write stream. The forward (maxpool_freq2_stream) moves
// one 16-byte vector (8 channels) of each row a thread, with 32-bit
// positions and streaming cache hints (__ldcs / __stcs: every byte is
// touched once), in as many blocks of 256 as there are vectors. Measured
// on an H100 (CUDA-graph replay, B = 32, T = 500, the 8 pools of both
// towers) it moves its bytes at 0.87 of the card's 3.35 TB/s, where a
// plain 2-read-1-write stream reaches about the same; grids of one wave
// that loop over 4 or 8 vectors a thread, with or without the hints,
// reached 0.81-0.84. A scalar path takes C % 8 != 0. The compare
// follows PyTorch's maximum on the card (NaN wins, otherwise the first
// operand unless it is smaller), so the kernel is bit-exact against the
// plain torch.maximum version.
// The backward walks the same view: per output vector it reads both
// input rows and the cotangent and writes both rows of dx, bit-exact
// against maxpool_freq2_bwd_plain.
//
// pbsed_maxpool2d / pbsed_maxpool2d_bwd are the max pool of any (pt, pf)
// window with stride the window, VALID (floor in both axes), bf16 or f32:
// what CNN2d runs at every pool that is not (2, 1) on an even F (a time
// pool, a scalar pool, (4, 1), an odd F) and CNN1d at its time pools (its
// f32 values, with F = 1). Replaces: no Pallas kernel of its own; the
// JAX package runs these pools unpacked as nn.max_pool (XLA's
// reduce_window max and, backward, its select_and_scatter with a >=
// select), outside its packed window (pb_sed_tpu/ops/cnn.py:_pool2d,
// CNN1d.__call__), and the TPU kernel it generalises is the one above
// (conv.py:_pool_fwd_kernel, _pool_bwd_kernel). The forward folds the
// window in (t, f) order with the compare above (PyTorch's maximum on the
// card), so it is bit-exact against the plain fold of torch.maximum; the
// backward walks the window in the same order and keeps the first element
// unless a later one is not <= it (XLA's >= select: ties to the first in
// (t, f) order), gives it the cotangent and every other element of the
// window, and the rows and columns past the last whole window, a zero.
// Bound: bytes, as above. Design: one thread per output element and 16
// bytes of channels (8 bf16 or 4 f32; a scalar path when C is not a
// multiple), which walks its window with 16-byte loads; the backward
// writes the whole window, and the rows and columns no window covers are
// zeroed by one memset first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ __nv_bfloat16 max_bf16(__nv_bfloat16 a,
                                                  __nv_bfloat16 b) {
  const float fa = __bfloat162float(a);
  const float fb = __bfloat162float(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fa < fb ? b : a;
}

// The forward as one read stream and one write stream over the (R, 2, V)
// view (V = C / 8 vectors of 16 bytes): output vector e = rV + v is the
// max of input vectors 2rV + v = e + rV and e + rV + V. One output vector
// a thread, 32-bit positions (the entry point keeps 2 R V below 2^31),
// both loads issued before the compare, streaming cache hints.
__global__ void __launch_bounds__(kThreads)
maxpool_freq2_stream(const uint4* __restrict__ x, uint4* __restrict__ y,
                     int n, int V) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const uint4* p = x + e + (e / V) * V;
  const uint4 a = __ldcs(p);
  const uint4 b = __ldcs(p + V);
  const __nv_bfloat16* pa = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* pb = reinterpret_cast<const __nv_bfloat16*>(&b);
  uint4 out;
  __nv_bfloat16* po = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) po[i] = max_bf16(pa[i], pb[i]);
  __stcs(y + e, out);
}

__global__ void __launch_bounds__(kThreads)
maxpool_freq2_scalar(const __nv_bfloat16* __restrict__ x,
                     __nv_bfloat16* __restrict__ y, long long rows_out,
                     int C) {
  const long long n = rows_out * C;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / C;
    const int c = static_cast<int>(e % C);
    y[e] = max_bf16(x[(2 * r) * C + c], x[(2 * r + 1) * C + c]);
  }
}

__device__ __forceinline__ void route_bf16(__nv_bfloat16 a, __nv_bfloat16 b,
                                           __nv_bfloat16 g,
                                           __nv_bfloat16* da,
                                           __nv_bfloat16* db) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const bool keep = __bfloat162float(a) >= __bfloat162float(b);
  *da = keep ? g : zero;
  *db = keep ? zero : g;
}

__global__ void __launch_bounds__(kThreads)
maxpool_freq2_bwd_vec8(const uint4* __restrict__ x, const uint4* __restrict__ gy,
                       uint4* __restrict__ dx, long long rows_out,
                       int vecs_per_row) {
  const long long n = rows_out * vecs_per_row;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / vecs_per_row;
    const int v = static_cast<int>(e % vecs_per_row);
    const long long ia = (2 * r) * vecs_per_row + v;
    const long long ib = (2 * r + 1) * vecs_per_row + v;
    const uint4 a = x[ia];
    const uint4 b = x[ib];
    const uint4 g = gy[e];
    const __nv_bfloat16* pa = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* pb = reinterpret_cast<const __nv_bfloat16*>(&b);
    const __nv_bfloat16* pg = reinterpret_cast<const __nv_bfloat16*>(&g);
    uint4 oa, ob;
    __nv_bfloat16* qa = reinterpret_cast<__nv_bfloat16*>(&oa);
    __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(&ob);
#pragma unroll
    for (int i = 0; i < 8; ++i) route_bf16(pa[i], pb[i], pg[i], qa + i, qb + i);
    dx[ia] = oa;
    dx[ib] = ob;
  }
}

__global__ void __launch_bounds__(kThreads)
maxpool_freq2_bwd_scalar(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ gy,
                         __nv_bfloat16* __restrict__ dx, long long rows_out,
                         int C) {
  const long long n = rows_out * C;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / C;
    const int c = static_cast<int>(e % C);
    const long long ia = (2 * r) * C + c;
    const long long ib = (2 * r + 1) * C + c;
    route_bf16(x[ia], x[ib], gy[e], dx + ia, dx + ib);
  }
}

long long grid_blocks(long long rows_out, int C) {
  const long long work = (C % 8 == 0) ? rows_out * (C / 8) : rows_out * C;
  const long long blocks = (work + kThreads - 1) / kThreads;
  return blocks > 65535LL * 32 ? 65535LL * 32 : blocks;  // grid-stride beyond
}

}  // namespace

// x (B, T, F, C) bf16 with F even, y (B, T, F / 2, C) bf16; contiguous and
// 16-byte aligned. rows_out = B * T * (F / 2). Returns a cudaError_t.
extern "C" int pbsed_maxpool_freq2(const void* x, void* y, long long rows_out,
                                   int C, void* stream) {
  if (rows_out < 0 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_out == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 != 0) {
    const long long blocks = grid_blocks(rows_out, C);
    maxpool_freq2_scalar<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), rows_out, C);
    return static_cast<int>(cudaGetLastError());
  }
  // launches of at most 2^29 output vectors keep the kernel's 32-bit
  // positions (2 R V) below 2^31; one launch at every shape of the recipes
  const int V = C / 8;
  const long long max_rows = (1LL << 29) / V;
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* yv = static_cast<uint4*>(y);
  for (long long r0 = 0; r0 < rows_out; r0 += max_rows) {
    const long long rows =
        rows_out - r0 < max_rows ? rows_out - r0 : max_rows;
    const int n = static_cast<int>(rows * V);
    maxpool_freq2_stream<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        xv + 2 * r0 * V, yv + r0 * V, n, V);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// x (B, T, F, C) bf16 with F even, gy (B, T, F / 2, C) bf16, dx (B, T, F,
// C) bf16; contiguous and 16-byte aligned. rows_out = B * T * (F / 2).
// Returns a cudaError_t.
extern "C" int pbsed_maxpool_freq2_bwd(const void* x, const void* gy,
                                       void* dx, long long rows_out, int C,
                                       void* stream) {
  if (rows_out < 0 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_out == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = grid_blocks(rows_out, C);
  if (C % 8 == 0) {
    maxpool_freq2_bwd_vec8<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(gy),
        static_cast<uint4*>(dx), rows_out, C / 8);
  } else {
    maxpool_freq2_bwd_scalar<<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gy),
        static_cast<__nv_bfloat16*>(dx), rows_out, C);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

__device__ __forceinline__ float f32_of(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float f32_of(float v) { return v; }

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}

// PyTorch's maximum on the card, as max_bf16 above: NaN wins, otherwise
// the first operand unless it is smaller
template <typename T>
__device__ __forceinline__ T max_of(T a, T b) {
  const float fa = f32_of(a);
  const float fb = f32_of(b);
  if (fa != fa) return a;
  if (fb != fb) return b;
  return fa < fb ? b : a;
}

// VEC channels of one pixel, moved as one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The first element of output element e's window (e counts (b, to, fo)
// pixels and the C / VEC channel groups of each) and that element's row
__device__ __forceinline__ long long window_origin(long long e, int cv,
                                                  int VEC, int T, int F,
                                                  int To, int Fo, int pt,
                                                  int pf, int C,
                                                  long long* r) {
  const int c = static_cast<int>(e % cv) * VEC;
  *r = e / cv;
  const int fo = static_cast<int>(*r % Fo);
  const long long q = *r / Fo;
  const int to = static_cast<int>(q % To);
  const long long b = q / To;
  return ((b * T + static_cast<long long>(to) * pt) * F +
          static_cast<long long>(fo) * pf) * C + c;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
maxpool2d_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                 int Tin, int F, int C, int To, int Fo, int pt, int pf) {
  using P = Pack<T, VEC>;
  const int cv = C / VEC;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    long long r;
    const long long o =
        window_origin(e, cv, VEC, Tin, F, To, Fo, pt, pf, C, &r);
    P m = *reinterpret_cast<const P*>(x + o);
    for (int dt = 0; dt < pt; ++dt) {
      for (int df = dt == 0 ? 1 : 0; df < pf; ++df) {
        const P v = *reinterpret_cast<const P*>(
            x + o + (static_cast<long long>(dt) * F + df) * C);
#pragma unroll
        for (int i = 0; i < VEC; ++i) m.v[i] = max_of(m.v[i], v.v[i]);
      }
    }
    *reinterpret_cast<P*>(y + r * C + (e % cv) * VEC) = m;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
maxpool2d_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                     T* __restrict__ dx, long long n, int Tin, int F, int C,
                     int To, int Fo, int pt, int pf) {
  using P = Pack<T, VEC>;
  const int cv = C / VEC;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    long long r;
    const long long o =
        window_origin(e, cv, VEC, Tin, F, To, Fo, pt, pf, C, &r);
    float best[VEC];
    int sel[VEC];
    int k = 0;
    for (int dt = 0; dt < pt; ++dt) {
      for (int df = 0; df < pf; ++df, ++k) {
        const P v = *reinterpret_cast<const P*>(
            x + o + (static_cast<long long>(dt) * F + df) * C);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float f = f32_of(v.v[i]);
          // XLA's >= select: the kept element stays unless it is not >=
          if (k == 0 || !(best[i] >= f)) {
            best[i] = f;
            sel[i] = k;
          }
        }
      }
    }
    const P g = *reinterpret_cast<const P*>(gy + r * C + (e % cv) * VEC);
    k = 0;
    for (int dt = 0; dt < pt; ++dt) {
      for (int df = 0; df < pf; ++df, ++k) {
        P out;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          out.v[i] = sel[i] == k ? g.v[i] : zero_of<T>();
        *reinterpret_cast<P*>(
            dx + o + (static_cast<long long>(dt) * F + df) * C) = out;
      }
    }
  }
}

unsigned pool_blocks(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > 65535LL * 32 ? 65535LL * 32
                                                     : blocks);
}

template <typename T>
cudaError_t maxpool2d_launch(const void* x, const void* gy, void* out,
                             int B, int Tin, int F, int C, int pt, int pf,
                             cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int To = Tin / pt;
  const int Fo = F / pf;
  const long long pixels = static_cast<long long>(B) * To * Fo;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (gy != nullptr && (Tin % pt != 0 || F % pf != 0)) {
    // the rows and columns past the last whole window get no gradient
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(B) * Tin * F * C * sizeof(T), s);
    if (err != cudaSuccess) return err;
  }
  if (pixels == 0) return cudaGetLastError();
  if (C % kVec == 0) {
    const long long n = pixels * (C / kVec);
    if (gy == nullptr)
      maxpool2d_kernel<T, kVec><<<pool_blocks(n), kThreads, 0, s>>>(
          xt, ot, n, Tin, F, C, To, Fo, pt, pf);
    else
      maxpool2d_bwd_kernel<T, kVec><<<pool_blocks(n), kThreads, 0, s>>>(
          xt, static_cast<const T*>(gy), ot, n, Tin, F, C, To, Fo, pt, pf);
  } else {
    const long long n = pixels * C;
    if (gy == nullptr)
      maxpool2d_kernel<T, 1><<<pool_blocks(n), kThreads, 0, s>>>(
          xt, ot, n, Tin, F, C, To, Fo, pt, pf);
    else
      maxpool2d_bwd_kernel<T, 1><<<pool_blocks(n), kThreads, 0, s>>>(
          xt, static_cast<const T*>(gy), ot, n, Tin, F, C, To, Fo, pt, pf);
  }
  return cudaGetLastError();
}

int maxpool2d_entry(const void* x, const void* gy, void* out, int x_f32,
                    int B, int T, int F, int C, int pt, int pf,
                    void* stream) {
  if (B < 0 || T < 0 || F < 0 || C < 1 || pt < 1 || pf < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_f32 ? maxpool2d_launch<float>(x, gy, out, B, T, F, C, pt, pf, s)
            : maxpool2d_launch<__nv_bfloat16>(x, gy, out, B, T, F, C, pt, pf,
                                              s));
}

}  // namespace

// x (B, T, F, C) bf16 (x_f32 = 0) or f32 (x_f32 = 1), y (B, T / pt,
// F / pf, C) of the same type (floor in both axes); contiguous and
// 16-byte aligned. Returns a cudaError_t.
extern "C" int pbsed_maxpool2d(const void* x, int x_f32, void* y, int B,
                               int T, int F, int C, int pt, int pf,
                               void* stream) {
  return maxpool2d_entry(x, nullptr, y, x_f32, B, T, F, C, pt, pf, stream);
}

// x (B, T, F, C) bf16 or f32 as x_f32 says, gy (B, T / pt, F / pf, C) and
// dx (B, T, F, C) of the same type; contiguous and 16-byte aligned.
// Returns a cudaError_t.
extern "C" int pbsed_maxpool2d_bwd(const void* x, const void* gy, void* dx,
                                   int x_f32, int B, int T, int F, int C,
                                   int pt, int pf, void* stream) {
  if (gy == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return maxpool2d_entry(x, gy, dx, x_f32, B, T, F, C, pt, pf, stream);
}
