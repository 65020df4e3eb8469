// (2, 1) frequency average pool of a residual on the channels-last
// (B, T, F, C) layout, f32 out, with the channel zero-pad of the residual
// match fused in:
//
//   y[b, t, f, c] = (f32(x[b, t, 2f, c]) + f32(x[b, t, 2f + 1, c])) * 0.5
//                   for c < C, and 0 for C <= c < Cout,
//
// from a bf16 or f32 input, and its backward:
//
//   dx[b, t, 2f, c] = dx[b, t, 2f + 1, c] = cast(gy[b, t, f, c] * 0.5), c < C
//
// in the input's type (gy is f32 with Cout channels; the padded ones get
// no gradient).
//
// Replaces: pb_sed_tpu/ops/pallas/conv.py:_avg_fwd_kernel (reached through
// _avg_fwd / avgpool2_rows_packed, the row-pair mean that matches a
// residual across a (2, 1) pool in cnn.py:_match_residual_packed) and
// conv.py:_avg_bwd_kernel (its custom VJP, _avg_vjp_bwd). Both state that
// they are bit-identical to XLA's mean: one f32 add of two exactly
// representable values and an exact halving, one rounding on the way
// back; this kernel does the same operations, so it is bit-exact against
// the plain versions (avgpool_freq2_plain, avgpool_freq2_bwd_plain).
//
// What bounds it on the H100: pure data movement (forward: read 2 rows of
// C, write one of Cout f32; backward: read one of C f32, write 2 rows),
// so device-memory bandwidth.
//
// What the design does about it: with F = 2 * Fo, output row
// r = (b * T + t) * Fo + f reads input rows 2r and 2r + 1 of a (R, 2, C)
// view. Each thread moves 8 channels: 16-byte loads (one per row of bf16,
// two per row of f32) and two 16-byte f32 stores; the padded channels are
// written as zeros in the same pass, so the residual never needs a
// separate pad. Scalar path when C or Cout is not a multiple of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
avgpool_freq2_vec8(const T* __restrict__ x, float* __restrict__ y,
                   long long rows_out, int C, int Cout) {
  const int vecs = Cout / 8;
  const long long n = rows_out * vecs;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / vecs;
    const int c = static_cast<int>(e % vecs) * 8;
    float out[8];
    if (c < C) {
      float a[8], b[8];
      load8(x + (2 * r) * C + c, a);
      load8(x + (2 * r + 1) * C + c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = (a[i] + b[i]) * 0.5f;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = 0.f;
    }
    store8(y + r * Cout + c, out);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
avgpool_freq2_scalar(const T* __restrict__ x, float* __restrict__ y,
                     long long rows_out, int C, int Cout) {
  const long long n = rows_out * Cout;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / Cout;
    const int c = static_cast<int>(e % Cout);
    y[e] = c < C ? (to_f32(x[(2 * r) * C + c]) + to_f32(x[(2 * r + 1) * C + c]))
                       * 0.5f
                 : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
avgpool_freq2_bwd_vec8(const float* __restrict__ gy, T* __restrict__ dx,
                       long long rows_out, int C, int Cout) {
  const int vecs = C / 8;
  const long long n = rows_out * vecs;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / vecs;
    const int c = static_cast<int>(e % vecs) * 8;
    float g[8];
    load8(gy + r * Cout + c, g);
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] *= 0.5f;
    store8(dx + (2 * r) * C + c, g);
    store8(dx + (2 * r + 1) * C + c, g);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
avgpool_freq2_bwd_scalar(const float* __restrict__ gy, T* __restrict__ dx,
                         long long rows_out, int C, int Cout) {
  const long long n = rows_out * C;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / C;
    const int c = static_cast<int>(e % C);
    const float g = gy[r * Cout + c] * 0.5f;
    from_f32(g, dx + (2 * r) * C + c);
    from_f32(g, dx + (2 * r + 1) * C + c);
  }
}

unsigned grid_blocks(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > 65535LL * 32 ? 65535LL * 32
                                                     : blocks);
}

template <typename T>
void launch_fwd(const void* x, void* y, long long rows_out, int C, int Cout,
                cudaStream_t s) {
  if (C % 8 == 0 && Cout % 8 == 0) {
    avgpool_freq2_vec8<T><<<grid_blocks(rows_out * (Cout / 8)), kThreads, 0,
                            s>>>(static_cast<const T*>(x),
                                 static_cast<float*>(y), rows_out, C, Cout);
  } else {
    avgpool_freq2_scalar<T><<<grid_blocks(rows_out * Cout), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<float*>(y), rows_out, C, Cout);
  }
}

template <typename T>
void launch_bwd(const void* gy, void* dx, long long rows_out, int C, int Cout,
                cudaStream_t s) {
  if (C % 8 == 0 && Cout % 8 == 0) {
    avgpool_freq2_bwd_vec8<T><<<grid_blocks(rows_out * (C / 8)), kThreads, 0,
                                s>>>(static_cast<const float*>(gy),
                                     static_cast<T*>(dx), rows_out, C, Cout);
  } else {
    avgpool_freq2_bwd_scalar<T><<<grid_blocks(rows_out * C), kThreads, 0, s>>>(
        static_cast<const float*>(gy), static_cast<T*>(dx), rows_out, C, Cout);
  }
}

}  // namespace

// x (B, T, F, C) bf16 (x_f32 = 0) or f32 (x_f32 = 1) with F even,
// y (B, T, F / 2, Cout) f32 with Cout >= C; contiguous and 16-byte aligned.
// rows_out = B * T * (F / 2). Returns a cudaError_t.
extern "C" int pbsed_avgpool_freq2(const void* x, int x_f32, void* y,
                                   long long rows_out, int C, int Cout,
                                   void* stream) {
  if (rows_out < 0 || C < 1 || Cout < C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_out == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_f32)
    launch_fwd<float>(x, y, rows_out, C, Cout, s);
  else
    launch_fwd<__nv_bfloat16>(x, y, rows_out, C, Cout, s);
  return static_cast<int>(cudaGetLastError());
}

// gy (B, T, F / 2, Cout) f32, dx (B, T, F, C) bf16 (dx_f32 = 0) or f32
// (dx_f32 = 1) with Cout >= C; contiguous and 16-byte aligned.
// rows_out = B * T * (F / 2). Returns a cudaError_t.
extern "C" int pbsed_avgpool_freq2_bwd(const void* gy, void* dx, int dx_f32,
                                       long long rows_out, int C, int Cout,
                                       void* stream) {
  if (rows_out < 0 || C < 1 || Cout < C)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_out == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dx_f32)
    launch_bwd<float>(gy, dx, rows_out, C, Cout, s);
  else
    launch_bwd<__nv_bfloat16>(gy, dx, rows_out, C, Cout, s);
  return static_cast<int>(cudaGetLastError());
}
