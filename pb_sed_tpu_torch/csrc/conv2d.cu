// Stride-1 SAME 2-D convolution with an odd kt x kf kernel on the
// channels-last (B, T, F, C) layout, bf16 operands, f32 accumulation.
//
// Replaces: pb_sed_tpu/ops/pallas/conv.py:_fwd_kernel (the packed
// implicit GEMM reached through _fwd_packed / conv2d_packed_fm). The
// result is the same function: y = bf16(sum_taps x * w (f32) + bias),
// with the f32 bias added before the single rounding to bf16.
//
// What bounds it on the H100: the shallow tower's layers are small GEMMs
// (M = B*T*F output pixels, N = Cout in 16..256, K = kt*kf*Cin in
// 9..1152). The narrow early layers (Cin, Cout <= 32) are bound by the
// bytes of the activations; the wide late ones by tensor-core throughput.
//
// What the design does about it: an implicit GEMM that never writes the
// im2col patch to device memory. A block of 4 warps owns 64 output pixels
// x BN output channels. For each tap (dt, df) and each 16-channel slice
// of Cin it stages a 64 x 16 input tile (zero-filled outside the image:
// the SAME halo) and a 16 x BN weight tile in shared memory, and each
// warp runs BN/16 bf16 tensor-core products (wmma 16x16x16, f32
// accumulators in registers). Cin that is not a multiple of 16 (the
// Cin = 1 entry layer) is zero-padded inside the staged tile; the padded
// products add exact zeros, so the result equals the unpadded conv.
// Loads are 16 bytes wide where Cin % 8 == 0. There is no pipelining of
// the staging yet: a later change can double-buffer it with cp.async/TMA
// and move to wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 64;       // output pixels per block: 4 warps x 16 rows
constexpr int kBK = 16;       // input channels per K step
constexpr int kThreads = 128;

template <int BN>
__global__ void __launch_bounds__(kThreads)
conv2d_same_kernel(const __nv_bfloat16* __restrict__ x,   // (B, T, F, Cin)
                   const __nv_bfloat16* __restrict__ w,   // (kt, kf, Cin, Cout)
                   const float* __restrict__ bias,        // (Cout,)
                   __nv_bfloat16* __restrict__ y,         // (B, T, F, Cout)
                   int T, int F, int Cin, int Cout, int kt, int kf,
                   long long M) {
  __shared__ __align__(128) __nv_bfloat16 a_tile[kBM * kBK];
  __shared__ __align__(128) __nv_bfloat16 b_tile[kBK * BN];
  __shared__ __align__(128) float c_tile[kBM * BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  // input staging: each thread owns one output pixel and 8 of the 16
  // channels of the current K slice
  const int a_row = tid >> 1;
  const int a_col = (tid & 1) * 8;
  const long long p = m0 + a_row;
  const bool p_ok = p < M;
  int pb = 0, pt = 0, pf = 0;
  if (p_ok) {
    pf = static_cast<int>(p % F);
    const long long q = p / F;
    pt = static_cast<int>(q % T);
    pb = static_cast<int>(q / T);
  }
  const bool vec_in = (Cin % 8) == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int ht = (kt - 1) / 2;
  const int hf = (kf - 1) / 2;
  const int k_slices = (Cin + kBK - 1) / kBK;
  for (int dt = 0; dt < kt; ++dt) {
    for (int df = 0; df < kf; ++df) {
      const int st = pt + dt - ht;
      const int sf = pf + df - hf;
      const bool inside = p_ok && st >= 0 && st < T && sf >= 0 && sf < F;
      const long long src_off =
          inside ? ((static_cast<long long>(pb) * T + st) * F + sf) * Cin : 0;
      const __nv_bfloat16* w_tap =
          w + static_cast<long long>(dt * kf + df) * Cin * Cout;
      for (int ks = 0; ks < k_slices; ++ks) {
        const int c0 = ks * kBK;
        __nv_bfloat16* a_dst = a_tile + a_row * kBK + a_col;
        const int c = c0 + a_col;
        if (inside && vec_in && c < Cin) {
          *reinterpret_cast<uint4*>(a_dst) =
              *reinterpret_cast<const uint4*>(x + src_off + c);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a_dst[i] = (inside && c + i < Cin) ? x[src_off + c + i] : zero;
        }
        for (int v = tid; v < kBK * BN / 8; v += kThreads) {
          const int r = v / (BN / 8);
          const int col = (v % (BN / 8)) * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (c0 + r < Cin)
            val = *reinterpret_cast<const uint4*>(
                w_tap + static_cast<long long>(c0 + r) * Cout + n0 + col);
          *reinterpret_cast<uint4*>(b_tile + r * BN + col) = val;
        }
        __syncthreads();
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a_frag;
        wmma::load_matrix_sync(a_frag, a_tile + warp * 16 * kBK, kBK);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b_frag;
          wmma::load_matrix_sync(b_frag, b_tile + j * 16, BN);
          wmma::mma_sync(acc[j], a_frag, b_frag, acc[j]);
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(c_tile + warp * 16 * BN + j * 16, acc[j], BN,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * BN; e += kThreads) {
    const int r = e / BN;
    const int col = e % BN;
    const long long q = m0 + r;
    if (q < M)
      y[q * Cout + n0 + col] = __float2bfloat16(c_tile[e] + bias[n0 + col]);
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   int B, int T, int F, int Cin, int Cout, int kt, int kf,
                   cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * T * F;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), Cout / BN);
  conv2d_same_kernel<BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y), T, F, Cin, Cout, kt, kf, M);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, F, Cin) bf16, w (kt, kf, Cin, Cout) bf16, b (Cout,) f32,
// y (B, T, F, Cout) bf16; all contiguous and 16-byte aligned.
// Requires odd kt and kf and Cout % 16 == 0. Returns a cudaError_t.
extern "C" int pbsed_conv2d_same(const void* x, const void* w, const void* b,
                                 void* y, int B, int T, int F, int Cin,
                                 int Cout, int kt, int kf, void* stream) {
  if (kt % 2 == 0 || kf % 2 == 0 || Cout % 16 != 0 || Cin < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * F == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Cout % 64 == 0)
    err = launch<64>(x, w, b, y, B, T, F, Cin, Cout, kt, kf, s);
  else if (Cout % 32 == 0)
    err = launch<32>(x, w, b, y, B, T, F, Cin, Cout, kt, kf, s);
  else
    err = launch<16>(x, w, b, y, B, T, F, Cin, Cout, kt, kf, s);
  return static_cast<int>(err);
}
