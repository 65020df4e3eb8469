// The implicit-GEMM SAME convolution shared by the forward conv
// (conv2d.cu) and the input gradient of the backward (conv2d_bwd.cu):
//
//   y[p, n] = bf16(sum_{dt, df, c} x[p + (dt - ht, df - hf), c] * w[dt, df, c, n]
//                  + bias[n])
//
// on the channels-last (B, T, F, C) layout, bf16 operands, f32
// accumulation, one rounding to bf16. A block of 4 warps owns 64 output
// pixels x BN output channels. For each tap (dt, df) and each 16-channel
// slice of the input it stages a 64 x 16 input tile (zero-filled outside
// the image: the SAME halo) and a 16 x BN weight tile in shared memory,
// and each warp runs BN/16 bf16 tensor-core products (wmma 16x16x16, f32
// accumulators in registers). Input channels that are not a multiple of
// 16 (the Cin = 1 entry layer) are zero-padded inside the staged tile,
// output channels past N (dx of the entry layer has N = 1) inside the
// weight tile; the padded products add exact zeros and are never
// stored. Loads are 16 bytes wide where the channel counts are
// multiples of 8. There is no pipelining of the staging yet: a later
// change can double-buffer it with cp.async/TMA and move to wgmma.
//
// With AFFINE (the BN+ReLU-fused conv, conv2d.cu's
// pbsed_bnrelu_conv2d_same and the weight gradient of conv2d_bwd.cu) the
// input is staged through a = bf16(relu(f32(x) * scale[c] + shift[c])):
// the normalized, activated buffer never exists in device memory. The
// transform runs on in-image elements only; the SAME halo stays 0 (a
// positive shift must not light it up), as the TPU kernels' mask does
// after their affine (pb_sed_tpu/ops/pallas/conv.py:_stage_bnrelu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kIgemmBM = 64;       // output pixels per block: 4 warps x 16 rows
constexpr int kIgemmBK = 16;       // input channels per K step
constexpr int kIgemmThreads = 128;

// relu(v * s + t) with ONE f32 rounding of v * s + t (a fused
// multiply-add, as XLA computes the JAX package's affine and as the plain
// version does through float64), then one rounding to bf16; a NaN stays
// NaN as in torch.relu
__device__ __forceinline__ __nv_bfloat16 bnrelu(__nv_bfloat16 v, float s,
                                                float t) {
  const float a = __fmaf_rn(__bfloat162float(v), s, t);
  return __float2bfloat16(a < 0.f ? 0.f : a);
}

// Stage input channels [c, c + 8) of one pixel (src = its first channel)
// into dst: zeros outside the image (the SAME halo) and past Cin, else x,
// or bnrelu(x) with AFFINE. 16-byte loads where Cin % 8 == 0.
template <bool AFFINE>
__device__ __forceinline__ void stage_x8(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, int c,
                                         int Cin, bool inside, bool vec_in,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (inside && vec_in && c < Cin) {
    uint4 raw = *reinterpret_cast<const uint4*>(src + c);
    if constexpr (AFFINE) {
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = bnrelu(v[i], scale[c + i], shift[c + i]);
    }
    *reinterpret_cast<uint4*>(dst) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      __nv_bfloat16 v = zero;
      if (inside && c + i < Cin) {
        v = src[c + i];
        if constexpr (AFFINE) v = bnrelu(v, scale[c + i], shift[c + i]);
      }
      dst[i] = v;
    }
  }
}

template <int BN, bool AFFINE>
__global__ void __launch_bounds__(kIgemmThreads)
conv2d_igemm_kernel(const __nv_bfloat16* __restrict__ x,  // (B, T, F, Cin)
                    const __nv_bfloat16* __restrict__ w,  // (kt, kf, Cin, N)
                    const float* __restrict__ bias,       // (N,) or null
                    const float* __restrict__ scale,      // (Cin,) if AFFINE
                    const float* __restrict__ shift,      // (Cin,) if AFFINE
                    __nv_bfloat16* __restrict__ y,        // (B, T, F, N)
                    int T, int F, int Cin, int N, int kt, int kf,
                    long long M) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 a_tile[kIgemmBM * kIgemmBK];
  __shared__ __align__(128) __nv_bfloat16 b_tile[kIgemmBK * BN];
  __shared__ __align__(128) float c_tile[kIgemmBM * BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kIgemmBM;
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
  const bool vec_w = (N % 8) == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int ht = (kt - 1) / 2;
  const int hf = (kf - 1) / 2;
  const int k_slices = (Cin + kIgemmBK - 1) / kIgemmBK;
  for (int dt = 0; dt < kt; ++dt) {
    for (int df = 0; df < kf; ++df) {
      const int st = pt + dt - ht;
      const int sf = pf + df - hf;
      const bool inside = p_ok && st >= 0 && st < T && sf >= 0 && sf < F;
      const long long src_off =
          inside ? ((static_cast<long long>(pb) * T + st) * F + sf) * Cin : 0;
      const __nv_bfloat16* w_tap =
          w + static_cast<long long>(dt * kf + df) * Cin * N;
      for (int ks = 0; ks < k_slices; ++ks) {
        const int c0 = ks * kIgemmBK;
        stage_x8<AFFINE>(a_tile + a_row * kIgemmBK + a_col, x + src_off,
                         c0 + a_col, Cin, inside, vec_in, scale, shift);
        for (int v = tid; v < kIgemmBK * BN / 8; v += kIgemmThreads) {
          const int r = v / (BN / 8);
          const int col = (v % (BN / 8)) * 8;
          __nv_bfloat16* b_dst = b_tile + r * BN + col;
          const __nv_bfloat16* src =
              w_tap + static_cast<long long>(c0 + r) * N + n0 + col;
          if (vec_w) {
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (c0 + r < Cin && n0 + col < N)
              val = *reinterpret_cast<const uint4*>(src);
            *reinterpret_cast<uint4*>(b_dst) = val;
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              b_dst[i] = (c0 + r < Cin && n0 + col + i < N) ? src[i] : zero;
          }
        }
        __syncthreads();
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a_frag;
        wmma::load_matrix_sync(a_frag, a_tile + warp * 16 * kIgemmBK,
                               kIgemmBK);
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
  for (int e = tid; e < kIgemmBM * BN; e += kIgemmThreads) {
    const int r = e / BN;
    const int col = e % BN;
    const long long q = m0 + r;
    if (q < M && n0 + col < N) {
      const float b = bias == nullptr ? 0.f : bias[n0 + col];
      y[q * N + n0 + col] = __float2bfloat16(c_tile[e] + b);
    }
  }
}

template <int BN, bool AFFINE>
cudaError_t conv2d_igemm_launch(const void* x, const void* w, const void* b,
                                const float* scale, const float* shift,
                                void* y, int B, int T, int F, int Cin, int N,
                                int kt, int kf, cudaStream_t stream) {
  const long long M = static_cast<long long>(B) * T * F;
  const dim3 grid(static_cast<unsigned>((M + kIgemmBM - 1) / kIgemmBM),
                  (N + BN - 1) / BN);
  conv2d_igemm_kernel<BN, AFFINE><<<grid, kIgemmThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      scale, shift, static_cast<__nv_bfloat16*>(y), T, F, Cin, N, kt, kf, M);
  return cudaGetLastError();
}

template <bool AFFINE>
cudaError_t conv2d_igemm_n(const void* x, const void* w, const void* b,
                           const float* scale, const float* shift, void* y,
                           int B, int T, int F, int Cin, int N, int kt,
                           int kf, cudaStream_t stream) {
  if (N % 64 == 0)
    return conv2d_igemm_launch<64, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                           Cin, N, kt, kf, stream);
  if (N % 32 == 0)
    return conv2d_igemm_launch<32, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                           Cin, N, kt, kf, stream);
  return conv2d_igemm_launch<16, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                         Cin, N, kt, kf, stream);
}

// y = conv(x, w) [+ b] for any N >= 1: the widest tile that divides N,
// 16 (masked) below that. With scale and shift (both (Cin,) f32) the
// input is staged through bnrelu (the BN+ReLU-fused conv).
inline cudaError_t conv2d_igemm(const void* x, const void* w, const void* b,
                                void* y, int B, int T, int F, int Cin, int N,
                                int kt, int kf, cudaStream_t stream,
                                const float* scale = nullptr,
                                const float* shift = nullptr) {
  if (scale != nullptr)
    return conv2d_igemm_n<true>(x, w, b, scale, shift, y, B, T, F, Cin, N,
                                kt, kf, stream);
  return conv2d_igemm_n<false>(x, w, b, nullptr, nullptr, y, B, T, F, Cin, N,
                               kt, kf, stream);
}

}  // namespace
