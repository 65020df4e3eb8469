// Backward of the stride-1 SAME conv (conv2d.cu) on the channels-last
// (B, T, F, C) layout: the input gradient dx (bf16) and the weight
// gradient dw (f32) from the forward input x and the bf16 cotangent gy.
// The bias gradient is an f32 sum of gy taken outside (as the JAX
// package does, pb_sed_tpu/ops/pallas/conv.py:959-962).
//
// Replaces: pb_sed_tpu/ops/pallas/conv.py:_bwd_kernel (fused dx + dw,
// the shallow tower's layers 1-8) and the channel-blocked split pair
// _bwd_dx_kernel_cb / _bwd_dw_kernel_cb (layer 9, 128 -> 256, where
// _cb_bwd_of gives 128). The blocking of those variants is a TPU VMEM
// strategy; all three compute the same dx and dw, which this one entry
// point computes in three launches:
//
//   1. dx = SAME conv of gy with the spatially flipped, channel-
//      transposed weights (conv.py:835-836): f32 accumulation, one
//      rounding to bf16, no bias. It runs the forward's implicit GEMM
//      (conv2d_igemm.cuh) with N = Cin output channels, masked where
//      Cin is not a multiple of 16 (Cin = 1 at the entry layer).
//   2. dw partials: dw[dt, df, ci, co] = sum_p x[p + (dt - ht, df - hf), ci]
//      * gy[p, co] is a reduction over up to B*T*F = 2,048,000 pixels
//      (layers 1-2 at 32 ten-second clips). The TPU kernel accumulated
//      it across its sequential grid; CUDA blocks run in no order, so
//      each block reduces one chunk of pixels for all taps of one
//      (16 input channels) x (CO_T output channels) tile into its own
//      slot of an f32 workspace (chunks, kt*kf, Cin_pad, Cout).
//   3. a deterministic reduce over the chunks in a fixed order: two runs
//      give bit-identical dw (no float atomics).
//
// What bounds it on the H100: dw moves x and gy once from device memory
// (x is re-read kt*kf times, shifted, from L1/L2) and does
// 2*kt*kf*Cin*Cout flops per pixel; the narrow early layers are bound by
// the activation bytes, the wide late ones by the tensor cores. dx is
// the forward's GEMM with the roles of Cin and Cout swapped.
//
// What the design does about it: per stage a block stages 64 pixels of
// gy (64 x CO_T bf16) once and the kt*kf shifted 64 x 16 x tiles (zero
// halo), and its 4 warps run bf16 tensor-core products (wmma 16x16x16,
// f32 accumulators) for every (tap, 16-column) pair of the tile, so gy
// is read once for all taps. The chunk count is chosen so that about
// four blocks per SM run. No pipelining of the staging yet.
#include "conv2d_igemm.cuh"

namespace {

constexpr int kDwPx = 64;         // pixels per staged K step
constexpr int kDwThreads = 128;   // 4 warps
constexpr int kDwMaxTaps = 9;     // taps per block; grid.z covers more

template <int CO_T>
__global__ void __launch_bounds__(kDwThreads)
conv2d_dw_partial_kernel(const __nv_bfloat16* __restrict__ x,   // (B,T,F,Cin)
                         const __nv_bfloat16* __restrict__ gy,  // (B,T,F,Cout)
                         float* __restrict__ partial,  // (chunks,KK,Cin_pad,Cout)
                         int T, int F, int Cin, int Cin_pad, int Cout,
                         int kt, int kf, long long P, long long chunk_px) {
  using namespace nvcuda;
  constexpr int kFrags = CO_T / 16;
  constexpr int kPairsPerWarp = (kDwMaxTaps * kFrags + 3) / 4;
  __shared__ __align__(128) __nv_bfloat16 x_tile[kDwMaxTaps * kDwPx * 16];
  __shared__ __align__(128) __nv_bfloat16 g_tile[kDwPx * CO_T];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int co_tiles = Cout / CO_T;
  const int ci0 = (blockIdx.y / co_tiles) * 16;
  const int co0 = (blockIdx.y % co_tiles) * CO_T;
  const int kk = kt * kf;
  const int tap0 = blockIdx.z * kDwMaxTaps;
  const int ntaps = min(kDwMaxTaps, kk - tap0);
  const int pairs = ntaps * kFrags;
  const int ht = (kt - 1) / 2;
  const int hf = (kf - 1) / 2;
  const bool vec_in = (Cin % 8) == 0;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kPairsPerWarp];
#pragma unroll
  for (int i = 0; i < kPairsPerWarp; ++i) wmma::fill_fragment(acc[i], 0.f);

  // x staging: each thread owns one pixel of the stage and 8 channels
  const int s_px = tid >> 1;
  const int s_c = (tid & 1) * 8;
  const long long p_begin = static_cast<long long>(blockIdx.x) * chunk_px;
  const long long p_end = min(P, p_begin + chunk_px);
  for (long long p0 = p_begin; p0 < p_end; p0 += kDwPx) {
    for (int v = tid; v < kDwPx * CO_T / 8; v += kDwThreads) {
      const int r = v / (CO_T / 8);
      const int col = (v % (CO_T / 8)) * 8;
      const long long p = p0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p < p_end)
        val = *reinterpret_cast<const uint4*>(gy + p * Cout + co0 + col);
      *reinterpret_cast<uint4*>(g_tile + r * CO_T + col) = val;
    }
    const long long p = p0 + s_px;
    const bool p_ok = p < p_end;
    int pb = 0, pt = 0, pf = 0;
    if (p_ok) {
      pf = static_cast<int>(p % F);
      const long long q = p / F;
      pt = static_cast<int>(q % T);
      pb = static_cast<int>(q / T);
    }
    const int c = ci0 + s_c;
    for (int tap = 0; tap < ntaps; ++tap) {
      const int dt = (tap0 + tap) / kf;
      const int df = (tap0 + tap) % kf;
      const int st = pt + dt - ht;
      const int sf = pf + df - hf;
      const bool inside = p_ok && st >= 0 && st < T && sf >= 0 && sf < F;
      const long long src =
          inside ? ((static_cast<long long>(pb) * T + st) * F + sf) * Cin : 0;
      __nv_bfloat16* dst = x_tile + (tap * kDwPx + s_px) * 16 + s_c;
      if (inside && vec_in && c < Cin) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(x + src + c);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = (inside && c + i < Cin) ? x[src + c + i] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDwPx / 16; ++k) {
#pragma unroll
      for (int i = 0; i < kPairsPerWarp; ++i) {
        const int j = warp + 4 * i;
        if (j < pairs) {
          const int tap = j / kFrags;
          const int nf = j % kFrags;
          // A = x^T (16 channels x 16 pixels), stored [pixel][channel]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> a_frag;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b_frag;
          wmma::load_matrix_sync(a_frag, x_tile + (tap * kDwPx + k * 16) * 16,
                                 16);
          wmma::load_matrix_sync(b_frag, g_tile + k * 16 * CO_T + nf * 16,
                                 CO_T);
          wmma::mma_sync(acc[i], a_frag, b_frag, acc[i]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPairsPerWarp; ++i) {
    const int j = warp + 4 * i;
    if (j < pairs) {
      const int tap = j / kFrags;
      const int nf = j % kFrags;
      float* dst = partial +
                   ((static_cast<long long>(blockIdx.x) * kk + tap0 + tap) *
                        Cin_pad + ci0) * Cout + co0 + nf * 16;
      wmma::store_matrix_sync(dst, acc[i], Cout, wmma::mem_row_major);
    }
  }
}

// dw[tap, ci, co] = sum over chunks, in chunk order, of the partials
__global__ void conv2d_dw_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ dw, int chunks,
                                        int kk, int Cin, int Cin_pad,
                                        int Cout) {
  const long long n = static_cast<long long>(kk) * Cin * Cout;
  const long long stride = static_cast<long long>(kk) * Cin_pad * Cout;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long tap = e / (static_cast<long long>(Cin) * Cout);
    const long long rem = e % (static_cast<long long>(Cin) * Cout);
    const long long src = tap * Cin_pad * Cout + rem;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += partial[c * stride + src];
    dw[e] = s;
  }
}

template <int CO_T>
cudaError_t launch_dw(const void* x, const void* gy, void* ws, int Cin_pad,
                      int T, int F, int Cin, int Cout, int kt, int kf,
                      long long P, int chunks, long long chunk_px,
                      cudaStream_t s) {
  const int kk = kt * kf;
  const dim3 grid(chunks, (Cin_pad / 16) * (Cout / CO_T),
                  (kk + kDwMaxTaps - 1) / kDwMaxTaps);
  conv2d_dw_partial_kernel<CO_T><<<grid, kDwThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gy), static_cast<float*>(ws), T, F,
      Cin, Cin_pad, Cout, kt, kf, P, chunk_px);
  return cudaGetLastError();
}

}  // namespace

// x (B, T, F, Cin) bf16, gy (B, T, F, Cout) bf16, w_flip (kt, kf, Cout,
// Cin) bf16 = w[::-1, ::-1].swap(Cin, Cout); outputs dx (B, T, F, Cin)
// bf16 and dw (kt, kf, Cin, Cout) f32; workspace (chunks, kt*kf, Cin_pad,
// Cout) f32 with Cin_pad = Cin rounded up to 16. All contiguous, 16-byte
// aligned. Requires odd kt, kf and Cout % 16 == 0; block x of the dw
// pass reduces pixels [x * chunk_px, (x + 1) * chunk_px) with chunk_px =
// ceil(B*T*F / chunks) rounded up to 64 (a chunk past the end adds
// zeros). Returns a cudaError_t.
extern "C" int pbsed_conv2d_same_bwd(const void* x, const void* gy,
                                     const void* w_flip, void* dx, void* dw,
                                     void* workspace, int B, int T, int F,
                                     int Cin, int Cout, int kt, int kf,
                                     int chunks, void* stream) {
  if (kt % 2 == 0 || kf % 2 == 0 || Cout % 16 != 0 || Cin < 1 || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long P = static_cast<long long>(B) * T * F;
  if (P == 0) return 0;
  const long long per = (P + chunks - 1) / chunks;
  const long long chunk_px = (per + kDwPx - 1) / kDwPx * kDwPx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      conv2d_igemm(gy, w_flip, nullptr, dx, B, T, F, Cout, Cin, kt, kf, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Cin_pad = (Cin + 15) / 16 * 16;
  if (Cout % 64 == 0)
    err = launch_dw<64>(x, gy, workspace, Cin_pad, T, F, Cin, Cout, kt, kf, P,
                        chunks, chunk_px, s);
  else if (Cout % 32 == 0)
    err = launch_dw<32>(x, gy, workspace, Cin_pad, T, F, Cin, Cout, kt, kf, P,
                        chunks, chunk_px, s);
  else
    err = launch_dw<16>(x, gy, workspace, Cin_pad, T, F, Cin, Cout, kt, kf, P,
                        chunks, chunk_px, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(kt) * kf * Cin * Cout;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  conv2d_dw_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(dw), chunks,
      kt * kf, Cin, Cin_pad, Cout);
  return static_cast<int>(cudaGetLastError());
}
