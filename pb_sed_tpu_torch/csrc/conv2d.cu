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
// im2col patch to device memory, shared with the input gradient of the
// backward (conv2d_bwd.cu): wgmma fed by a TMA ring, one halo tile per K
// slice for all taps (conv2d_wgmma.cuh); the entry layer (Cin < 16) and
// shapes off that kernel's tiling keep the narrow kernel of
// conv2d_igemm.cuh.
//
// pbsed_bnrelu_conv2d_same is the BN+ReLU-fused conv of CNN2d(fuse_bn):
// y = bf16(conv(a, w) + b) with a = bf16(relu(f32(x) * scale + shift)) on
// in-image elements and a zero SAME halo. Replaces
// pb_sed_tpu/ops/pallas/conv.py:_fwd_kernel_bn and its channel-blocked
// variant _fwd_kernel_cb_bn (the deep L14/L16 at Cin 256), reached through
// _fwd_packed_bn / bnrelu_conv2d_packed_fm: one kernel for both, as
// pbsed_conv2d_same is for the unfused pair. Bound as the plain conv
// above; what it saves is the normalized buffer that the unfused tower
// writes and reads back between its norm and its conv: the affine runs
// once on each staged halo tile (conv2d_wgmma.cuh, AFFINE).
#include "conv2d_wgmma.cuh"

// A stacked ensemble's members run in the same launch: every operand has a
// leading member axis of M, and member m's output is what a launch of
// member m alone gives, bit for bit (each tile's K order does not depend
// on M or B). Replaces the member grid axis that jax.vmap gives the TPU
// kernels above (pb_sed_tpu/models/base/ensemble.py).

namespace {

// y = conv(x, w) + b for M members: the wgmma kernel where
// conv2d_wgmma_ok, else the narrow kernel; with scale and shift (both
// (M, Cin) f32) the input goes through bnrelu on the way (the BN+ReLU-fused
// conv)
cudaError_t conv2d_gemm(const void* x, const void* w, const void* b, void* y,
                        int M, int B, int T, int F, int Cin, int N, int kt,
                        int kf, cudaStream_t stream,
                        const float* scale = nullptr,
                        const float* shift = nullptr) {
  if (!conv2d_wgmma_ok(F, Cin, N, kt, kf))
    return conv2d_igemm(x, w, b, y, B, T, F, Cin, N, kt, kf, stream, scale,
                        shift, M);
  const float* bias = static_cast<const float*>(b);
  if (scale != nullptr)
    return conv2d_wgmma<true>(x, w, bias, scale, shift, y, B, T, F, Cin, N,
                              kt, kf, stream, M);
  return conv2d_wgmma<false>(x, w, bias, nullptr, nullptr, y, B, T, F, Cin,
                             N, kt, kf, stream, M);
}

}  // namespace

// x (M, B, T, F, Cin) bf16, w (M, kt, kf, Cin, Cout) bf16, b (M, Cout)
// f32, y (M, B, T, F, Cout) bf16; all contiguous and 16-byte aligned.
// Requires odd kt and kf and Cout % 16 == 0. Returns a cudaError_t.
extern "C" int pbsed_conv2d_same(const void* x, const void* w, const void* b,
                                 void* y, int M, int B, int T, int F,
                                 int Cin, int Cout, int kt, int kf,
                                 void* stream) {
  if (kt % 2 == 0 || kf % 2 == 0 || Cout % 16 != 0 || Cin < 1 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * F == 0) return 0;
  return static_cast<int>(conv2d_gemm(x, w, b, y, M, B, T, F, Cin, Cout, kt,
                                      kf, static_cast<cudaStream_t>(stream)));
}

// x (M, B, T, F, Cin) bf16, w (M, kt, kf, Cin, Cout) bf16, b (M, Cout)
// f32, scale and shift (M, Cin) f32, y (M, B, T, F, Cout) bf16; all
// contiguous and 16-byte aligned. Requires odd kt and kf and Cout % 16 ==
// 0. Returns a cudaError_t.
extern "C" int pbsed_bnrelu_conv2d_same(const void* x, const void* w,
                                        const void* b, const void* scale,
                                        const void* shift, void* y, int M,
                                        int B, int T, int F, int Cin,
                                        int Cout, int kt, int kf,
                                        void* stream) {
  if (kt % 2 == 0 || kf % 2 == 0 || Cout % 16 != 0 || Cin < 1 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * F == 0) return 0;
  return static_cast<int>(conv2d_gemm(
      x, w, b, y, M, B, T, F, Cin, Cout, kt, kf,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(scale),
      static_cast<const float*>(shift)));
}

// Which kernel the forward-type GEMM of a (F, Cin -> N, kt x kf) conv runs:
// 1 the wgmma kernel of conv2d_wgmma.cuh, with the depth of its halo ring
// in *stages (its weight ring has kWgBStages) and its dynamic shared
// memory in *smem; 0 the narrow one (*stages = *smem = 0).
extern "C" int pbsed_conv2d_design(int F, int Cin, int N, int kt, int kf,
                                   int* stages, int* smem) {
  const bool wgmma = conv2d_wgmma_ok(F, Cin, N, kt, kf);
  *stages = wgmma ? conv2d_wgmma_stages(F, Cin, N, kt, kf) : 0;
  *smem = wgmma ? conv2d_wgmma_smem(F, Cin, N, kt, kf, *stages) : 0;
  return wgmma ? 1 : 0;
}
