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
// im2col patch to device memory (conv2d_igemm.cuh, shared with the input
// gradient of the backward, conv2d_bwd.cu).
#include "conv2d_igemm.cuh"

// x (B, T, F, Cin) bf16, w (kt, kf, Cin, Cout) bf16, b (Cout,) f32,
// y (B, T, F, Cout) bf16; all contiguous and 16-byte aligned.
// Requires odd kt and kf and Cout % 16 == 0. Returns a cudaError_t.
extern "C" int pbsed_conv2d_same(const void* x, const void* w, const void* b,
                                 void* y, int B, int T, int F, int Cin,
                                 int Cout, int kt, int kf, void* stream) {
  if (kt % 2 == 0 || kf % 2 == 0 || Cout % 16 != 0 || Cin < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * F == 0) return 0;
  return static_cast<int>(conv2d_igemm(x, w, b, y, B, T, F, Cin, Cout, kt,
                                       kf, static_cast<cudaStream_t>(stream)));
}
