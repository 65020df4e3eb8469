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
//      (conv2d_gemm: the wgmma kernel) with N = Cin output channels, a
//      layer with Cin < 16 included (N = 1 or 11: the 16-wide tile whose
//      epilogue writes the N real channels; w_flip's rows padded with
//      zero columns to 16). With a null dx this launch is
//      skipped (a layer whose input needs no gradient). Every recipe's
//      entry layer needs it: its input is the output of the features'
//      learnable affine and of norm_0, a pre-activation norm with a
//      learnable scale.
//   2. dw partials: dw[dt, df, ci, co] = sum_p x[p + (dt - ht, df - hf), ci]
//      * gy[p, co] is a reduction over up to B*T*F = 2,048,000 pixels
//      (layers 1-2 at 32 ten-second clips). The TPU kernel accumulated
//      it across its sequential grid; CUDA blocks run in no order, so
//      each block reduces one chunk of pixels into its own slot of an f32
//      workspace (chunks, kt*kf, Cin_pad, Cout), Cin_pad = Cin for the
//      entry kernel (conv2d_dw_cin_pad; pbsed_conv2d_dw_workspace gives
//      the size).
//   3. a deterministic reduce over the chunks in a fixed order: two runs
//      give bit-identical dw (no float atomics); the entry kernel's own
//      reduce (conv2d_entry.cuh) takes a warp an element.
//
// What bounds it on the H100: dw moves x and gy once from device memory
// (x is re-read kt*kf times, shifted, from L1/L2) and does
// 2*kt*kf*Cin*Cout flops per pixel; the narrow early layers are bound by
// the activation bytes, the wide late ones by the tensor cores. dx is
// the forward's GEMM with the roles of Cin and Cout swapped.
//
// What the design does about it: conv2d_dw_wgmma_kernel
// (conv2d_wgmma.cuh) stages each rows x W pixel tile of x once, with its
// halo rows, and the gy tile once, through a TMA ring of 2-6 stages;
// three consumer warpgroups run wgmma for the 9 taps (one dt row each)
// from shifted views of that one x tile. The chunks fill one wave of
// blocks (conv2d_dw_chunks). Cin < 16 (the entry layer) runs
// conv2d_dw_entry_kernel (conv2d_entry.cuh): taps and channels packed into
// one GEMM dimension, x and gy read once through a cp.async ring. Every
// other shape runs the wgmma kernel at any F (Cin off a multiple of 8
// padded with zeros by the wrapper); a shape neither takes launches
// nothing, and the wrapper cuts its kernel into tap blocks that fit
// (ops/kernels/conv.py:_tap_blocks).
//
// pbsed_bnrelu_conv2d_same_bwd is the backward of the BN+ReLU-fused conv
// (conv2d.cu, pbsed_bnrelu_conv2d_same): it returns da, the gradient with
// respect to the post-activation buffer a = bf16(relu(x * scale +
// shift)) (launch 1 unchanged: it never reads x), and dw with the x tiles
// of launch 2 recomputed through that transform at staging (zero halo),
// summed in the same fixed chunk order. Replaces
// pb_sed_tpu/ops/pallas/conv.py:_bwd_kernel_bn, the bn path of
// _bwd_dx_kernel_cb and _bwd_dw_kernel_cb_bn (reached through
// _bwd_fused_bn). The chain through the affine (dz = da * 1[x*s + t > 0],
// dx, dscale, dshift) runs outside, in PyTorch, as the JAX package runs
// it outside its kernels (conv.py:1731-1743).
#include "conv2d_entry.cuh"

namespace {

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

// The three launches of both entry points; scale/shift null for the
// plain conv, (Cin,) f32 for the BN+ReLU-fused one (dw side only); dx null
// (and w_flip unused) skips launch 1. A shape that a pass's kernels do
// not take launches nothing.
int conv_bwd(const void* x, const void* gy, const void* w_flip,
             const float* scale, const float* shift, void* dx, void* dw,
             void* workspace, int B, int T, int F, int Cin, int Cout, int kt,
             int kf, int chunks, void* stream) {
  if (kt % 2 == 0 || kf % 2 == 0 || Cout % 16 != 0 || Cin < 1 || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool entry = conv2d_dw_entry_ok(F, Cin, Cout, kt, kf);
  if ((dx != nullptr && !conv2d_gemm_takes(F, Cout, Cin, kt, kf)) ||
      !(entry || conv2d_dw_wgmma_ok(F, Cin, Cout, kt, kf)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * F == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dx != nullptr)
    err = conv2d_gemm(gy, w_flip, nullptr, dx, 1, B, T, F, Cout, Cin, kt, kf,
                      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (entry)
    return static_cast<int>(
        scale != nullptr
            ? conv2d_dw_entry<true>(x, gy, scale, shift, workspace, dw, B, T,
                                    F, Cin, Cout, kt, kf, chunks, s)
            : conv2d_dw_entry<false>(x, gy, nullptr, nullptr, workspace, dw,
                                     B, T, F, Cin, Cout, kt, kf, chunks, s));
  const int Cin_pad = conv2d_dw_cin_pad(F, Cin, Cout, kt, kf);
  err = scale != nullptr
            ? conv2d_dw_wgmma<true>(x, gy, scale, shift, workspace, Cin_pad,
                                    B, T, F, Cin, Cout, kt, kf, chunks, s)
            : conv2d_dw_wgmma<false>(x, gy, nullptr, nullptr, workspace,
                                     Cin_pad, B, T, F, Cin, Cout, kt, kf,
                                     chunks, s);
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

}  // namespace

// x (B, T, F, Cin) bf16, gy (B, T, F, Cout) bf16, w_flip (kt, kf, Cout,
// Cin8) bf16 = w[::-1, ::-1].swap(Cin, Cout) with Cin8 = Cin rounded up to
// a multiple of 8, to 16 below 16 (zero columns past Cin); outputs dx (B,
// T, F, Cin)
// bf16 (null: no dx pass, w_flip unused) and dw (kt, kf, Cin, Cout) f32;
// workspace of pbsed_conv2d_dw_workspace f32 elements. All contiguous,
// 16-byte aligned. Requires odd kt, kf, Cout % 16 == 0 and Cin < 16 or
// Cin % 8 == 0 (the wrapper pads other channel counts); a shape whose
// halo ring fits no kernel's shared memory (pbsed_conv2d_design or
// pbsed_conv2d_dw_design 0) launches nothing; chunks is
// pbsed_conv2d_dw_chunks of the shape (any count >= 1 is right: a chunk
// past the end adds zeros). Returns a cudaError_t.
extern "C" int pbsed_conv2d_same_bwd(const void* x, const void* gy,
                                     const void* w_flip, void* dx, void* dw,
                                     void* workspace, int B, int T, int F,
                                     int Cin, int Cout, int kt, int kf,
                                     int chunks, void* stream) {
  return conv_bwd(x, gy, w_flip, nullptr, nullptr, dx, dw, workspace, B, T, F,
                  Cin, Cout, kt, kf, chunks, stream);
}

// pbsed_conv2d_same_bwd's contract plus scale and shift (Cin,) f32 of the
// fused forward: da (B, T, F, Cin) bf16 is the gradient w.r.t. the
// post-activation buffer, dw contracts the recomputed buffer with gy.
extern "C" int pbsed_bnrelu_conv2d_same_bwd(
    const void* x, const void* gy, const void* w_flip, const void* scale,
    const void* shift, void* da, void* dw, void* workspace, int B, int T,
    int F, int Cin, int Cout, int kt, int kf, int chunks, void* stream) {
  return conv_bwd(x, gy, w_flip, static_cast<const float*>(scale),
                  static_cast<const float*>(shift), da, dw, workspace, B, T,
                  F, Cin, Cout, kt, kf, chunks, stream);
}

// The pixel chunks of the dw pass for this shape on a card with ``sms``
// SMs (the workspace's first dimension): conv2d_dw_chunks.
extern "C" int pbsed_conv2d_dw_chunks(int B, int T, int F, int Cin, int Cout,
                                      int kt, int kf, int sms) {
  return conv2d_dw_chunks(B, T, F, Cin, Cout, kt, kf, sms);
}

// The f32 elements of the dw workspace with ``chunks`` chunks: chunks x
// kt * kf x conv2d_dw_cin_pad x Cout, the layout the chosen dw kernel
// writes and the reduce reads.
extern "C" long long pbsed_conv2d_dw_workspace(int F, int Cin, int Cout,
                                               int kt, int kf, int chunks) {
  return static_cast<long long>(chunks) * kt * kf *
         conv2d_dw_cin_pad(F, Cin, Cout, kt, kf) * Cout;
}

// Which kernel the dw pass runs: 2 the entry kernel (Cin < 16) and 1 the
// wgmma kernel, each with the depth of its (x halo, gy) ring in *stages
// and its dynamic shared memory in *smem; 0 none (*stages = *smem = 0).
extern "C" int pbsed_conv2d_dw_design(int F, int Cin, int Cout, int kt,
                                      int kf, int* stages, int* smem) {
  if (conv2d_dw_entry_ok(F, Cin, Cout, kt, kf)) {
    *stages = kEntryDwStages;
    *smem = entry_dw_smem(entry_pick(F, Cin, Cout, kt, kf, true), Cout);
    return 2;
  }
  const WgPlan plan = conv2d_dw_wgmma_plan(F, Cin, Cout, kt, kf);
  *stages = plan.stages;
  *smem = plan.smem;
  return plan.width > 0 ? 1 : 0;
}
