// Stride-1 SAME 2-D convolution in float32 on the channels-last
// (B, T, F, C) layout, any kernel extent (XLA's SAME pads, even extents
// too), forward and backward (dx, dw):
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
// Every pass runs 3xTF32 on the tensor cores (each f32 operand split into
// a TF32 hi and lo part, a product taken as hi*lo + lo*hi + hi*hi, runs of
// products kept short and added to f32 register sums), on one of two
// designs chosen by shape before the launch (pbsed_conv2d_f32_design
// reports which):
//
// - The entry kernels (conv2d_f32_entry.cuh): mma.sync m16n8k8, taps and
//   channels packed into one K, fed by cp.async rings at any F. They take
//   the forward, dx and dw of every layer with Cin < 16 (the entry layer,
//   Cin = 1, and the tag-conditioned BiCRNN's, Cin = 11) and the dx of a
//   layer with Cout < 16 (a GEMM from fewer than 16 channels), where
//   their tiles fit shared memory.
// - wgmma fed by TMA halo rings (conv2d_f32_wgmma.cuh) for every other
//   pass: tiles of rows x W pixels at any F, Cin and Cout >= 16 at
//   multiples of 4 (the wrappers pad other counts with zero channels and
//   zero weights, ops/kernels/conv.py:_f32_channels).
//
// A shape neither design takes (a kernel whose halo fits no tile) is one
// the wrappers never hand down: they run it as tap blocks that fit
// (ops/kernels/conv.py:_f32_tap_blocks). The C entry points return
// cudaErrorInvalidValue for it and launch nothing.
//
// The input gradient is the forward's GEMM on the cotangent with the
// flipped, transposed weights and the pads mirrored (lo' = k - 1 - lo);
// it is skipped when the caller passes no dx. The weight gradient is cut
// into pixel chunks: each chunk's blocks write their partial sums, and a
// second kernel adds the chunks in chunk order, so reruns are
// bit-identical (no float atomics). Stacked members (x (M, B, T, F, Cin),
// w (M, kt, kf, Cin, Cout), bias (M, Cout)) run in one launch of the
// forward.
//
// What bounds it on the H100: the shallow tower's 3x3 layers are 284
// GFLOP a forward at B = 32, T = 500: 1.72 ms at the TF32 tensor rate x 3
// (495 TFLOP/s); the entry layer and L1's dw by bytes.
#include "conv2d_f32_entry.cuh"
#include "conv2d_f32_wgmma.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The design of each pass of a (F, Cin -> Cout, kt x kf) layer: 2 the
// entry kernels, 1 3xTF32 on wgmma, 0 neither (a shape the wrappers do
// not hand down). The dx runs the forward's GEMM on gy: C = Cout channels
// in, N = Cin out, the frequency pads mirrored; it takes the entry
// kernels where either count is below 16.
int f32_fwd_design(int F, int Cin, int Cout, int kt, int kf) {
  if (Cin < 16)
    return conv2d_f32_entry_ok(F, Cin, Cout, kt, kf, (kf - 1) / 2) ? 2 : 0;
  return conv2d_f32_wgmma_ok(F, Cin, Cout, kt, kf) ? 1 : 0;
}

int f32_dx_design(int F, int Cin, int Cout, int kt, int kf) {
  if ((Cin < 16 || Cout < 16) &&
      conv2d_f32_entry_ok(F, Cout, Cin, kt, kf, kf - 1 - (kf - 1) / 2))
    return 2;
  return conv2d_f32_wgmma_ok(F, Cout, Cin, kt, kf) ? 1 : 0;
}

int f32_dw_design(int F, int Cin, int Cout, int kt, int kf) {
  if (Cin < 16) return conv2d_f32_dw_entry_ok(F, Cin, Cout, kt, kf) ? 2 : 0;
  return conv2d_f32_dw_wgmma_ok(F, Cin, Cout, kt, kf) ? 1 : 0;
}

// pixel chunks of the dw pass at this shape for its design
int f32_dw_chunks(int B, int T, int F, int Cin, int Cout, int kt, int kf,
                  int sms) {
  if (static_cast<long long>(B) * T * F == 0) return 1;
  const int design = f32_dw_design(F, Cin, Cout, kt, kf);
  if (design == 2)
    return conv2d_f32_dw_entry_chunks(B, T, F, Cin, Cout, kt, kf, sms);
  if (design == 1)
    return conv2d_f32_dw_wgmma_chunks(B, T, F, Cin, Cout, kt, kf, sms);
  return 1;
}

}  // namespace

// x (M, B, T, F, Cin) f32, w (M, kt, kf, Cin, Cout) f32, b (M, Cout) f32 or
// null, y (M, B, T, F, Cout) f32; contiguous. Any kt, kf >= 1 (XLA's SAME
// pads: (k - 1) / 2 before, k / 2 after) and channel counts that a design
// takes (pbsed_conv2d_f32_design). ``split`` holds
// pbsed_conv2d_f32_split_floats(0, ...) f32 (the weights' hi and lo).
// Returns a cudaError_t.
extern "C" int pbsed_conv2d_same_f32(const void* x, const void* w,
                                     const void* b, void* y, void* split,
                                     int M, int B, int T, int F, int Cin,
                                     int Cout, int kt, int kf, void* stream) {
  if (kt < 1 || kf < 1 || Cin < 1 || Cout < 1 || M < 1 || M > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * T * F == 0) return 0;
  const int design = f32_fwd_design(F, Cin, Cout, kt, kf);
  if (design == 0 || split == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ws = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  if (design == 2)
    return static_cast<int>(conv2d_f32_entry(xs, ws, split, bs, ys, M, B, T,
                                             F, Cin, Cout, kt, kf,
                                             (kt - 1) / 2, (kf - 1) / 2, s));
  return static_cast<int>(conv2d_f32_wgmma(xs, ws, split, bs, ys, M, B, T, F,
                                           Cin, Cout, kt, kf, (kt - 1) / 2,
                                           (kf - 1) / 2, s));
}

// Which design a pass of the f32 conv of a (F, Cin -> Cout, kt x kf)
// layer runs: pass 0 the forward, 1 dx, 2 dw. Returns 2 for the entry
// kernels (conv2d_f32_entry.cuh), 1 for 3xTF32 on wgmma, each with its
// ring depth, dynamic shared memory in bytes and tile (frequencies and
// frames) written to the pointers, 0 where neither takes the shape (all
// four 0).
extern "C" int pbsed_conv2d_f32_design(int pass, int F, int Cin, int Cout,
                                       int kt, int kf, int* stages,
                                       int* smem, int* width, int* rows) {
  *stages = *smem = *width = *rows = 0;
  const int lo_f = (kf - 1) / 2;
  if (pass == 2) {
    const int design = f32_dw_design(F, Cin, Cout, kt, kf);
    if (design == 2) {
      const F32EntryGeom g = f32e_pick(F, Cin, Cout, kt, kf, lo_f, true);
      *stages = kF32eDwStages;
      *smem = f32e_dw_smem(g, Cout);
      *width = g.width;
      *rows = g.rows;
    } else if (design == 1) {
      const WgPlan plan = conv2d_f32_dw_wgmma_plan(F, Cin, Cout, kt, kf);
      *stages = plan.stages;
      *smem = plan.smem;
      *width = plan.width;
      *rows = plan.rows;
    }
    return design;
  }
  const int design = pass == 0 ? f32_fwd_design(F, Cin, Cout, kt, kf)
                               : f32_dx_design(F, Cin, Cout, kt, kf);
  const int c_in = pass == 0 ? Cin : Cout;
  const int n = pass == 0 ? Cout : Cin;
  if (design == 2) {
    const F32EntryGeom g = f32e_pick(
        F, c_in, n, kt, kf, pass == 0 ? lo_f : kf - 1 - lo_f, false);
    *stages = kF32eFwdStages;
    *smem = f32e_fwd_smem(g, n);
    *width = g.width;
    *rows = g.rows;
  } else if (design == 1) {
    const WgPlan plan = conv2d_f32_wgmma_plan(F, c_in, n, kt, kf);
    *stages = plan.stages;
    *smem = plan.smem;
    *width = plan.width;
    *rows = plan.rows;
  }
  return design;
}

// The f32 floats of the buffer the weights of pass 0 (the forward, M
// members) or 1 (dx, M = 1) are split into: 2 M kt kf Cin Cout on wgmma,
// the entry kernels' image (conv2d_f32_entry_split_floats); 0 for pass 2
// (dw splits no weights) and for a shape no design takes.
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

// Backward of pbsed_conv2d_same_f32 for one member: x (B, T, F, Cin) f32
// and gy (B, T, F, Cout) f32, the dw pass's operands; dw (kt, kf, Cin,
// Cout) f32, workspace (chunks, kt * kf * Cin, Cout) f32 with chunks =
// pbsed_conv2d_f32_dw_chunks(..., sms) for this card's sms. The dx reads
// gy_dx (B, T, F, Cout_dx) f32, Cout_dx <= Cout: gy itself where Cout_dx
// = Cout, else the cotangent at its own narrower width, where gy was
// padded with zero channels for the dw pass only (the dx of a layer with
// Cout < 16 runs the entry kernels on the unpadded one); w_flip (kt, kf,
// Cout_dx, Cin) f32 (the weights flipped in both extents, channels
// transposed); dx (B, T, F, Cin) f32, or null (then no dx pass, and
// gy_dx, w_flip and split may be null); split
// pbsed_conv2d_f32_split_floats(1, F, Cin, Cout_dx, ...) f32. Contiguous.
// Returns a cudaError_t; launches nothing for a pass no design takes.
extern "C" int pbsed_conv2d_same_f32_bwd(const void* x, const void* gy,
                                         const void* gy_dx,
                                         const void* w_flip, void* dx,
                                         void* dw, void* workspace,
                                         void* split, int B, int T, int F,
                                         int Cin, int Cout, int Cout_dx,
                                         int kt, int kf, int sms,
                                         void* stream) {
  if (kt < 1 || kf < 1 || Cin < 1 || Cout < 1 || sms < 1 ||
      (dx != nullptr && (Cout_dx < 1 || Cout_dx > Cout)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(kt) * kf * Cin * Cout;
  if (static_cast<long long>(B) * T * F == 0)
    return static_cast<int>(cudaMemsetAsync(dw, 0, sizeof(float) * n, s));
  const int dx_design =
      dx == nullptr ? -1 : f32_dx_design(F, Cin, Cout_dx, kt, kf);
  const int dw_design = f32_dw_design(F, Cin, Cout, kt, kf);
  if (dx_design == 0 || dw_design == 0 ||
      (dx != nullptr && split == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lo_t = (kt - 1) / 2;
  const int lo_f = (kf - 1) / 2;
  const float* xs = static_cast<const float*>(x);
  const float* gs = static_cast<const float*>(gy);
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) {
    // the forward's GEMM on gy with the flipped weights, pads mirrored
    const float* gd = static_cast<const float*>(gy_dx);
    const float* wf = static_cast<const float*>(w_flip);
    float* dxs = static_cast<float*>(dx);
    if (dx_design == 2)
      err = conv2d_f32_entry(gd, wf, split, nullptr, dxs, 1, B, T, F,
                             Cout_dx, Cin, kt, kf, kt - 1 - lo_t,
                             kf - 1 - lo_f, s);
    else
      err = conv2d_f32_wgmma(gd, wf, split, nullptr, dxs, 1, B, T, F,
                             Cout_dx, Cin, kt, kf, kt - 1 - lo_t,
                             kf - 1 - lo_f, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = f32_dw_chunks(B, T, F, Cin, Cout, kt, kf, sms);
  float* part = static_cast<float*>(workspace);
  if (dw_design == 2)
    err = conv2d_f32_dw_entry(xs, gs, part, B, T, F, Cin, Cout, kt, kf,
                              chunks, s);
  else
    err = conv2d_f32_dw_wgmma(xs, gs, part, B, T, F, Cin, Cout, kt, kf,
                              lo_t, lo_f, chunks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  conv2d_f32_dw_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      part, static_cast<float*>(dw), chunks, n);
  return static_cast<int>(cudaGetLastError());
}
