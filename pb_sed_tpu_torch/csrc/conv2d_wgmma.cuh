// The SAME convolution's two GEMMs redesigned for Hopper: tensor-core
// wgmma fed by TMA copies into rings of shared-memory stages, filled by a
// producer warp while two or three consumer warpgroups compute.
//
// 1. conv2d_wgmma_kernel, the implicit GEMM of the forward, of the
//    BN+ReLU-fused forward (AFFINE) and of the backward's dx / da:
//
//      y[p, n] = bf16(sum_{dt, df, c} x[p + (dt - ht, df - hf), c]
//                     * w[dt, df, c, n] + bias[n])
//
//    A tile is `rows` frames of W frequencies of one clip (rows = 128 / W,
//    floor: rows * W <= 128 output pixels) x BN <= 128 output channels;
//    W is F up to 128 (whole frequency rows: 120 pixels at F = 40, 125 at
//    F = 5), 128 above (a tile is then 128 pixels of one frame), and
//    halved further only where the halo ring would not fit shared memory
//    (conv2d_wgmma_plan). Persistent blocks walk the tiles with the grid's
//    stride. With M members (a
//    stacked ensemble: x (M, B, T, F, Cin), w (M, kt, kf, Cin, N), bias
//    (M, N), scale and shift (M, Cin), y (M, B, T, F, N)) the clips of all
//    members are one (M B)-clip batch of tiles, and a tile takes its
//    member from its clip: a tile never straddles two clips, so never two
//    members. The weight map is (M kk, Cin, N), a member's taps at row
//    member * kk; the bias is staged again when a block's member changes. Per K slice of KC in
//    {16, 32, 64} input channels the producer stages ONE halo tile
//    (rows + kt - 1) x (W + kf - 1) x KC with a 4-D TMA box at (c0, f0 -
//    hf, t0 - ht, b) into a ring of 2-4 stages: TMA zero-fills the
//    coordinates outside the clip, which is the SAME halo, and the box
//    never crosses into another clip. All kt * kf taps read that one tile:
//    each consumer warp loads its wgmma A fragments with ldmatrix from the
//    tap's shifted pixel rows (A from registers), so an input element is
//    fetched once per K slice instead of once per tap; a lane's pixel
//    (m / W, m % W) is found once, and the lanes past rows * W read the
//    tile's last pixel and store nothing. The weights stream per (K
//    slice, up to 9 taps) through a 3-stage ring, one 3-D box of all the
//    stage's taps a copy (B from shared memory, MN-major, the
//    128/64/32-byte swizzle TMA wrote). One producer lane
//    fills each ring, so neither waits for the other. Two consumer
//    warpgroups each run m64 x BN x k16 wgmmas over half of the pixels; a
//    tap's A loads overlap the previous tap's products. The epilogue adds
//    the f32 bias (staged once per block), rounds once to bf16 and writes
//    16-byte stores through a per-warp swizzled staging tile.
//    An output narrower than 16 channels (the dx of a layer with Cin < 16:
//    N = 1 or 11) runs the BN = 16 tile on weights whose rows the wrapper
//    padded with zero columns to 16, and its epilogue writes only the N
//    real channels, straight into y at its own width: the tile's pixels
//    are one contiguous span of y per frame (one span in all where W = F),
//    staged compactly in shared memory at the span's address modulo 16
//    and copied out with 16-byte stores (2-byte ones at its two ends).
//    With AFFINE the consumers apply a = bf16(relu(fma(x, scale, shift)))
//    in place to the staged halo tile once per K slice, to in-image
//    elements of channels < Cin only: the zero halo stays 0 whatever the
//    shift (the TPU kernels' mask, pb_sed_tpu/ops/pallas/conv.py:
//    _stage_bnrelu).
//
// 2. conv2d_dw_wgmma_kernel, the weight gradient's f32 partials:
//
//      dw[tap, ci, co] = sum_p x[p + shift(tap), ci] * gy[p, co]
//
//    per tap a GEMM with M = Cin, N = Cout, K = pixels. A block owns 64
//    input channels x BN <= 32 output channels x up to 9 taps and walks
//    the tiles (the forward's geometry) of its chunk of pixels. Per tile
//    the producer stages the x halo tile (64 channels, as above) and the
//    rows x W gy tile once, through a ring of 2-6 stages; consumer
//    warpgroup g owns the taps 3g .. 3g + 2 (one dt row of a 3x3 kernel).
//    The k16 steps run over ceil(rows * W / 16) pixel groups, rounded up
//    to even; the gy rows past rows * W (never written by TMA) are zeroed
//    once at the start, and those steps' x rows are clamped to the tile's
//    last pixel, so they add exact zeros and read no halo row past its
//    end. The tiling is set by the
//    register file: 13 warps leave 128 registers a thread, and three taps
//    of m64 x 32 f32 accumulators (48) plus two sets of A fragments (24)
//    fit, where 64 output channels (96 + 24) made ptxas serialize the
//    wgmmas; gy is read once per 32 output channels and x once per 64
//    input channels. A = x^T comes from the halo tile with ldmatrix.trans
//    at each tap's shifted pixel rows, B = gy from shared memory
//    (MN-major). Each chunk's partials go to their own slot of the f32
//    workspace and conv2d_bwd.cu's reduce sums them in chunk order: dw is
//    bit-identical between runs. AFFINE transforms the x halo tile as
//    above.
//
// Bounds on the H100: the wide layers are bound by the tensor cores
// (2 * taps * Cin * Cout flops per pixel and GEMM), the narrow ones by the
// activations' bytes. The rows x W x BN tile re-reads the weights of all
// taps per pixel tile from L2; the activations come from device memory
// about once.
//
// What this design takes: every shape with Cin >= 16 at a multiple of 8
// (the wrappers pad other channel counts with zeros, ops/kernels/conv.py:
// _kernel_channels), any F, and any odd extent whose halo ring fits 227 KB
// at some tile width (conv2d_wgmma_plan, conv2d_dw_wgmma_plan); Cin < 16
// runs the entry kernels of conv2d_entry.cuh (forward and dw), its dx (N
// = Cin) this one. A kernel whose halo fits no tile launches nothing here;
// the wrappers run it as tap blocks that fit (ops/kernels/conv.py:
// _tap_blocks): pbsed_conv2d_design / pbsed_conv2d_dw_design report the
// choice.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kWgTileM = 128;        // output pixels per block (2 x m64)
constexpr int kWgBStages = 3;        // weight ring of the forward
constexpr int kWgMaxHaloStages = 4;  // halo tiles of the forward, at most
constexpr int kDwMaxStages = 6;      // (x halo, gy) ring of the dw pass
constexpr int kWgMaxSmem = 232448;   // 227 KB a block may use

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the barrier's phase differs from ``parity``; a wait that
// never ends (a copy that never lands) traps, so it surfaces as a launch
// error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep reads of the accumulators after the wgmma wait that precedes this
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// consumer warpgroups only (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// generic-proxy writes (the in-place affine) before the next TMA write
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The byte offset of logical offset ``o`` in a tile written by TMA with a
// SW-byte swizzle (SW = 32, 64, 128; CUTLASS's Swizzle<log2(SW/16), 4, 3>):
// bits [4, 4 + b) of the address are XORed with bits [7, 7 + b). The tile
// base is 1024-byte aligned, so offsets and addresses agree in those bits.
// The map is its own inverse.
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  constexpr uint32_t mask = static_cast<uint32_t>(SW / 16 - 1) << 4;
  return o ^ ((o >> 3) & mask);
}

// A wgmma shared-memory matrix descriptor (start address, leading and
// stride byte offsets, swizzle layout 1 = 128 B, 2 = 64 B, 3 = 32 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

template <int SW>
__host__ __device__ constexpr uint32_t swizzle_layout() {
  return SW == 128 ? 1u : SW == 64 ? 2u : 3u;
}

// d[64 x N] += a[64 x 16] (bf16 registers, K-major) * B[16 x N] (bf16
// shared memory, MN-major: the transpose bit set), f32 accumulators. The
// operand lists are spelled out for each N the kernels use.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// relu(v * s + t) with ONE f32 rounding of v * s + t (a fused
// multiply-add, as XLA computes the JAX package's affine and as the plain
// version does through float64), then one rounding to bf16; a NaN stays
// NaN as in torch.relu
__device__ __forceinline__ __nv_bfloat16 bnrelu(__nv_bfloat16 v, float s,
                                                float t) {
  const float a = __fmaf_rn(__bfloat162float(v), s, t);
  return __float2bfloat16(a < 0.f ? 0.f : a);
}

// bnrelu applied in place to a staged halo tile (SW bytes of channels per
// pixel row, TMA swizzle SW) whose pixel row h sits at clip coordinates
// (t_org + h / HF, f_org + h % HF): in-image elements of channels < Cin
// become bf16(relu(fma(x, scale[c], shift[c]))), the rest stays 0.
// Cin % 8 == 0 and 16-byte aligned scale and shift (wrapper-checked).
template <int SW>
__device__ __forceinline__ void bnrelu_halo(uint8_t* tile, int pixels, int HF,
                                            int t_org, int f_org, int T,
                                            int F, int c0, int Cin,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ shift,
                                            int tid, int threads) {
  // a thread always handles the same 8 channels (threads is a multiple of
  // the SW / 16 chunks of a row): their scale and shift load once
  constexpr int CPR = SW / 16;
  const int chunk = tid % CPR;
  const int c = c0 + chunk * 8;
  // channels past Cin: TMA's zeros stay
  if (c >= Cin) return;
  float sc[8], sh[8];
  *reinterpret_cast<float4*>(sc) =
      __ldg(reinterpret_cast<const float4*>(scale + c));
  *reinterpret_cast<float4*>(sc + 4) =
      __ldg(reinterpret_cast<const float4*>(scale + c + 4));
  *reinterpret_cast<float4*>(sh) =
      __ldg(reinterpret_cast<const float4*>(shift + c));
  *reinterpret_cast<float4*>(sh + 4) =
      __ldg(reinterpret_cast<const float4*>(shift + c + 4));
  // pixel h's halo row r and column col, stepped along with h (two
  // divisions a call in place of two a pixel)
  const int step = threads / CPR;
  const int step_r = step / HF;
  const int step_c = step - step_r * HF;
  int h = tid / CPR;
  int r = h / HF;
  int col = h - r * HF;
  for (; h < pixels; h += step) {
    const int t = t_org + r;
    const int f = f_org + col;
    // elements outside the clip: TMA's zeros stay
    if (t >= 0 && t < T && f >= 0 && f < F) {
      uint4* p =
          reinterpret_cast<uint4*>(tile + swz<SW>(h * SW + chunk * 16));
      uint4 raw = *p;
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = bnrelu(v[i], sc[i], sh[i]);
      *p = raw;
    }
    r += step_r;
    col += step_c;
    if (col >= HF) {
      col -= HF;
      ++r;
    }
  }
}

// p / W = (p * wg_div_magic(W)) >> 16, exactly, for 1 <= W <= 128 and
// 0 <= p < 256 (a tile's pixel indices): one multiply in place of a
// division in the k16 steps and the epilogue
__host__ __device__ constexpr uint32_t wg_div_magic(int W) {
  return (65536u + W - 1) / W;
}

__host__ __device__ constexpr int align1024(int n) {
  return (n + 1023) / 1024 * 1024;
}

// taps of weights per ring stage of the forward: as many as fit in 32 KB
// (up to 9), so the narrow layers wait on one copy per K slice, not one
// per tap
__host__ __device__ constexpr int wg_taps_per_stage(int kc, int bn) {
  return 32768 / (kc * bn * 2) < 1   ? 1
         : 32768 / (kc * bn * 2) > 9 ? 9
                                     : 32768 / (kc * bn * 2);
}

// ---- 1. the implicit GEMM -----------------------------------------------

// shared memory of the forward's epilogue: per consumer warp a 16 x BW
// staging tile; at BN = 16 also room for the packed epilogue of N < 16
// (the tile's pixels x N bf16, plus 16 bytes of alignment slack for each
// of up to 128 frames' spans)
__host__ __device__ constexpr int wg_epi_bytes(int bn) {
  return bn == 16 ? 128 * 16 * 2 + 128 * 32 : 8 * 16 * (bn < 64 ? bn : 64) * 2;
}

// (narrow N tiles: two blocks an SM, the registers capped at 96 a thread,
// so one block's epilogue and loads overlap the other's products)
template <int KC, int BN, bool AFFINE>
__global__ void __launch_bounds__(288, BN <= 32 ? 2 : 1)
conv2d_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,  // (B,T,F,Cin)
                    const __grid_constant__ CUtensorMap w_map,  // (kk,Cin,N8)
                    const float* __restrict__ bias,   // (N,) or null
                    const float* __restrict__ scale,  // (Cin,) if AFFINE
                    const float* __restrict__ shift,  // (Cin,) if AFFINE
                    __nv_bfloat16* __restrict__ y,    // (B, T, F, N)
                    int B, int T, int F, int Cin, int N, int kt, int kf,
                    int W, int rows, int halo_stride, int hstages,
                    int members) {
  constexpr int SWA = KC * 2;               // bytes of a staged pixel row
  constexpr int BW = BN < 64 ? BN : 64;     // weight box width
  constexpr int SWB = BW * 2;               // bytes of a staged weight row
  constexpr int B_BYTES = KC * BN * 2;      // one tap's weights
  constexpr int TPS = wg_taps_per_stage(KC, BN);
  constexpr int B_STRIDE = align1024(TPS * B_BYTES);
  constexpr int KSTEPS = KC / 16;
  constexpr int CPR = BW / 8;               // 16-byte chunks of an epi row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* halo = smem;
  uint8_t* wbuf = halo + hstages * halo_stride;
  uint8_t* epi = wbuf + kWgBStages * B_STRIDE;
  // the epilogue's staging; the bias, N rounded up to BN, f32; the
  // barriers
  float* sbias = reinterpret_cast<float*>(epi + wg_epi_bytes(BN));
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sbias + (N + BN - 1) / BN * BN);
  uint64_t* halo_full = bars;
  uint64_t* halo_empty = bars + kWgMaxHaloStages;
  uint64_t* b_full = bars + 2 * kWgMaxHaloStages;
  uint64_t* b_empty = b_full + kWgBStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int P = rows * W;                   // a tile: rows x W pixels
  const int tiles_t = (T + rows - 1) / rows;
  const int f_tiles = (F + W - 1) / W;
  const int per_clip = tiles_t * f_tiles;
  const int n_tiles = (N + BN - 1) / BN;
  // walked by the grid in turn: B clips of each of the members
  const int tiles = members * B * per_clip * n_tiles;
  const int kk = kt * kf;
  const int ht = (kt - 1) / 2;
  const int hf = (kf - 1) / 2;
  const int HF = W + kf - 1;
  const int HR = rows + kt - 1;
  const int k_slices = (Cin + KC - 1) / KC;
  // taps a weight copy brings (one box of tpb taps per BW-wide block:
  // a stage is [block][tap][KC][BW]; past a member's last tap the box
  // reads the next member's taps or TMA's zeros, never used)
  const int tpb = min(TPS, kk);
  // a pixel tile's clip b and first frame and frequency
  auto tile_origin = [&](int mt, int& b, int& t0, int& f0) {
    b = mt / per_clip;
    const int r = mt - b * per_clip;
    const int ti = r / f_tiles;
    t0 = ti * rows;
    f0 = (r - ti * f_tiles) * W;
  };

  if (tid == 0) {
    for (int i = 0; i < hstages; ++i) {
      mbar_init(&halo_full[i], 1);
      mbar_init(&halo_empty[i], 8);         // one arrival per consumer warp
    }
    for (int i = 0; i < kWgBStages; ++i) {
      mbar_init(&b_full[i], 1);
      mbar_init(&b_empty[i], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warp: lane 0 starts the halo copies, lane 1 the
    // weights', each as far ahead as its ring allows
    if (tid == 256) {
      int hc = 0;   // halo tiles filled
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int b, t0, f0;
        tile_origin(tile / n_tiles, b, t0, f0);
        for (int ks = 0; ks < k_slices; ++ks, ++hc) {
          const int hs = hc % hstages;
          mbar_wait(&halo_empty[hs], ((hc / hstages) & 1) ^ 1);
          mbar_expect_tx(&halo_full[hs], HR * HF * SWA);
          tma_load_4d(halo + hs * halo_stride, &x_map, &halo_full[hs],
                      ks * KC, f0 - hf, t0 - ht, b);
        }
      }
    } else if (tid == 257) {
      int it = 0;   // weight stages filled
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % n_tiles) * BN;
        const int w_row = (tile / n_tiles / per_clip / B) * kk;  // member
        for (int ks = 0; ks < k_slices; ++ks) {
          for (int tap0 = 0; tap0 < kk; tap0 += TPS, ++it) {
            const int bs = it % kWgBStages;
            mbar_wait(&b_empty[bs], ((it / kWgBStages) & 1) ^ 1);
            mbar_expect_tx(&b_full[bs], tpb * B_BYTES);
#pragma unroll
            for (int j = 0; j < BN / BW; ++j)
              tma_load_3d(wbuf + bs * B_STRIDE + j * tpb * KC * SWB, &w_map,
                          &b_full[bs], n0 + j * BW, ks * KC, w_row + tap0);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64)
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    float acc[BN / 2];
    // this lane's ldmatrix row: pixel m of the tile (the last one past
    // rows * W), channel half kh
    const int m = min(64 * wg + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8,
                      P - 1);
    const uint32_t wmagic = wg_div_magic(W);
    const int m_r = static_cast<int>((m * wmagic) >> 16);  // m / W
    const int m_f = m - m_r * W;
    const int kh = lane >> 4;
    uint8_t* ebuf = epi + (wg * 4 + warp) * 16 * BW * 2;
    uint32_t a[2][KSTEPS][4];
    int staged = -1;     // the member whose bias sbias holds
    int it = 0;          // weight stages consumed
    int hc = 0;          // halo tiles consumed
    int to_release = -1; // a stage whose last tap is the one before

    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&b_empty[stage]);
    };
    // one tap: load its A fragments into a[SET] (the tap two back has
    // finished with them), start its KSTEPS products against the weights
    // at bbase; once the tap before is done, release its stage if it was
    // that stage's last tap
    auto tap_step = [&](auto set_tag, int tap, uint32_t hbase,
                        uint32_t bbase, int stage, bool last) {
      constexpr int SET = decltype(set_tag)::value;
      const int dt = tap / kf;
      const int df = tap - dt * kf;
      const uint32_t row = static_cast<uint32_t>((m_r + dt) * HF + m_f + df);
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        ldsm_x4(a[SET][s], hbase + swz<SWA>(row * SWA + (2 * s + kh) * 16));
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
        wgmma_rs<BN>(acc, a[SET][s],
                     gmma_desc(bbase + s * 16 * SWB, tpb * KC * SWB, 8 * SWB,
                               swizzle_layout<SWB>()));
      wgmma_commit();
      wgmma_wait<1>();
      if (to_release >= 0) release(to_release);
      to_release = last ? stage : -1;
    };

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile / n_tiles;
      const int n0 = (tile - mt * n_tiles) * BN;
      int b, t0, f0;
      tile_origin(mt, b, t0, f0);
      const int member = b / B;
      if (member != staged) {
        // the member's bias (zeros past N and without a bias), once per
        // member a block meets, after every consumer's last epilogue
        consumer_sync(256);
        for (int i = tid; i < (N + BN - 1) / BN * BN; i += 256)
          sbias[i] =
              bias != nullptr && i < N ? bias[member * N + i] : 0.f;
        consumer_sync(256);
        staged = member;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < k_slices; ++ks, ++hc) {
        const int hs = hc % hstages;
        uint8_t* stage = halo + hs * halo_stride;
        mbar_wait(&halo_full[hs], (hc / hstages) & 1);
        if constexpr (AFFINE) {
          bnrelu_halo<SWA>(stage, HR * HF, HF, t0 - ht, f0 - hf, T, F,
                           ks * KC, Cin, scale + member * Cin,
                           shift + member * Cin, tid, 256);
          consumer_sync(256);
        }
        const uint32_t hbase = smem_u32(stage);
        for (int tap0 = 0; tap0 < kk; tap0 += TPS, ++it) {
          const int bs = it % kWgBStages;
          const int nt = min(TPS, kk - tap0);
          mbar_wait(&b_full[bs], (it / kWgBStages) & 1);
          const uint32_t bbase = smem_u32(wbuf + bs * B_STRIDE);
          // a tap's A set: its index's parity in the K slice, which ends
          // in wgmma_wait<0>
          for (int u = 0; u < nt; ++u) {
            if ((tap0 + u) & 1)
              tap_step(std::integral_constant<int, 1>{}, tap0 + u, hbase,
                       bbase + u * KC * SWB, bs, u == nt - 1);
            else
              tap_step(std::integral_constant<int, 0>{}, tap0 + u, hbase,
                       bbase + u * KC * SWB, bs, u == nt - 1);
          }
        }
        wgmma_wait<0>();
        release(to_release);
        to_release = -1;
        if constexpr (AFFINE) fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&halo_empty[hs]);
      }
      fence_regs(acc);

      const int g = lane >> 2;
      const int tq = lane & 3;
      if constexpr (BN == 16) {
        if (N < BN) {
          // ---- packed epilogue (N < 16): + bias, one rounding, the N
          // real channels of each pixel staged compactly per span of y
          // (one span where W = F, else one a frame), each span at its
          // address's offset modulo 16; then the consumers copy the spans
          // out, 16 bytes a store
          const bool whole = W == F;
          const int span_px = whole ? P : W;
          const int span_bytes = (span_px * N * 2 + 15) / 16 * 16 + 16;
          auto span_y = [&](int sp) {
            return y + ((static_cast<long long>(b) * T + t0 + sp) * F + f0) *
                           N;
          };
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int mm = 64 * wg + 16 * warp + g + 8 * h;
            if (mm >= P) continue;
            const int sp = whole ? 0 : mm / W;
            const int q = mm - sp * W;
            uint8_t* dst = epi + sp * span_bytes +
                           (reinterpret_cast<uintptr_t>(span_y(sp)) & 15);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = 8 * j + 2 * tq + e;
                if (n < N)
                  *reinterpret_cast<__nv_bfloat16*>(dst + (q * N + n) * 2) =
                      __float2bfloat16(acc[4 * j + 2 * h + e] + sbias[n]);
              }
          }
          consumer_sync(256);
          const int spans = whole ? 1 : rows;
          for (int sp = 0; sp < spans; ++sp) {
            const int px = whole ? min(rows, T - t0) * F
                           : t0 + sp < T ? min(W, F - f0) : 0;
            uint8_t* gdst = reinterpret_cast<uint8_t*>(span_y(sp));
            const int mis = static_cast<int>(
                reinterpret_cast<uintptr_t>(gdst) & 15);
            const int end = mis + px * N * 2;
            uint8_t* ga = gdst - mis;               // 16-byte aligned
            const uint8_t* sa = epi + sp * span_bytes;
            for (int c = tid; c < (end + 15) / 16; c += 256) {
              const int lo = max(16 * c, mis);
              const int hi = min(16 * c + 16, end);
              if (hi - lo == 16)
                *reinterpret_cast<uint4*>(ga + lo) =
                    *reinterpret_cast<const uint4*>(sa + lo);
              else
                for (int o = lo; o < hi; o += 2)
                  *reinterpret_cast<uint16_t*>(ga + o) =
                      *reinterpret_cast<const uint16_t*>(sa + o);
            }
          }
          consumer_sync(256);
          continue;
        }
      }

      // ---- epilogue: + bias, one rounding, 16-byte stores
#pragma unroll
      for (int cc = 0; cc < BN / BW; ++cc) {
#pragma unroll
        for (int j = 0; j < CPR; ++j) {
          const int jj = cc * CPR + j;
          const float b0 = sbias[n0 + jj * 8 + 2 * tq];
          const float b1 = sbias[n0 + jj * 8 + 2 * tq + 1];
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(acc[4 * jj] + b0, acc[4 * jj + 1] + b1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(
              acc[4 * jj + 2] + b0, acc[4 * jj + 3] + b1);
          *reinterpret_cast<__nv_bfloat162*>(
              ebuf + g * BW * 2 + ((j ^ (g & (CPR - 1))) * 16) + tq * 4) = lo;
          *reinterpret_cast<__nv_bfloat162*>(
              ebuf + (g + 8) * BW * 2 + ((j ^ ((g + 8) & (CPR - 1))) * 16) +
              tq * 4) = hi;
        }
        __syncwarp();
        for (int p = lane; p < 16 * CPR; p += 32) {
          const int r = p / CPR;
          const int ch = p % CPR;
          const uint4 v = *reinterpret_cast<const uint4*>(
              ebuf + r * BW * 2 + ((ch ^ (r & (CPR - 1))) * 16));
          const int mm = 64 * wg + 16 * warp + r;
          const int mr = static_cast<int>((mm * wmagic) >> 16);  // / W
          const int t = t0 + mr;
          const int f = f0 + mm - mr * W;
          const int n = n0 + cc * BW + ch * 8;
          if (mm < P && t < T && f < F && n < N)
            *reinterpret_cast<uint4*>(
                y + ((static_cast<long long>(b) * T + t) * F + f) * N + n) =
                v;
        }
        __syncwarp();
      }
    }
  }
}

// ---- 2. the weight gradient's partials ----------------------------------

template <int BN, bool AFFINE>
__global__ void __launch_bounds__(416, 1)
conv2d_dw_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,   // 64-ch
                       const __grid_constant__ CUtensorMap gy_map,  // BN-ch
                       const float* __restrict__ scale,  // (Cin,) if AFFINE
                       const float* __restrict__ shift,  // (Cin,) if AFFINE
                       float* __restrict__ partial,  // (chunks,kk,Cin_pad,Co)
                       int T, int F, int Cin, int Cin_pad, int Cout, int kt,
                       int kf, int W, int rows, int tiles,
                       int tiles_per_chunk, int ci_tiles, int co_tiles,
                       int halo_stride, int stages) {
  constexpr int SWB = BN * 2;               // bytes of a staged gy row
  constexpr int G_BYTES = kWgTileM * SWB;
  constexpr int G_STRIDE = align1024(G_BYTES);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_stride = halo_stride + G_STRIDE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages *
                                               stage_stride);
  uint64_t* empty = full + kDwMaxStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int P = rows * W;                   // a tile: rows x W pixels
  const int tiles_t = (T + rows - 1) / rows;
  const int f_tiles = (F + W - 1) / W;
  const int kk = kt * kf;
  const int ht = (kt - 1) / 2;
  const int hf = (kf - 1) / 2;
  const int HF = W + kf - 1;
  const int HR = rows + kt - 1;
  const int ci0 = (blockIdx.x % ci_tiles) * 64;
  const int co0 = ((blockIdx.x / ci_tiles) % co_tiles) * BN;
  const int tap0 = (blockIdx.x / (ci_tiles * co_tiles)) * 9;
  const int ntaps = min(9, kk - tap0);
  const int chunk = blockIdx.y;
  const int tile_begin = min(tiles, chunk * tiles_per_chunk);
  const int tile_end = min(tiles, tile_begin + tiles_per_chunk);
  // a tile's clip b and first frame and frequency
  auto tile_origin = [&](int tile, int& b, int& t0, int& f0) {
    b = tile / (tiles_t * f_tiles);
    const int r = tile - b * tiles_t * f_tiles;
    const int ti = r / f_tiles;
    t0 = ti * rows;
    f0 = (r - ti * f_tiles) * W;
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 12);             // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the gy rows past P, which no copy writes: zeros, so the k16 steps
  // that reach past the tile add nothing
  for (int s = 0; s < stages; ++s)
    for (int i = P * SWB + tid * 16; i < G_BYTES; i += 416 * 16)
      *reinterpret_cast<uint4*>(smem + s * stage_stride + halo_stride + i) =
          make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();

  if (wg == 3) {
    if (tid == 384) {
      for (int tile = tile_begin, it = 0; tile < tile_end; ++tile, ++it) {
        const int s = it % stages;
        int b, t0, f0;
        tile_origin(tile, b, t0, f0);
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], HR * HF * 128 + P * SWB);
        uint8_t* stage = smem + s * stage_stride;
        tma_load_4d(stage, &x_map, &full[s], ci0, f0 - hf, t0 - ht, b);
        tma_load_4d(stage + halo_stride, &gy_map, &full[s], co0, f0, t0, b);
      }
    }
  } else {
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    float acc[3][BN / 2];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[q][i] = 0.f;
    // taps 3 wg .. 3 wg + 2 of this block's group; a warpgroup with fewer
    // (nq < 3: 1x1 or odd kernels) computes the group's first tap in their
    // place and stores nothing of it, so no wgmma sits in a branch (ptxas
    // would serialize them). This lane's ldmatrix address: pixel offset
    // within a 16-pixel k step and channel chunk
    const int nq = max(0, min(3, ntaps - 3 * wg));
    int toff[3];   // a tap's shift in halo rows
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int tap = q < nq ? tap0 + 3 * wg + q : tap0;
      toff[q] = (tap / kf) * HF + tap % kf;
    }
    const int px_lane = (lane & 7) + (lane >> 4) * 8;
    const uint32_t chunk_off = (2 * warp + ((lane >> 3) & 1)) * 16;
    // the k16 steps that cover the tile's P pixels, an even count (steps
    // run in pairs); the pixels past P read the tile's last pixel
    const int k_steps = (P + 31) / 32 * 2;
    const uint32_t wmagic = wg_div_magic(W);
    // two sets of A fragments: a k step loads one while the products of
    // the step before still read the other
    uint32_t a[2][3][4];
    auto k_step = [&](auto set_tag, int k, uint32_t hbase, uint32_t gbase) {
      constexpr int SET = decltype(set_tag)::value;
      const int px = min(16 * k + px_lane, P - 1);
      const int pr = static_cast<int>((px * wmagic) >> 16);  // px / W
      const int base = pr * HF + px - pr * W;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const uint32_t row = static_cast<uint32_t>(base + toff[q]);
        ldsm_x4_trans(a[SET][q], hbase + swz<128>(row * 128 + chunk_off));
      }
      const uint64_t desc = gmma_desc(gbase + k * 16 * SWB, 8 * SWB, 8 * SWB,
                                      swizzle_layout<SWB>());
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 3; ++q) wgmma_rs<BN>(acc[q], a[SET][q], desc);
      wgmma_commit();
      wgmma_wait<1>();
    };

    for (int tile = tile_begin, it = 0; tile < tile_end; ++tile, ++it) {
      const int s = it % stages;
      uint8_t* stage = smem + s * stage_stride;
      mbar_wait(&full[s], (it / stages) & 1);
      if constexpr (AFFINE) {
        int b, t0, f0;
        tile_origin(tile, b, t0, f0);
        bnrelu_halo<128>(stage, HR * HF, HF, t0 - ht, f0 - hf, T, F, ci0,
                         Cin, scale, shift, tid, 384);
        consumer_sync(384);
      }
      const uint32_t hbase = smem_u32(stage);
      const uint32_t gbase = smem_u32(stage + halo_stride);
#pragma unroll 1
      for (int k = 0; k < k_steps; k += 2) {
        k_step(std::integral_constant<int, 0>{}, k, hbase, gbase);
        k_step(std::integral_constant<int, 1>{}, k + 1, hbase, gbase);
      }
      wgmma_wait<0>();
      if constexpr (AFFINE) fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // ---- epilogue: this chunk's f32 partials, rows ci < Cin, cols < Cout
    const int g = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (q >= nq) continue;
      fence_regs(acc[q]);
      const int tap = tap0 + 3 * wg + q;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int co = co0 + jj * 8 + 2 * tq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = ci0 + 16 * warp + g + 8 * h;
          if (ci < Cin && co < Cout)
            *reinterpret_cast<float2*>(
                partial +
                ((static_cast<long long>(chunk) * kk + tap) * Cin_pad + ci) *
                    Cout + co) =
                make_float2(acc[q][4 * jj + 2 * h], acc[q][4 * jj + 2 * h + 1]);
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime (no
// link against libcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map of ``rank`` dims (innermost first, byte strides of dims
// 1..rank-1) of bf16 (or ``type``) elements, box ``box``, out-of-range
// elements read as 0.
inline cudaError_t make_map(
    CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box, int swizzle_bytes,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc =
      fn(map, type, rank, const_cast<void*>(base),
         dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the 4-D (B, T, F, C) activation map with a (cb, w, h, 1) box, of bf16
// elements (``elem`` = 2 bytes) or f32 (4), swizzled by a box row
inline cudaError_t act_map(CUtensorMap* map, const void* base, int B, int T,
                           int F, int C, int cb, int w, int h, int elem = 2) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(elem) * C;
  const cuuint64_t strides[3] = {row, row * F, row * F * T};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cb),
                             static_cast<cuuint32_t>(w),
                             static_cast<cuuint32_t>(h), 1};
  return make_map(map, base, 4, dims, strides, box, cb * elem,
                  elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

inline int wg_kc(int Cin) { return Cin <= 16 ? 16 : Cin <= 32 ? 32 : 64; }
// 128 at most: an m64 x 256 accumulator (128 registers) leaves too few
// of the 168 a thread has for the wgmma pipeline, and ptxas serializes it.
// Below 16 output channels (the dx of a layer with Cin < 16) the 16-wide
// tile with the packed epilogue: a narrow tile's time goes to its chain of
// k16 steps (~6 000 cycles a 128-pixel tile on the H100, clock64 on
// each part of a tile), which an 8-wide one would not shorten
inline int wg_bn(int N) {
  return N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
}
// 32 at most: three taps of m64 x 32 f32 accumulators (48 registers) and
// two sets of A fragments fit the 128 registers of a 13-warp block; at 64
// ptxas serializes the wgmmas for want of registers
inline int dw_bn(int Cout) { return Cout <= 16 ? 16 : 32; }
// the bytes of a halo tile of (rows + kt - 1) frames x (W + kf - 1)
// pixels of row_bytes each, for a tile of rows x W pixels (rows = 128 / W
// where not given)
inline int halo_bytes(int W, int kt, int kf, int row_bytes, int rows = 0) {
  return ((rows > 0 ? rows : kWgTileM / W) + kt - 1) * (W + kf - 1) *
         row_bytes;
}

// shared memory of the forward kernel with ``hstages`` halo tiles of KC
// channels at a tile of rows x W pixels
inline int conv2d_wgmma_smem(int W, int rows, int kc, int N, int kt, int kf,
                             int hstages) {
  const int bn = wg_bn(N);
  return 1024 + hstages * align1024(halo_bytes(W, kt, kf, 2 * kc, rows)) +
         kWgBStages * align1024(wg_taps_per_stage(kc, bn) * kc * bn * 2) +
         wg_epi_bytes(bn) + (N + bn - 1) / bn * bn * 4 +
         2 * (kWgMaxHaloStages + kWgBStages) * 8;
}

inline int conv2d_dw_wgmma_smem(int W, int rows, int Cout, int kt, int kf,
                                int stages) {
  return 1024 +
         stages * (align1024(halo_bytes(W, kt, kf, 128, rows)) +
                   align1024(kWgTileM * dw_bn(Cout) * 2)) +
         2 * kDwMaxStages * 8;
}

// How a wgmma kernel runs a shape: the K slice (kc; 64 for the dw
// pass's x), the tile of rows x width pixels, the depth of the
// activation ring and the dynamic shared memory; width = 0 where no tile
// fits.
struct WgPlan {
  int kc, width, rows, stages, smem;
};

// The tile of a shape: rows = 128 / W whole frames of W = min(F, 128)
// frequencies (whole frequency rows up to F = 128), at the widest K slice
// whose ring of 2 stages fits 227 KB. Where none does (kernels of a dozen
// taps and more a side), the tile of most pixels (then least halo) among
// W = min(F, 128) / 2^i wide and 128 / W / 2^j frames tall whose ring
// fits. As many ring stages as fit, up to ``max_stages``, under ``cap``
// bytes where 2 stages fit there. ``smem(W, rows, kc, stages)`` gives a
// plan's shared memory; kc runs from ``kc_first`` down to 16.
template <typename Smem>
inline WgPlan wg_plan(int F, int kt, int kf, int kc_first, int max_stages,
                      int cap, const Smem& smem) {
  WgPlan best = {0, 0, 0, 0, 0};
  const int w0 = std::min(F, kWgTileM);
  for (int w = w0; w >= 1; w /= 2)
    for (int rows = kWgTileM / w; rows >= 1; rows /= 2) {
      // TMA's boxes: at most 256 a dimension
      if (rows + kt - 1 > 256 || w + kf - 1 > 256) continue;
      const int halo = (rows + kt - 1) * (w + kf - 1);
      const int best_halo =
          (best.rows + kt - 1) * (best.width + kf - 1);
      const bool better = best.width == 0 ||
                          rows * w > best.rows * best.width ||
                          (rows * w == best.rows * best.width &&
                           halo < best_halo);
      if (!better) continue;
      for (int kc = kc_first; kc >= 16; kc /= 2)
        if (smem(w, rows, kc, 2) <= kWgMaxSmem) {
          // the deepest ring under ``cap`` (two blocks an SM where the
          // kernel runs two) if 2 stages fit there, else under 227 KB
          const int lim =
              smem(w, rows, kc, 2) <= cap ? cap : kWgMaxSmem;
          int s = max_stages;
          while (smem(w, rows, kc, s) > lim) --s;
          best = {kc, w, rows, s, smem(w, rows, kc, s)};
          break;
        }
      // the default tile fits: taken as it is
      if (w == w0 && rows == kWgTileM / w0 && best.width > 0) return best;
    }
  return best;
}

// The forward-type GEMM (x with Cin channels -> N): Cin >= 16 at a
// multiple of 8, N below 16 or a multiple of 8; up to 4 halo stages (the
// deeper the ring, the further the producer fetches ahead).
inline WgPlan conv2d_wgmma_plan(int F, int Cin, int N, int kt, int kf) {
  if (F < 1 || Cin < 16 || Cin % 8 != 0 || N < 1 || (N >= 16 && N % 8 != 0))
    return {0, 0, 0, 0, 0};
  // the narrow tiles run two blocks an SM (the kernel's launch bounds):
  // a ring that leaves room for both (measured on the H100: a tile's
  // latency, not the copies' bandwidth, bounds them, so a second block
  // beats a deeper ring)
  const int cap = wg_bn(N) <= 32 ? kWgMaxSmem / 2 - 1024 : kWgMaxSmem;
  return wg_plan(F, kt, kf, wg_kc(Cin), kWgMaxHaloStages, cap,
                 [&](int w, int rows, int kc, int s) {
                   return conv2d_wgmma_smem(w, rows, kc, N, kt, kf, s);
                 });
}

// The dw pass: Cin >= 16 and Cout >= 16, both multiples of 8; x in
// 64-channel slices; up to 6 (x halo, gy) stages.
inline WgPlan conv2d_dw_wgmma_plan(int F, int Cin, int Cout, int kt,
                                   int kf) {
  if (F < 1 || Cin < 16 || Cin % 8 != 0 || Cout < 16 || Cout % 8 != 0)
    return {0, 0, 0, 0, 0};
  return wg_plan(F, kt, kf, 64, kDwMaxStages, kWgMaxSmem,
                 [&](int w, int rows, int kc, int s) {
                   return kc == 64 ? conv2d_dw_wgmma_smem(w, rows, Cout, kt,
                                                          kf, s)
                                   : kWgMaxSmem + 1;
                 });
}

// whether the forward-type GEMM (x with Cin channels -> N channels) runs
// the wgmma kernel, and the dw pass the dw one
inline bool conv2d_wgmma_ok(int F, int Cin, int N, int kt, int kf) {
  return conv2d_wgmma_plan(F, Cin, N, kt, kf).width > 0;
}

inline bool conv2d_dw_wgmma_ok(int F, int Cin, int Cout, int kt, int kf) {
  return conv2d_dw_wgmma_plan(F, Cin, Cout, kt, kf).width > 0;
}

template <int KC, int BN, bool AFFINE>
cudaError_t conv2d_wgmma_launch(const void* x, const void* w, const float* b,
                                const float* scale, const float* shift,
                                void* y, int B, int T, int F, int Cin, int N,
                                int kt, int kf, cudaStream_t stream,
                                int members, const WgPlan& plan) {
  const int W = plan.width;
  const int rows = plan.rows;
  CUtensorMap x_map, w_map;
  cudaError_t err = act_map(&x_map, x, members * B, T, F, Cin, KC,
                            W + kf - 1, rows + kt - 1);
  if (err != cudaSuccess) return err;
  // the weights' rows: N rounded up to 8, and to 16 below 16 (the
  // wrapper's zero columns): a box past the rows' end (TMA's zero fill in
  // the innermost dimension) took ~5 000 cycles a copy on the H100
  constexpr int BW = BN < 64 ? BN : 64;
  const int n8 = N < 16 ? 16 : (N + 7) / 8 * 8;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n8),
                              static_cast<cuuint64_t>(Cin),
                              static_cast<cuuint64_t>(members * kt * kf)};
  const cuuint64_t strides[2] = {2ull * n8, 2ull * n8 * Cin};
  // a stage's taps in one box (wg_taps_per_stage, at most the kernel's)
  const cuuint32_t box[3] = {
      BW, KC, static_cast<cuuint32_t>(
                  std::min(wg_taps_per_stage(KC, BN), kt * kf))};
  err = make_map(&w_map, w, 3, dims, strides, box, BW * 2);
  if (err != cudaSuccess) return err;
  auto kernel = conv2d_wgmma_kernel<KC, BN, AFFINE>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.smem);
  if (err != cudaSuccess) return err;
  // persistent blocks, as many as are resident at once: each walks the
  // (pixel, channel) tiles with the grid's stride, and its producer
  // fetches the next tile's halo while the consumers finish this one
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 288,
                                                        plan.smem);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(members) * B *
                          ((T + rows - 1) / rows) * ((F + W - 1) / W) *
                          ((N + BN - 1) / BN);
  const long long blocks = std::min<long long>(
      tiles, static_cast<long long>(std::max(per_sm, 1)) * sms);
  kernel<<<static_cast<unsigned>(blocks), 288, plan.smem, stream>>>(
      x_map, w_map, b, scale, shift, static_cast<__nv_bfloat16*>(y), B, T, F,
      Cin, N, kt, kf, W, rows, align1024(halo_bytes(W, kt, kf, 2 * KC, rows)),
      plan.stages, members);
  return cudaGetLastError();
}

template <int KC, bool AFFINE>
cudaError_t conv2d_wgmma_bn(const void* x, const void* w, const float* b,
                            const float* scale, const float* shift, void* y,
                            int B, int T, int F, int Cin, int N, int kt,
                            int kf, cudaStream_t s, int members,
                            const WgPlan& plan) {
  switch (wg_bn(N)) {
    case 16:
      return conv2d_wgmma_launch<KC, 16, AFFINE>(x, w, b, scale, shift, y, B,
                                                 T, F, Cin, N, kt, kf, s,
                                                 members, plan);
    case 32:
      return conv2d_wgmma_launch<KC, 32, AFFINE>(x, w, b, scale, shift, y, B,
                                                 T, F, Cin, N, kt, kf, s,
                                                 members, plan);
    case 64:
      return conv2d_wgmma_launch<KC, 64, AFFINE>(x, w, b, scale, shift, y, B,
                                                 T, F, Cin, N, kt, kf, s,
                                                 members, plan);
    default:
      return conv2d_wgmma_launch<KC, 128, AFFINE>(x, w, b, scale, shift, y,
                                                  B, T, F, Cin, N, kt, kf, s,
                                                  members, plan);
  }
}

// the forward-type GEMM on the wgmma kernel; ``members`` stacked members
// (x (members, B, T, F, Cin), w (members, kt, kf, Cin, N8) with N8 = N
// rounded up to 8, 16 below 16, b (members, N), scale and shift (members,
// Cin), y
// (members, B, T, F, N)) in one launch
template <bool AFFINE>
cudaError_t conv2d_wgmma(const void* x, const void* w, const float* b,
                         const float* scale, const float* shift, void* y,
                         int B, int T, int F, int Cin, int N, int kt, int kf,
                         cudaStream_t s, int members = 1) {
  const WgPlan plan = conv2d_wgmma_plan(F, Cin, N, kt, kf);
  switch (plan.kc) {
    case 16:
      return conv2d_wgmma_bn<16, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                         Cin, N, kt, kf, s, members, plan);
    case 32:
      return conv2d_wgmma_bn<32, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                         Cin, N, kt, kf, s, members, plan);
    case 64:
      return conv2d_wgmma_bn<64, AFFINE>(x, w, b, scale, shift, y, B, T, F,
                                         Cin, N, kt, kf, s, members, plan);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int BN, bool AFFINE>
cudaError_t conv2d_dw_wgmma_launch(const void* x, const void* gy,
                                   const float* scale, const float* shift,
                                   void* ws, int Cin_pad, int B, int T, int F,
                                   int Cin, int Cout, int kt, int kf,
                                   int chunks, cudaStream_t s,
                                   const WgPlan& plan) {
  const int W = plan.width;
  const int rows = plan.rows;
  CUtensorMap x_map, gy_map;
  cudaError_t err = act_map(&x_map, x, B, T, F, Cin, 64, W + kf - 1,
                            rows + kt - 1);
  if (err != cudaSuccess) return err;
  err = act_map(&gy_map, gy, B, T, F, Cout, BN, W, rows);
  if (err != cudaSuccess) return err;
  auto kernel = conv2d_dw_wgmma_kernel<BN, AFFINE>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             plan.smem);
  if (err != cudaSuccess) return err;
  const int tiles = B * ((T + rows - 1) / rows) * ((F + W - 1) / W);
  const int per_chunk = (tiles + chunks - 1) / chunks;
  const int ci_tiles = (Cin + 63) / 64;
  const int co_tiles = (Cout + BN - 1) / BN;
  const dim3 grid(ci_tiles * co_tiles * ((kt * kf + 8) / 9), chunks);
  kernel<<<grid, 416, plan.smem, s>>>(
      x_map, gy_map, scale, shift, static_cast<float*>(ws), T, F, Cin,
      Cin_pad, Cout, kt, kf, W, rows, tiles, per_chunk, ci_tiles, co_tiles,
      align1024(halo_bytes(W, kt, kf, 128, rows)), plan.stages);
  return cudaGetLastError();
}

template <bool AFFINE>
cudaError_t conv2d_dw_wgmma(const void* x, const void* gy, const float* scale,
                            const float* shift, void* ws, int Cin_pad, int B,
                            int T, int F, int Cin, int Cout, int kt, int kf,
                            int chunks, cudaStream_t s) {
  const WgPlan plan = conv2d_dw_wgmma_plan(F, Cin, Cout, kt, kf);
  if (plan.width == 0) return cudaErrorInvalidValue;
  switch (dw_bn(Cout)) {
    case 16:
      return conv2d_dw_wgmma_launch<16, AFFINE>(x, gy, scale, shift, ws,
                                                Cin_pad, B, T, F, Cin, Cout,
                                                kt, kf, chunks, s, plan);
    default:
      return conv2d_dw_wgmma_launch<32, AFFINE>(x, gy, scale, shift, ws,
                                                Cin_pad, B, T, F, Cin, Cout,
                                                kt, kf, chunks, s, plan);
  }
}

}  // namespace
