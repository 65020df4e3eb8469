// The fused GRU backward: the reverse sweep of gru_bwd.cu with dw_hh
// and db_hh accumulated inside the kernel instead of emitting r for an
// outside contraction.
//
//   dw_hh[d] = sum_{b, t} bf16(h_prev[d, b, t])^T bf16(dgates[d, b, t])
//   db_hh[d] = sum_{b, t} dgates[d, b, t]   (f32, unrounded)
//
// with dgates = [dpr, dz, dpn * r] computed in f32 in the sweep (the
// split variant instead rounds dxw and r and multiplies those).
//
// Replaces: pb_sed_tpu/ops/pallas/gru.py:_gru_bwd_kernel (reached through
// _gru_scan_pallas_bwd(split=False)), which carries dh in scratch and
// adds each time block's h_prev^T @ dgates into its revisited
// (H, D*3H) f32 output block. As in the JAX package, no training path
// selects it: the split kernel (gru_bwd.cu) stays the default.
//
// What bounds it on the H100: the sweep as in gru_bwd.cu (serial in t,
// the latency of a step's chain), plus the accumulator: (H, 3H) f32 per
// direction, 3 MiB at H = 512, far more than a block's shared memory (on
// the TPU it was what kept this kernel out of VMEM above H = 256).
//
// What the design does about it: the split backward's two designs, chosen
// by the same rule (pbsed_gru_bwd_fused_design says which), each with the
// accumulation added off its chain:
// 1. the cluster sweep (gru_bwd_cluster.cuh, FUSED): block c of a cluster
//    owns the gate columns cols(U_c), so it alone writes dw_hh[:, cols(U_c)]
//    of its (direction, row tile): every 16 steps one K = 16 product a
//    batch row from a global ring of its bf16 dgates and h_prev in global
//    memory into that f32 slice, between the cluster barrier's arrive and
//    wait; db_hh in per-thread registers;
// 2. the row-tiled sweep (gru_bwd.cuh, FUSED): each block owns an f32
//    (H, 3H) slice, filled every 16 steps from a scratch ring of its bf16
//    h_prev and dgates rows.
// Either way the slices are disjoint and need no zeroing; a second kernel
// adds them over the row tiles in tile order: two runs give bit-identical
// dw_hh and db_hh (no float atomics).
#include "gru_bwd_cluster.cuh"

namespace {

// out[d, e] = sum over the blocks of direction d, in block order, of
// part[d * blocks + blk, e], for n elements per direction
__global__ void gru_part_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int D,
                                       int blocks, long long n) {
  const long long total = static_cast<long long>(D) * n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long d = e / n;
    const long long i = e % n;
    float s = 0.f;
    for (int blk = 0; blk < blocks; ++blk)
      s += part[(d * blocks + blk) * n + i];
    out[e] = s;
  }
}

cudaError_t reduce_parts(const float* part, float* out, int D, int blocks,
                         long long n, cudaStream_t s) {
  const int threads = 256;
  long long grid = (static_cast<long long>(D) * n + threads - 1) / threads;
  if (grid > 4096) grid = 4096;
  if (grid < 1) grid = 1;
  gru_part_reduce_kernel<<<static_cast<unsigned>(grid), threads, 0, s>>>(
      part, out, D, blocks, n);
  return cudaGetLastError();
}

}  // namespace

// Inputs as pbsed_gru_scan_bwd (gru_bwd.cu), but h_prev followed in
// memory by at least 15 H finite values (the cluster sweep reads up to 15
// steps past the last row's end, with zero weight). Outputs dxw (D, B, T,
// 3H) bf16, dw_hh (D, H, 3H) f32, db_hh (D, 3H) f32, dh0 (D, B, H) f32.
// Workspace, with rows as pbsed_gru_bwd_fused_design reports and parts =
// D * ceil(B / rows): dw_part (parts, H, 3H) f32, db_part (parts, 3H) f32,
// scratch (parts, 16 * rows, 4H) bf16; none needs zeroing. Contiguous,
// h_prev 16-byte aligned, dw_part and scratch 32-byte aligned. Requires
// H % 32 == 0 and H <= 512 (the wrapper pads any other H up to 512 with
// zero units). Returns a cudaError_t.
extern "C" int pbsed_gru_scan_bwd_fused(
    const void* xw, const void* h_prev, const void* w_hh, const void* b_hh,
    const void* g, void* dxw, void* dw_hh, void* db_hh, void* dh0,
    void* dw_part, void* db_part, void* scratch, int D, int B, int T, int H,
    void* stream) {
  if (H % 32 != 0 || H < 32 || H > 512 || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long G = 3LL * H;
  if (B == 0) {
    cudaError_t err = cudaMemsetAsync(dw_hh, 0, sizeof(float) * D * H * G, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(db_hh, 0, sizeof(float) * D * G, s);
    return static_cast<int>(err);
  }
  int rows = H <= 256 ? 32 : 16;
  cudaError_t err =
      gru_cluster_takes(D, B, T, H)
          ? bwd_cluster<true>(xw, h_prev, w_hh, b_hh, g, dxw, nullptr, dh0,
                              dw_part, db_part, scratch, D, B, T, H, s, &rows)
          : gru_bwd_sweep<true>(xw, h_prev, w_hh, b_hh, g, dxw, nullptr, dh0,
                                dw_part, db_part, scratch, D, B, T, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + rows - 1) / rows;
  err = reduce_parts(static_cast<const float*>(dw_part),
                     static_cast<float*>(dw_hh), D, blocks, H * G, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_parts(static_cast<const float*>(db_part),
                                       static_cast<float*>(db_hh), D, blocks,
                                       G, s));
}

// Which design pbsed_gru_scan_bwd_fused runs at (D, B, T, H); the
// arguments and the result as pbsed_gru_design (gru.cu). `rows` sizes the
// workspace.
extern "C" int pbsed_gru_bwd_fused_design(int D, int B, int T, int H,
                                          int* cluster, int* rows, int* smem,
                                          int* coresident, int* units,
                                          int* resident, int* streamed) {
  if (H % 32 != 0 || H < 32 || H > 512)  // the fused sweep stops at 512
    return -static_cast<int>(cudaErrorInvalidValue);
  return bwd_design<true>(D, B, T, H, cluster, rows, smem, coresident, units,
                          resident, streamed);
}
