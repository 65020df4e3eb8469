// The fused GRU backward: the reverse sweep of gru_bwd.cuh with dw_hh
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
// w_hh re-read from L2 twice a step), plus the accumulator: (H, 3H) f32
// per direction, 3 MiB at H = 512, far more than a block's shared
// memory (on the TPU it was what kept this kernel out of VMEM above
// H = 256).
//
// What the design does about it: blocks run in no order, so each sweep
// block owns an f32 slice (H, 3H) of a device-memory workspace (L2
// resident at the shapes of the recipes: 4 blocks x 3 MiB at H = 512,
// B = 32). Each step it copies its bf16 h_prev and dgates rows to a
// scratch ring of 16 steps; every 16 steps its warps add the product of
// those rows into the slice with bf16 tensor-core products (wmma
// 16x16x16, f32 accumulate), one read-modify-write of the slice per 16
// steps instead of per step. db_hh is summed per thread in registers.
// A second kernel adds the slices of each direction in block order: two
// runs give bit-identical dw_hh and db_hh (no float atomics).
#include "gru_bwd.cuh"

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

// Inputs as pbsed_gru_scan_bwd (gru_bwd.cu). Outputs dxw (D, B, T, 3H)
// bf16, dw_hh (D, H, 3H) f32, db_hh (D, 3H) f32, dh0 (D, B, H) f32.
// Workspace, with blocks = ceil(B / rows) and rows = 32 for H <= 256, 16
// above: dw_part (D * blocks, H, 3H) f32 ZEROED, db_part (D * blocks,
// 3H) f32, scratch (D * blocks, 16 * rows, 4H) bf16. Contiguous, h_prev
// 16-byte aligned, dw_part and scratch 32-byte aligned. Requires
// H % 32 == 0 and H <= 512. Returns a cudaError_t.
extern "C" int pbsed_gru_scan_bwd_fused(
    const void* xw, const void* h_prev, const void* w_hh, const void* b_hh,
    const void* g, void* dxw, void* dw_hh, void* db_hh, void* dh0,
    void* dw_part, void* db_part, void* scratch, int D, int B, int T, int H,
    void* stream) {
  if (H % 32 != 0 || H < 32 || H > 512 || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + (H <= 256 ? 31 : 15)) / (H <= 256 ? 32 : 16);
  const long long G = 3LL * H;
  if (B == 0) {
    cudaError_t err = cudaMemsetAsync(dw_hh, 0, sizeof(float) * D * H * G, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(db_hh, 0, sizeof(float) * D * G, s);
    return static_cast<int>(err);
  }
  cudaError_t err = gru_bwd_sweep<true>(xw, h_prev, w_hh, b_hh, g, dxw,
                                        nullptr, dh0, dw_part, db_part,
                                        scratch, D, B, T, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = reduce_parts(static_cast<const float*>(dw_part),
                     static_cast<float*>(dw_hh), D, blocks, H * G, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_parts(static_cast<const float*>(db_part),
                                       static_cast<float*>(db_hh), D, blocks,
                                       G, s));
}
