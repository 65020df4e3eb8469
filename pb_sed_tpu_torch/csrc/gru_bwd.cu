// Backward of the GRU recurrence (gru.cu), torch gate order (r, z, n),
// for D independent directions at once: the reverse sweep over t that
// recomputes the gates from the bf16 previous state and carries dh.
//
//   hw    = bf16(h_prev) @ bf16(w_hh) (f32 accumulate) + b_hh
//   r, z  = sigmoid(xw_{r,z} + hw_{r,z});  n = tanh(xw_n + r * hw_n)
//   dh_t  = g[t] + dh
//   dz    = dh_t * (h_prev - n) * z * (1 - z)
//   dpn   = dh_t * (1 - z) * (1 - n^2);  dpr = dpn * hw_n * r * (1 - r)
//   dxw[t] = bf16([dpr, dz, dpn]);  r_out[t] = bf16(r)
//   dh    = dh_t * z + bf16([dpr, dz, dpn * r]) @ bf16(w_hh)^T (f32 acc)
//   dh0   = dh after t = 0
//
// Replaces: pb_sed_tpu/ops/pallas/gru.py:_gru_bwd_split_kernel (reached
// through _gru_scan_pallas_bwd(split=True), the production backward),
// with its rounding points (gru.py:394-426): h_prev rounded to bf16 and
// used both in the recompute and in dz, dxw and r written in bf16, dh
// carried in f32. As there, dw_hh and db_hh are NOT accumulated in the
// sweep: the wrapper contracts them afterwards over the (B*T) axis from
// bf16 h_prev and the bf16 product dxw_n * r (gru.py:546-552).
//
// What bounds it on the H100: like the forward, the sweep is serial in t
// and each step multiplies a thin (rows x H) operand by w_hh twice:
// h_prev @ w_hh (H x 3H) for the gates and dgates @ w_hh^T (3H x H) for
// dh. At H = 256 w_hh is 384 KiB of bf16 per direction, more than a
// block's shared memory, so each step re-reads it twice from L2; with few
// rows per block the step is bound by those reads and their latency.
//
// What the design does about it: the forward kernel's layout. One block
// per (direction, tile of 32 batch rows, 16 when H > 256); rows never
// interact. Each step the tile's bf16 h_prev rows are copied into shared
// memory (cp.async); warp w computes the 96 gate columns [96w, 96w + 96)
// with bf16 tensor-core products (wmma 16x16x16, w_hh fragments from
// global memory one K slice ahead); in the elementwise phase thread j
// owns hidden unit j of every row and keeps dh in registers. That phase
// reads xw and g from global memory: it issues the loads of 8 rows at
// once (from a valid row also past the batch) before it uses any, so
// their latency is paid once per 8 rows, not per row (at (2, 32, 500,
// 256) this took the kernel from 49.2 to 33.5 ms on an H100 80GB HBM3 at
// 700 W; double-buffering h_prev and prefetching the w_hh^T slices moved
// nothing). It writes dxw and r; then warp w computes the 32 columns
// [32w, 32w + 32) of dgates @ w_hh^T, reading w_hh column-major. Four
// barriers per step. blockDim = H, so H must be a multiple of 32. At
// B = 32 only 2 blocks run per direction pair.
#include "gru_bwd.cuh"

// xw (D, B, T, 3H) bf16, h_prev (D, B, T, H) bf16 (= concat(h0, y[:-1])
// along T), w_hh (D, H, 3H) bf16, b_hh (D, 3H) f32, g (D, B, T, H) f32;
// outputs dxw (D, B, T, 3H) bf16, r (D, B, T, H) bf16, dh0 (D, B, H) f32.
// Contiguous, h_prev 16-byte aligned. Requires H % 32 == 0 and H <= 512
// (blockDim = H). Tiles of 32 rows up to H = 256, of 16 rows above
// (shared memory). Returns a cudaError_t.
extern "C" int pbsed_gru_scan_bwd(const void* xw, const void* h_prev,
                                  const void* w_hh, const void* b_hh,
                                  const void* g, void* dxw, void* r,
                                  void* dh0, int D, int B, int T, int H,
                                  void* stream) {
  if (H % 32 != 0 || H < 32 || H > 512 || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  return static_cast<int>(gru_bwd_sweep<false>(
      xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, nullptr, nullptr, nullptr, D, B,
      T, H, static_cast<cudaStream_t>(stream)));
}
