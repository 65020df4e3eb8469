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
// and a step's work is nothing; what a step costs is the latency of its
// chain. Only dh is carried from step to step: the gate product
// h_prev[t] @ w_hh reads a saved input and depends on nothing the sweep
// computes. w_hh (384 KiB of bf16 per direction at H = 256, 1.5 MiB at
// H = 512) does not fit one block's shared memory, and a step needs it
// twice: h_prev @ w_hh for the gates and dgates @ w_hh^T for dh.
//
// Two designs, chosen by shape in pbsed_gru_scan_bwd
// (pbsed_gru_bwd_design says which):
//
// 1. Few rows, many steps (the training step: B = 32, T = 500), and at
//    H = 512 every shape (the rule is gru_cluster_takes in
//    gru_cluster.cuh): gru_bwd_cluster_kernel (gru_bwd_cluster.cuh), the
//    forward's cluster layout: a cluster of H / 32 blocks per row tile,
//    each block with its slice of w_hh in shared memory, the partials of
//    dh exchanged through distributed shared memory, one cluster barrier
//    a step, the next step's gate product between its arrive and wait.
// 2. Every other shape up to H = 512: the row-tiled sweep of gru_bwd.cuh
//    (one block per (direction, tile of 32 batch rows, 16 when H > 256),
//    w_hh fragments from global memory twice a step, four barriers a
//    step).
// 3. H above 512 (to 2048): the wide sweep of gru_wide.cuh, with a
//    workspace for each block's bf16 dgates of a step.
// The fused variant (gru_bwd_fused.cu) runs the first two designs, so up
// to H = 512.
#include "gru_bwd_cluster.cuh"
#include "gru_wide.cuh"

// xw (D, B, T, 3H) bf16, h_prev (D, B, T, H) bf16 (= concat(h0, y[:-1])
// along T), w_hh (D, H, 3H) bf16, b_hh (D, 3H) f32, g (D, B, T, H) f32;
// outputs dxw (D, B, T, 3H) bf16, r (D, B, T, H) bf16, dh0 (D, B, H) f32;
// above H = 512 a workspace of pbsed_gru_bwd_workspace(D, B, H) bytes
// (unused, may be null, below). Contiguous, h_prev 16-byte aligned, the
// workspace 32-byte aligned. Requires H % 32 == 0 and H <= 2048 (the
// wrapper pads any other H with zero units). Above H = 512 the wide sweep;
// else the cluster design where gru_cluster_takes says so, else the
// row-tiled sweep (blockDim = H; tiles of 32 rows up to H = 256, of 16
// above). Returns a cudaError_t (cudaErrorLaunchOutOfResources where the
// card holds no cluster of the design at all).
extern "C" int pbsed_gru_scan_bwd(const void* xw, const void* h_prev,
                                  const void* w_hh, const void* b_hh,
                                  const void* g, void* dxw, void* r,
                                  void* dh0, void* workspace, int D, int B,
                                  int T, int H, void* stream) {
  if (H % 32 != 0 || H < 32 || H > kWideMaxH || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gru_wide_takes(H)) {
    if (workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(gru_wide_bwd(xw, h_prev, w_hh, b_hh, g, dxw, r,
                                         dh0, workspace, D, B, T, H, s));
  }
  if (!gru_cluster_takes(D, B, T, H))
    return static_cast<int>(gru_bwd_sweep<false>(xw, h_prev, w_hh, b_hh, g,
                                                 dxw, r, dh0, nullptr, nullptr,
                                                 nullptr, D, B, T, H, s));
  int rows = 0;
  return static_cast<int>(bwd_cluster<false>(xw, h_prev, w_hh, b_hh, g, dxw,
                                             r, dh0, nullptr, nullptr,
                                             nullptr, D, B, T, H, s, &rows));
}

// Which design pbsed_gru_scan_bwd runs at (D, B, T, H); the arguments and
// the result as pbsed_gru_design (gru.cu).
extern "C" int pbsed_gru_bwd_design(int D, int B, int T, int H, int* cluster,
                                    int* rows, int* smem, int* coresident) {
  if (gru_wide_takes(H))
    return gru_wide_design(H, true, cluster, rows, smem, coresident);
  return bwd_design<false>(D, B, T, H, cluster, rows, smem, coresident);
}

// Bytes of the workspace pbsed_gru_scan_bwd needs at (D, B, H): the wide
// sweep's bf16 dgates of a step, 16 rows x 3H a block; 0 up to H = 512.
extern "C" long long pbsed_gru_bwd_workspace(int D, int B, int H) {
  return gru_wide_takes(H)
             ? static_cast<long long>(gru_wide_bwd_workspace(D, B, H))
             : 0;
}
