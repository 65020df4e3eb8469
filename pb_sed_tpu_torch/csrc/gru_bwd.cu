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
// and at few rows a step's work is nothing; what a step costs is the
// latency of its chain. Only dh is carried from step to step: the gate
// product h_prev[t] @ w_hh reads a saved input and depends on nothing the
// sweep computes. w_hh (384 KiB of bf16 per direction at H = 256, 1.5 MiB
// at H = 512) does not fit one block's shared memory, and a step needs it
// twice: h_prev @ w_hh for the gates and dgates @ w_hh^T for dh.
//
// Three designs, chosen by shape in pbsed_gru_scan_bwd
// (pbsed_gru_bwd_design says which), each spreading w_hh over a
// thread-block cluster (block c owns 32 hidden units and keeps its slice
// w_hh[:, cols(U_c)] in shared memory) and adding the partials of dh in
// rank order:
//
// 1. Few rows, many steps (the training step: B = 32, T = 500) at
//    H = 256, up to 15 row tiles of 16, and at H = 512 every shape (the
//    rule is gru_cluster_takes in gru_cluster.cuh):
//    gru_bwd_cluster_kernel (gru_bwd_cluster.cuh), the forward's cluster
//    layout: a cluster of H / 32 blocks per row tile of 16 or 32, the
//    partials of dh exchanged through distributed shared memory, one
//    cluster barrier a step, the next step's gate product between its
//    arrive and wait; wmma.
// 2. Every other shape up to H = 256 (every H below 256 at any batch, 256
//    past 15 row tiles of 16): the wgmma rows design (gru_bwd_rows.cuh), a
//    cluster of H / 32 blocks per tile of 64 rows, both products on wgmma
//    with the gate math on the accumulators, the partials of dh sent by
//    bulk copies counted on mbarriers.
// 3. H above 512 (a multiple of 256, to 2048): the cluster design with
//    H / 16 units a block (gru_cluster_wide.cuh): the slice of w_hh that
//    does not fit a block's shared memory streams from L2 through a
//    cp.async ring once a step for both products, dh's partials go into
//    single-buffered receive slots under two split cluster barriers.
// 4. H above 2048 (a multiple of 64): the grid design (gru_grid.cuh),
//    pbsed_gru_scan_bwd_grid below: one persistent block an SM, launched
//    cooperatively, the bf16 dgates exchanged through a global buffer in
//    L2, one grid-wide barrier a step, dh of a block's units from all
//    dgates and its rows of w_hh.
// The fused variant (gru_bwd_fused.cu) runs the first two designs, so up
// to H = 512. H from 288 to 480 fits none of them: the wrapper runs it
// as 512.
#include "gru_bwd_rows.cuh"
#include "gru_cluster_wide.cuh"
#include "gru_grid.cuh"

// xw (D, B, T, 3H) bf16, h_prev (D, B, T, H) bf16 (= concat(h0, y[:-1])
// along T), w_hh (D, H, 3H) bf16, b_hh (D, 3H) f32, g (D, B, T, H) f32;
// outputs dxw (D, B, T, 3H) bf16, r (D, B, T, H) bf16, dh0 (D, B, H) f32.
// Contiguous, xw, h_prev and w_hh 16-byte aligned; above H = 512 w_hh
// packed, (D, 16, H, 3H / 16 + 8) (ops/kernels/gru.py:pack_wide).
// Requires H % 32 == 0 up to 256, H = 512, or H % 256 == 0 above, to 2048
// (the wrapper pads any other H with zero units). Above H = 512 the
// cluster design of gru_cluster_wide.cuh; else the cluster design where
// gru_cluster_takes says so, else the wgmma rows design. Returns a
// cudaError_t (cudaErrorInvalidValue for an H no design takes,
// cudaErrorLaunchOutOfResources where the card holds no cluster of the
// design at all). H above 2048 is pbsed_gru_scan_bwd_grid's.
extern "C" int pbsed_gru_scan_bwd(const void* xw, const void* h_prev,
                                  const void* w_hh, const void* b_hh,
                                  const void* g, void* dxw, void* r,
                                  void* dh0, int D, int B, int T, int H,
                                  void* stream) {
  if (H % 32 != 0 || H < 32 || H > kWideMaxH ||
      (H > kWideMinH && !gru_wide_takes(H)) || D < 1 || D > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0)
    return static_cast<int>(
        cudaMemsetAsync(dh0, 0, sizeof(float) * D * B * H, s));
  if (gru_wide_takes(H))
    return static_cast<int>(
        gru_wide_bwd(xw, h_prev, w_hh, b_hh, g, dxw, r, dh0, D, B, T, H, s));
  int rows = 0;
  return static_cast<int>(gru_bwd_sweep<false>(xw, h_prev, w_hh, b_hh, g,
                                               dxw, r, dh0, nullptr, nullptr,
                                               nullptr, D, B, T, H, s,
                                               &rows));
}

// The split backward above H = 2048: the grid design (gru_grid.cuh).
// Operands as pbsed_gru_scan_bwd's, but w_hh twice, packed for each
// product (ops/kernels/gru.py:pack_grid): w_gate (D, H / 16, H, 48) and
// w_dh (D, H / 16, 3H / 64, 16, 64); H a multiple of 64;
// workspace: 256 + 12 D B H bytes, 16-byte aligned (the
// barrier's counter, then the exchanged dgates (2, min(D, SMs), B, 3H)
// bf16); dh0 also carries dh through the sweep. Returns a cudaError_t
// (cudaErrorCooperativeLaunchTooLarge where the card cannot hold the grid
// at once).
extern "C" int pbsed_gru_scan_bwd_grid(const void* xw, const void* h_prev,
                                       const void* w_gate, const void* w_dh,
                                       const void* b_hh, const void* g,
                                       void* dxw, void* r, void* dh0,
                                       void* workspace, int D, int B, int T,
                                       int H, void* stream) {
  if (!gru_grid_takes(H) || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0)
    return static_cast<int>(cudaMemsetAsync(
        dh0, 0, sizeof(float) * static_cast<size_t>(D) * B * H, s));
  return static_cast<int>(gru_grid_bwd(xw, h_prev, w_gate, w_dh, b_hh, g, dxw,
                                       r, dh0, workspace, D, B, T, H, s));
}

// Which design pbsed_gru_scan_bwd (pbsed_gru_scan_bwd_grid above H = 2048)
// runs at (D, B, T, H): 1 for the cluster designs (above H = 512 that of
// gru_cluster_wide.cuh), 2 for the wgmma rows design, 3 for the grid
// design; the arguments and the failure as pbsed_gru_design (gru.cu).
extern "C" int pbsed_gru_bwd_design(int D, int B, int T, int H, int* cluster,
                                    int* rows, int* smem, int* coresident,
                                    int* units, int* resident, int* streamed) {
  if (gru_grid_runs(H))
    return gru_grid_design<true>(D, B, T, H, cluster, rows, smem, coresident,
                                 units, resident, streamed);
  if (gru_wide_takes(H))
    return gru_wide_design<true>(D, B, H, cluster, rows, smem, coresident,
                                 units, resident, streamed);
  return bwd_design<false>(D, B, T, H, cluster, rows, smem, coresident, units,
                           resident, streamed);
}
