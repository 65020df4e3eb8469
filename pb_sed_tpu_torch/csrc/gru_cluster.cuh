// What the cluster designs of the GRU forward (gru.cu) and the split
// backward (gru_bwd.cu) share: the layout constants, the PTX for a
// thread-block cluster (rank, split barrier, stores into another block's
// shared memory), the copy of a block's slice of w_hh into shared memory,
// the rule that says which shapes take the design, and its launch.
//
// The layout. A cluster of C = H / 32 blocks (8 at H = 256, 16 at
// H = 512) serves one (direction, tile of 16 or 32 batch rows). Block c
// owns the 32 hidden units U_c = [32c, 32c + 32) and so the 96 gate
// columns cols(U_c): the stripe U_c of each of r, z and n. Its slice
// w_hh[:, cols(U_c)] (H x 96 bf16, 96 KiB at H = 512) is copied into
// shared memory once, transposed (96 rows of H values, rows padded by 8
// values so that fragment loads meet no bank conflict), and is never read
// from global memory again. Transposed it is the col-major B operand of
// `state @ slice` (K = H) and the row-major B operand of
// `dgates_own @ slice^T` (K = 96), so one copy serves both products of
// the backward.
//
// The tensor-core instruction is wmma 16x16x16 (mma.sync underneath) with
// both operands in shared memory: a step is bound by the latency of the
// chain barrier -> products -> gate math -> exchange, not by the tensor
// rate (a step is 50 MFLOP per direction at H = 512), and wgmma's 64-row
// tile would want the swapped product and an accumulator layout written
// out by hand for nothing in return.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kClUnits = 32;           // hidden units a block owns
constexpr int kClCols = 3 * kClUnits;  // its gate columns (r, z, n stripes)
constexpr int kClColTiles = kClCols / 16;
constexpr int kClWarps = 16;
constexpr int kClThreads = 32 * kClWarps;
constexpr int kClMmaWarps = 2 * kClColTiles;  // column tile x half of K
constexpr int kClPad = 8;         // bf16 values of padding per H-long row
constexpr int kClLdg = 100;       // f32 row stride of the gate buffers
// At H = 256 the backwards take the design at a shape whose row tiles of
// 16 (over all directions) number at most this many (see
// gru_cluster_takes); the forward at H = 256 and 512 at most the next one
// (see gru_fwd_cluster_takes).
constexpr int kClMaxTiles16 = 15;
constexpr int kClMaxTiles16Fwd = 4;

__device__ __forceinline__ float cl_sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ uint32_t cl_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cl_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in its two halves: what a thread wrote before its
// arrive (into its own or another block's shared memory) is visible to
// every thread of the cluster after that thread's wait.
__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of this block's shared-memory location `addr` in block
// `rank` of the cluster
__device__ __forceinline__ uint32_t cl_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void cl_store16(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// sT[n][k] = w[k][gate(n) * H + u0 + n % 32] for the block's 96 gate
// columns n (gate(n) = n / 32) and all k < H; rows of sT are H + kClPad
// values apart. Once per launch.
__device__ __forceinline__ void cl_load_slice(__nv_bfloat16* sT,
                                              const __nv_bfloat16* w, int H,
                                              int u0) {
  const int ldh = H + kClPad;
  const int G = 3 * H;
  for (int e = threadIdx.x; e < H * kClCols; e += blockDim.x) {
    const int k = e / kClCols;
    const int n = e - k * kClCols;
    sT[n * ldh + k] =
        w[static_cast<size_t>(k) * G + (n / kClUnits) * H + u0 + n % kClUnits];
  }
}

// gs[half][m * 16 + .][tile * 16 + .] = a[m * 16 + ., half of K] @
// slice[half of K, tile * 16 + .]: warp w < 12 takes column tile w % 6
// and the half w / 6 of K = H, for all MT row tiles of `a` ((16 MT, ldh)
// bf16 in shared memory). Two accumulators a row tile, so that
// consecutive products do not wait on each other. The caller adds the two
// halves.
template <int MT>
__device__ __forceinline__ void cl_gate_product(const __nv_bfloat16* a,
                                                const __nv_bfloat16* sT,
                                                float* gs, int H, int warp) {
  using namespace nvcuda;
  if (warp >= kClMmaWarps) return;
  const int ldh = H + kClPad;
  const int tile = warp % kClColTiles;
  const int half = warp / kClColTiles;
  const int steps = H / 32;  // 16-deep K steps in one half, even
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    wmma::fill_fragment(acc[m][0], 0.f);
    wmma::fill_fragment(acc[m][1], 0.f);
  }
  const __nv_bfloat16* b_ptr = sT + tile * 16 * ldh + half * steps * 16;
  const __nv_bfloat16* a_ptr = a + half * steps * 16;
  for (int k = 0; k < steps; k += 2) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b_frag;
      wmma::load_matrix_sync(b_frag, b_ptr + (k + p) * 16, ldh);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a_frag;
        wmma::load_matrix_sync(a_frag, a_ptr + m * 16 * ldh + (k + p) * 16,
                               ldh);
        wmma::mma_sync(acc[m][p], a_frag, b_frag, acc[m][p]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < acc[m][0].num_elements; ++i)
      acc[m][0].x[i] += acc[m][1].x[i];
    wmma::store_matrix_sync(
        gs + (half * 16 * MT + m * 16) * kClLdg + tile * 16, acc[m][0], kClLdg,
        wmma::mem_row_major);
  }
}

// Does (D, B, T, H) take the cluster design in the split and fused
// backwards? H = 256 or 512 (C = 8 or 16 blocks of 32 units) and at least
// one step. The design is made for few rows and many steps (training,
// tagging: B = 32, T = 500). At H = 512 it takes every shape: the wgmma
// rows design of gru_bwd_rows.cuh does not fit a block above H = 256. At
// H = 256 it takes few row tiles only, up to ``max_tiles16``: as many as
// the card holds clusters of 8 blocks of 16 rows at once (15 on an H100
// SXM); beyond, its clusters take 32 rows and the rows design is the
// faster. Every other shape up to H = 256 runs the rows design. Split
// sweep ms at T = 500, cluster against rows (scripts/perf/
// gru_bwd_designs.py; NVIDIA H100 80GB HBM3, 700 W): 4 tiles ((2, 32))
// 2.426 vs 2.832, 8 2.440 vs 3.231, 12 2.364 vs 3.127, 16 3.699 vs 3.118,
// 30 6.453 vs 3.118, 36 7.059 vs 3.085.
inline bool gru_cluster_takes(int D, int B, int T, int H,
                              int max_tiles16 = kClMaxTiles16) {
  if (T < 1 || B < 1) return false;
  if (H == 512) return true;
  return H == 256 &&
         static_cast<long long>(D) * ((B + 15) / 16) <= max_tiles16;
}

// Does the forward at (D, B, T, H) take the cluster design? At H = 256
// and 512 up to 4 row tiles of 16 over all directions: the training and
// tagging shape (2, 32, 500, H) and smaller; every other shape runs the
// wgmma rows design of gru_rows.cuh. Rows against cluster ms
// (scripts/perf/gru_designs.py; NVIDIA H100 80GB HBM3, 700 W): H = 512,
// 4 tiles ((2, 32)) 2.210 vs 2.115 at T = 500, 0.288 vs 0.288 at T = 51;
// 8 ((2, 64)) 2.226 vs 3.074; 12 ((6, 32)) 2.164 vs 3.095. H = 256,
// 4 tiles 1.362 vs 1.451 at T = 500, 0.175 vs 0.189 at T = 51, 0.098 vs
// 0.107 at T = 11; 8 ((2, 64)) 1.376 vs 1.382; 16 ((2, 128)) 1.402 vs
// 2.073; 40 ((20, 32)) 1.584 vs 4.149. At H = 256 the rows design is
// the faster one at 4 tiles too, by 6-8%; the training shape keeps the
// cluster design all the same, the one its backwards run.
inline bool gru_fwd_cluster_takes(int D, int B, int T, int H) {
  if (T < 1 || B < 1 || (H != 256 && H != 512)) return false;
  return static_cast<long long>(D) * ((B + 15) / 16) <= kClMaxTiles16Fwd;
}

// What the design queries (pbsed_gru_design, pbsed_gru_bwd_design) report
// of w_hh: the cluster design keeps each block's slice (H x 96 bf16) in
// shared memory and streams none of it.
inline void gru_cluster_slice(int H, int* cluster, int* units, int* resident,
                              int* streamed) {
  *cluster = H / kClUnits;
  *units = kClUnits;
  *resident = 2 * H * kClCols;
  *streamed = 0;
}

// Rows a cluster: 16 while every cluster of the launch is on the card at
// once (`coresident16` of them fit), since a step of 16 rows is shorter
// (2.04 against 3.00 ms forward at (2, 32, 500, 512), 1.38 against 1.96 at
// H = 256, 2.37 against 3.68 backward at H = 256; same card); else 32,
// which halves the clusters that wait their turn.
inline int gru_cluster_row_tiles(int D, int B, int coresident16) {
  return static_cast<long long>(D) * ((B + 15) / 16) <= coresident16 ? 1 : 2;
}

// Set up a launch of `kernel` in clusters of C blocks of `threads` along
// x. Clusters above 8 are beyond the portable size and are asked for by
// name.
template <typename Kernel>
cudaError_t gru_cluster_config(Kernel kernel, int C, size_t smem, dim3 grid,
                               cudaStream_t stream, cudaLaunchConfig_t* cfg,
                               cudaLaunchAttribute* attr,
                               int threads = kClThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of this launch the card holds at once. Fewer than
// launched only serialises them (clusters are independent); none is an
// error: the caller returns it, and no other kernel is tried.
template <typename Kernel>
cudaError_t gru_cluster_coresident(Kernel kernel, int C, size_t smem,
                                   int* clusters, int threads = kClThreads) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = gru_cluster_config(kernel, C, smem, dim3(C), nullptr,
                                       &cfg, &attr, threads);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  return *clusters > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

}  // namespace
