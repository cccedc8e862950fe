// Backward of the GatedGCN reverse aggregation (csrc/reverse_sum.cu). Per
// edge, with gc = g_sums[src] = [g1 || g2] (a zero row for padded edges),
// v = values[dst] and s = sigmoid(e_new[k]) at the canonical position k:
//   d_e_new  = (g1 * v + g2) * s * (1 - s)
//   d_v_rows = g1 * s
// (f32 [E, D] each). Two entry points:
//   rev_bwd: dst read as dst[order[j]], both outputs written at the canonical
//     position k = order[j]; d_values is then the by_dst segment sum of
//     d_v_rows (csrc/segment_sum.cu);
//   opp_bwd: dst read as opp_ids[j], both outputs written at the src-sorted
//     position j, as the TPU kernel returns them; the caller takes them back
//     to canonical order through inv_order (a row gather, csrc/take.cu).
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:rev_bwd_pallas (rev_bwd; one call
// per GatedGCN layer, 16 per training step) and opp_bwd_pallas (opp_bwd, the
// backward of fused_sigma_opposite_pallas).
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k: e_new read
// (1.02 GB), two [E, D] outputs written (2.05 GB), the g_sums (307 MB) and
// values (154 MB) tables, segment_ids, order and dst or opp_ids (12 MB):
// about 3.5 GB, 1.06 ms at 3.35 TB/s. One exp per element.
//
// Design: an edge-balanced walk over the src-sorted positions of by_src
// (gnnome::sigma_bwd_walk, csrc/sigma_rows.cuh): every walker takes every
// W-th tile of 4 positions, holds the g_sums slice of the current source
// row in registers while the row lasts, and reads each edge's e_new row
// through by_src.order and the values row of its dst directly (16 bytes per
// lane, two edges in flight, streaming loads and stores for the [E, D]
// data). The padded tail and a hub row spread over as many walkers as their
// edges need; a padded position (segment_ids PAD_SEGMENT) writes zeros. No
// sums, so no order to keep; nothing assumes a row's edges lie near each
// other, so graphs with cross-locus edges take the same path (the TPU
// kernels needed banded windows for every gather).
#include "sigma_rows.cuh"

namespace {

using gnnome::VAL_BY_EDGE;
using gnnome::VAL_BY_SORTED;

constexpr int THREADS = 256;
constexpr int64_t MIN_SPAN = 32;  // positions a walker takes at least

template <int VEC, int CH>
__global__ void __launch_bounds__(THREADS) rev_bwd_kernel(
    const float* __restrict__ e_new, const float* __restrict__ g_sums,
    const float* __restrict__ values, const int* __restrict__ seg,
    const int* __restrict__ order, const int* __restrict__ dst,
    float* __restrict__ d_e_new, float* __restrict__ d_v_rows, int64_t n_nodes,
    int64_t n_rows, int d, int lanes_log2) {
  gnnome::sigma_bwd_walk<VEC, CH, true, VAL_BY_EDGE, false>(
      e_new, g_sums, values, seg, order, dst, d_e_new, d_v_rows, n_nodes, n_rows, d,
      lanes_log2);
}

template <int VEC, int CH>
__global__ void __launch_bounds__(THREADS) opp_bwd_kernel(
    const float* __restrict__ e_new, const float* __restrict__ g_sums,
    const float* __restrict__ values, const int* __restrict__ seg,
    const int* __restrict__ order, const int* __restrict__ opp_ids,
    float* __restrict__ d_e_sorted, float* __restrict__ d_v_sorted, int64_t n_nodes,
    int64_t n_rows, int d, int lanes_log2) {
  gnnome::sigma_bwd_walk<VEC, CH, true, VAL_BY_SORTED, true>(
      e_new, g_sums, values, seg, order, opp_ids, d_e_sorted, d_v_sorted, n_nodes,
      n_rows, d, lanes_log2);
}

// opposite: opp_bwd (ids in sorted order, outputs in sorted order), else rev_bwd
template <int VEC, int CH>
cudaError_t launch(bool opposite, int device, cudaStream_t s, const float* e_new,
                   const float* g_sums, const float* values, const int* seg,
                   const int* order, const int* ids, float* d_e, float* d_v,
                   int64_t n_nodes, int64_t n_rows, int d, int lanes_log2) {
  const auto kernel = opposite ? opp_bwd_kernel<VEC, CH> : rev_bwd_kernel<VEC, CH>;
  unsigned grid = 0;
  cudaError_t err = gnnome::walk_grid(kernel, THREADS, 0, device, n_rows,
                                      (THREADS / 32) * (32 >> lanes_log2), MIN_SPAN, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, 0, s>>>(e_new, g_sums, values, seg, order, ids, d_e, d_v,
                                  n_nodes, n_rows, d, lanes_log2);
  return cudaGetLastError();
}

int dispatch(bool opposite, const float* e_new, const float* g_sums,
             const float* values, const int* seg, const int* order, const int* ids,
             float* d_e, float* d_v, int64_t n_nodes, int64_t n_rows, int d, int vec4,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 0 || n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int lanes_log2 = 5, chunks = 1;
  gnnome::lane_layout(vec4 ? d / 4 : d, &lanes_log2, &chunks);
  const auto run = [&](auto vec) {
    return gnnome::with_chunks(chunks, [&](auto ch) {
      return launch<decltype(vec)::value, decltype(ch)::value>(
          opposite, device, s, e_new, g_sums, values, seg, order, ids, d_e, d_v, n_nodes,
          n_rows, d, lanes_log2);
    });
  };
  return static_cast<int>(vec4 ? run(gnnome::Int<4>{}) : run(gnnome::Int<1>{}));
}

}  // namespace

// seg: by_src.segment_ids (the source id at each sorted position,
// PAD_SEGMENT on padded edges)
GNNOME_API int gnnome_rev_bwd_f32(const float* e_new, const float* g_sums,
                                  const float* values, const int* seg,
                                  const int* order, const int* dst, float* d_e_new,
                                  float* d_v_rows, int64_t n_nodes, int64_t n_rows,
                                  int d, int vec4, int device, void* stream) {
  return dispatch(false, e_new, g_sums, values, seg, order, dst, d_e_new, d_v_rows,
                  n_nodes, n_rows, d, vec4, device, stream);
}

GNNOME_API int gnnome_opp_bwd_f32(const float* e_new, const float* g_sums,
                                  const float* values, const int* seg,
                                  const int* order, const int* opp_ids,
                                  float* d_e_sorted, float* d_v_sorted, int64_t n_nodes,
                                  int64_t n_rows, int d, int vec4, int device,
                                  void* stream) {
  return dispatch(true, e_new, g_sums, values, seg, order, opp_ids, d_e_sorted,
                  d_v_sorted, n_nodes, n_rows, d, vec4, device, stream);
}
