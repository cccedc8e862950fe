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
// about 3.5 GB, 1.06 ms at 3.35 TB/s (bf16 e_new, values and outputs: about
// 1.93 GB, 0.58 ms). One exp per element.
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

// T: the stored type of e_new, values and both outputs (float, or bf16 for
// the bf16 entry); g_sums is f32
template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) rev_bwd_kernel(
    const T* __restrict__ e_new, const float* __restrict__ g_sums,
    const T* __restrict__ values, const int* __restrict__ seg,
    const int* __restrict__ order, const int* __restrict__ dst,
    T* __restrict__ d_e_new, T* __restrict__ d_v_rows, int64_t n_nodes,
    int64_t n_rows, int d, int lanes_log2) {
  gnnome::sigma_bwd_walk<T, VEC, CH, true, VAL_BY_EDGE, false>(
      e_new, g_sums, values, seg, order, dst, d_e_new, d_v_rows, n_nodes, n_rows, d,
      lanes_log2);
}

template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) opp_bwd_kernel(
    const T* __restrict__ e_new, const float* __restrict__ g_sums,
    const T* __restrict__ values, const int* __restrict__ seg,
    const int* __restrict__ order, const int* __restrict__ opp_ids,
    T* __restrict__ d_e_sorted, T* __restrict__ d_v_sorted, int64_t n_nodes,
    int64_t n_rows, int d, int lanes_log2) {
  gnnome::sigma_bwd_walk<T, VEC, CH, true, VAL_BY_SORTED, true>(
      e_new, g_sums, values, seg, order, opp_ids, d_e_sorted, d_v_sorted, n_nodes,
      n_rows, d, lanes_log2);
}

// opposite: opp_bwd (ids in sorted order, outputs in sorted order), else rev_bwd
template <typename T, int VEC, int CH>
cudaError_t launch(bool opposite, int device, cudaStream_t s, const T* e_new,
                   const float* g_sums, const T* values, const int* seg,
                   const int* order, const int* ids, T* d_e, T* d_v,
                   int64_t n_nodes, int64_t n_rows, int d, int lanes_log2) {
  const auto kernel = opposite ? opp_bwd_kernel<T, VEC, CH> : rev_bwd_kernel<T, VEC, CH>;
  unsigned grid = 0;
  cudaError_t err = gnnome::walk_grid(kernel, THREADS, 0, device, n_rows,
                                      (THREADS / 32) * (32 >> lanes_log2), MIN_SPAN, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, 0, s>>>(e_new, g_sums, values, seg, order, ids, d_e, d_v,
                                  n_nodes, n_rows, d, lanes_log2);
  return cudaGetLastError();
}

template <typename T>
int dispatch(bool opposite, const T* e_new, const float* g_sums,
             const T* values, const int* seg, const int* order, const int* ids,
             T* d_e, T* d_v, int64_t n_nodes, int64_t n_rows, int d, int vec,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 0 || n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = gnnome::VEC16<T>;
  int lanes_log2 = 5, chunks = 1;
  gnnome::lane_layout(vec ? d / V : d, &lanes_log2, &chunks);
  const auto run = [&](auto v) {
    return gnnome::with_chunks(chunks, [&](auto ch) {
      return launch<T, decltype(v)::value, decltype(ch)::value>(
          opposite, device, s, e_new, g_sums, values, seg, order, ids, d_e, d_v, n_nodes,
          n_rows, d, lanes_log2);
    });
  };
  return static_cast<int>(vec ? run(gnnome::Int<V>{}) : run(gnnome::Int<1>{}));
}

}  // namespace

// seg: by_src.segment_ids (the source id at each sorted position,
// PAD_SEGMENT on padded edges); vec: 16-byte accesses (rows of a multiple
// of 16 bytes, aligned bases)
GNNOME_API int gnnome_rev_bwd_f32(const float* e_new, const float* g_sums,
                                  const float* values, const int* seg,
                                  const int* order, const int* dst, float* d_e_new,
                                  float* d_v_rows, int64_t n_nodes, int64_t n_rows,
                                  int d, int vec, int device, void* stream) {
  return dispatch(false, e_new, g_sums, values, seg, order, dst, d_e_new, d_v_rows,
                  n_nodes, n_rows, d, vec, device, stream);
}

// e_new, values and both outputs bf16; g_sums f32
GNNOME_API int gnnome_rev_bwd_bf16(const gnnome::bf16* e_new, const float* g_sums,
                                   const gnnome::bf16* values, const int* seg,
                                   const int* order, const int* dst,
                                   gnnome::bf16* d_e_new, gnnome::bf16* d_v_rows,
                                   int64_t n_nodes, int64_t n_rows, int d, int vec,
                                   int device, void* stream) {
  return dispatch(false, e_new, g_sums, values, seg, order, dst, d_e_new, d_v_rows,
                  n_nodes, n_rows, d, vec, device, stream);
}

GNNOME_API int gnnome_opp_bwd_f32(const float* e_new, const float* g_sums,
                                  const float* values, const int* seg,
                                  const int* order, const int* opp_ids,
                                  float* d_e_sorted, float* d_v_sorted, int64_t n_nodes,
                                  int64_t n_rows, int d, int vec, int device,
                                  void* stream) {
  return dispatch(true, e_new, g_sums, values, seg, order, opp_ids, d_e_sorted,
                  d_v_sorted, n_nodes, n_rows, d, vec, device, stream);
}
