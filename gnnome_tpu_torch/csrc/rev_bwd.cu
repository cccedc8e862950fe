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
// values (154 MB) tables, order and dst or opp_ids (8 MB): about 3.5 GB,
// 1.06 ms at 3.35 TB/s. One exp per element.
//
// Design: one warp per source row of the by_src CSR, as the forward kernel
// walks it (csrc/sigma_rows.cuh): the row's g_sums slice is loaded once into
// registers, and the warp visits the row's edges through by_src.order,
// reading each e_new row and the values row of its dst directly (16 bytes
// per lane). No sums, so no order to keep; nothing assumes a row's edges lie
// near each other, so graphs with cross-locus edges take the same path (the
// TPU kernels needed banded windows for every gather). Padded edges
// (order[offsets[N]:]) form one extra row whose outputs are zero.
#include "sigma_rows.cuh"

namespace {

using gnnome::VAL_BY_EDGE;
using gnnome::VAL_BY_SORTED;

template <int VEC>
__global__ void __launch_bounds__(128) rev_bwd_kernel(
    const float* __restrict__ e_new, const float* __restrict__ g_sums,
    const float* __restrict__ values, const int* __restrict__ offsets,
    const int* __restrict__ order, const int* __restrict__ dst,
    float* __restrict__ d_e_new, float* __restrict__ d_v_rows, int64_t n_nodes,
    int64_t n_rows, int d) {
  gnnome::sigma_bwd_rows<VEC, true, VAL_BY_EDGE, false>(
      e_new, g_sums, values, offsets, order, dst, d_e_new, d_v_rows, n_nodes, n_rows, d);
}

template <int VEC>
__global__ void __launch_bounds__(128) opp_bwd_kernel(
    const float* __restrict__ e_new, const float* __restrict__ g_sums,
    const float* __restrict__ values, const int* __restrict__ offsets,
    const int* __restrict__ order, const int* __restrict__ opp_ids,
    float* __restrict__ d_e_sorted, float* __restrict__ d_v_sorted, int64_t n_nodes,
    int64_t n_rows, int d) {
  gnnome::sigma_bwd_rows<VEC, true, VAL_BY_SORTED, true>(
      e_new, g_sums, values, offsets, order, opp_ids, d_e_sorted, d_v_sorted, n_nodes,
      n_rows, d);
}

// opposite: opp_bwd (ids in sorted order, outputs in sorted order), else rev_bwd
template <int VEC>
void launch(bool opposite, unsigned grid, cudaStream_t s, const float* e_new,
            const float* g_sums, const float* values, const int* offsets,
            const int* order, const int* ids, float* d_e, float* d_v, int64_t n_nodes,
            int64_t n_rows, int d) {
  const int threads = 128;  // 4 rows per block
  if (opposite) {
    opp_bwd_kernel<VEC><<<grid, threads, 0, s>>>(e_new, g_sums, values, offsets, order,
                                                 ids, d_e, d_v, n_nodes, n_rows, d);
  } else {
    rev_bwd_kernel<VEC><<<grid, threads, 0, s>>>(e_new, g_sums, values, offsets, order,
                                                 ids, d_e, d_v, n_nodes, n_rows, d);
  }
}

int dispatch(bool opposite, const float* e_new, const float* g_sums,
             const float* values, const int* offsets, const int* order,
             const int* ids, float* d_e, float* d_v, int64_t n_nodes, int64_t n_rows,
             int d, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 0 || n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = gnnome::grid_for((n_nodes + 1) * 32, 128);
  if (vec4) {
    launch<4>(opposite, grid, s, e_new, g_sums, values, offsets, order, ids, d_e, d_v,
              n_nodes, n_rows, d);
  } else {
    launch<1>(opposite, grid, s, e_new, g_sums, values, offsets, order, ids, d_e, d_v,
              n_nodes, n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

GNNOME_API int gnnome_rev_bwd_f32(const float* e_new, const float* g_sums,
                                  const float* values, const int* offsets,
                                  const int* order, const int* dst, float* d_e_new,
                                  float* d_v_rows, int64_t n_nodes, int64_t n_rows,
                                  int d, int vec4, int device, void* stream) {
  return dispatch(false, e_new, g_sums, values, offsets, order, dst, d_e_new, d_v_rows,
                  n_nodes, n_rows, d, vec4, device, stream);
}

GNNOME_API int gnnome_opp_bwd_f32(const float* e_new, const float* g_sums,
                                  const float* values, const int* offsets,
                                  const int* order, const int* opp_ids,
                                  float* d_e_sorted, float* d_v_sorted, int64_t n_nodes,
                                  int64_t n_rows, int d, int vec4, int device,
                                  void* stream) {
  return dispatch(true, e_new, g_sums, values, offsets, order, opp_ids, d_e_sorted,
                  d_v_sorted, n_nodes, n_rows, d, vec4, device, stream);
}
