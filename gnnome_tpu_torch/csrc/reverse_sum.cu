// GatedGCN reverse aggregation: per source node u, over its out-edges
//   sums[u] = [sum_k sigmoid(e_new[k]) * values[dst[k]] || sum_k sigmoid(e_new[k])]
// (f32 [N, 2D]), with e_new and dst in canonical (dst-sorted) order. Two
// entry points:
//   sigma_reverse_sum: the dst id of an edge read at its canonical position,
//     dst[order[j]];
//   sigma_opposite:    the dst id read contiguously in src-sorted order,
//     opp_ids[j] = dst[order[j]] (built with the graph).
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:fused_sigma_unsorted_pallas
// (sigma_reverse_sum; one call per GatedGCN layer, 16 per forward) and
// fused_sigma_opposite_pallas (sigma_opposite; the JAX package's reverse
// aggregation when TPU band plans exist but the canonical one does not fit).
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k: e_new read once
// (1.02 GB), the values table (154 MB), order + dst or opp_ids (8 MB), the
// sums written (307 MB): about 1.49 GB, 0.45 ms at 3.35 TB/s (either entry;
// the bf16 entry reads e_new and values in half the bytes: 0.90 GB, 0.27 ms).
//
// Design: one warp per source row of the by_src CSR (csrc/sigma_rows.cuh).
// The row's edges are by_src.order[offsets[u]:offsets[u+1]] (canonical
// positions, ascending within a row because the src sort is stable); the
// warp reads each e_new row and the values row of its dst directly, 16 bytes
// per lane, and sums in f32 registers in that fixed order: deterministic, no
// atomics. Nothing assumes the canonical positions of a row are close
// together, so graphs with cross-locus edges (11.9% of edges on real builder
// graphs) take the same path; the TPU kernels' canon_lo/hi streaming and
// banded windows needed a banded graph.
#include "sigma_rows.cuh"

namespace {

using gnnome::VAL_BY_EDGE;
using gnnome::VAL_BY_SORTED;

// T: the stored type of e_new and values (float, or bf16 for the bf16
// entry); the sums are f32. The bf16 entry rounds each summand, σ·v and σ,
// to bf16 before its f32 sum, as fused_sigma_unsorted_pallas feeds them to
// its MXU sum in the data dtype (spmm_pallas.py:2358-2360); the f32
// instance is the unrounded one (ROUND = false), as it was.
template <typename T, int VEC>
__global__ void __launch_bounds__(128) sigma_reverse_sum_kernel(
    const T* __restrict__ e_new, const T* __restrict__ values,
    const int* __restrict__ offsets, const int* __restrict__ order,
    const int* __restrict__ dst, float* __restrict__ sums, int64_t n_nodes,
    int d) {
  gnnome::sigma_sum_rows<T, VEC, true, VAL_BY_EDGE, /*ROUND=*/gnnome::is_bf16<T>>(
      e_new, values, offsets, order, dst, sums, n_nodes, d);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(128) sigma_opposite_kernel(
    const T* __restrict__ e_new, const T* __restrict__ values,
    const int* __restrict__ offsets, const int* __restrict__ order,
    const int* __restrict__ opp_ids, float* __restrict__ sums, int64_t n_nodes,
    int d) {
  gnnome::sigma_sum_rows<T, VEC, true, VAL_BY_SORTED>(e_new, values, offsets, order,
                                                      opp_ids, sums, n_nodes, d);
}

// opposite: read the value row at ids[j] (sorted order), else at ids[order[j]]
template <typename T, int VEC>
void launch(bool opposite, unsigned grid, cudaStream_t s, const T* e_new,
            const T* values, const int* offsets, const int* order,
            const int* ids, float* sums, int64_t n_nodes, int d) {
  const int threads = 128;  // 4 rows per block
  if (opposite) {
    sigma_opposite_kernel<T, VEC><<<grid, threads, 0, s>>>(e_new, values, offsets, order,
                                                           ids, sums, n_nodes, d);
  } else {
    sigma_reverse_sum_kernel<T, VEC><<<grid, threads, 0, s>>>(e_new, values, offsets,
                                                              order, ids, sums, n_nodes, d);
  }
}

template <typename T>
int dispatch(bool opposite, const T* e_new, const T* values,
             const int* offsets, const int* order, const int* ids, float* sums,
             int64_t n_nodes, int d, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = gnnome::grid_for(n_nodes * 32, 128);
  if (vec) {
    launch<T, gnnome::VEC16<T>>(opposite, grid, s, e_new, values, offsets, order, ids,
                                sums, n_nodes, d);
  } else {
    launch<T, 1>(opposite, grid, s, e_new, values, offsets, order, ids, sums, n_nodes, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 16-byte accesses (rows of a multiple of 16 bytes, aligned bases)
GNNOME_API int gnnome_sigma_reverse_sum_f32(
    const float* e_new, const float* values, const int* offsets,
    const int* order, const int* dst, float* sums, int64_t n_nodes, int d,
    int vec, int device, void* stream) {
  return dispatch(false, e_new, values, offsets, order, dst, sums, n_nodes, d, vec,
                  device, stream);
}

// e_new and values bf16, sums f32
GNNOME_API int gnnome_sigma_reverse_sum_bf16(
    const gnnome::bf16* e_new, const gnnome::bf16* values, const int* offsets,
    const int* order, const int* dst, float* sums, int64_t n_nodes, int d,
    int vec, int device, void* stream) {
  return dispatch(false, e_new, values, offsets, order, dst, sums, n_nodes, d, vec,
                  device, stream);
}

GNNOME_API int gnnome_sigma_opposite_f32(
    const float* e_new, const float* values, const int* offsets,
    const int* order, const int* opp_ids, float* sums, int64_t n_nodes, int d,
    int vec, int device, void* stream) {
  return dispatch(true, e_new, values, offsets, order, opp_ids, sums, n_nodes, d,
                  vec, device, stream);
}
