// GatedGCN reverse aggregation: per source node u, over its out-edges
//   sums[u] = [sum_k sigmoid(e_new[k]) * values[dst[k]] || sum_k sigmoid(e_new[k])]
// (f32 [N, 2D]), with e_new and dst in canonical (dst-sorted) order.
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:fused_sigma_unsorted_pallas (one
// call per GatedGCN layer, 16 per forward).
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k: e_new read once
// (1.02 GB), the values table (154 MB), order + dst (8 MB), the sums
// written (307 MB): about 1.49 GB, 0.45 ms at 3.35 TB/s.
//
// Design: one warp per source row of the by_src CSR. The row's edges are
// by_src.order[offsets[u]:offsets[u+1]] (canonical positions, ascending
// within a row because the src sort is stable); the warp reads each e_new
// row and the values row of its dst directly, 16 bytes per lane, and sums
// in f32 registers in that fixed order: deterministic, no atomics. Nothing
// assumes the canonical positions of a row are close together, so graphs
// with cross-locus edges (11.9% of edges on real builder graphs) take the
// same path; the TPU kernel's canon_lo/hi streaming needed a banded graph.
#include "common.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(128) sigma_reverse_sum_kernel(
    const float* __restrict__ e_new, const float* __restrict__ values,
    const int* __restrict__ offsets, const int* __restrict__ order,
    const int* __restrict__ dst, float* __restrict__ sums, int64_t n_nodes,
    int d) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t u = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       u < n_nodes; u += n_warps) {
    const int64_t beg = offsets[u];
    const int64_t end = offsets[u + 1];
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float acc1[VEC] = {};
      float acc2[VEC] = {};
      for (int64_t j = beg; j < end; ++j) {
        const int64_t k = order[j];
        const int64_t vo = (int64_t)dst[k] * d;
        float en[VEC], val[VEC];
        gnnome::load_vec<VEC>(e_new + k * d + c, en);
        gnnome::load_vec<VEC>(values + vo + c, val);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float sg = gnnome::sigmoid(en[q]);
          acc1[q] += sg * val[q];
          acc2[q] += sg;
        }
      }
      gnnome::store_vec<VEC>(sums + u * 2 * d + c, acc1);
      gnnome::store_vec<VEC>(sums + u * 2 * d + d + c, acc2);
    }
  }
}

}  // namespace

GNNOME_API int gnnome_sigma_reverse_sum_f32(
    const float* e_new, const float* values, const int* offsets,
    const int* order, const int* dst, float* sums, int64_t n_nodes, int d,
    int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;  // 4 rows per block
  const unsigned grid = gnnome::grid_for(n_nodes * 32, threads);
  if (vec4) {
    sigma_reverse_sum_kernel<4><<<grid, threads, 0, s>>>(
        e_new, values, offsets, order, dst, sums, n_nodes, d);
  } else {
    sigma_reverse_sum_kernel<1><<<grid, threads, 0, s>>>(
        e_new, values, offsets, order, dst, sums, n_nodes, d);
  }
  return static_cast<int>(cudaGetLastError());
}
