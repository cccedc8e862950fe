// Backward of the GatedGCN reverse aggregation (csrc/reverse_sum.cu). Per
// canonical edge k, with gc = g_sums[src[k]] = [g1 || g2] (a zero row for
// padded edges), v = values[dst[k]] and s = sigmoid(e_new[k]):
//   d_e_new[k]  = (g1 * v + g2) * s * (1 - s)
//   d_v_rows[k] = g1 * s
// (f32 [E, D] each, in canonical order). d_values is then the by_dst
// segment sum of d_v_rows (csrc/segment_sum.cu).
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:rev_bwd_pallas (one call per
// GatedGCN layer, 16 per training step).
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k: e_new read
// (1.02 GB), two [E, D] outputs written (2.05 GB), the g_sums (307 MB) and
// values (154 MB) tables, order and dst (8 MB): about 3.5 GB, 1.05 ms at
// 3.35 TB/s. One exp per element.
//
// Design: one warp per source row of the by_src CSR, as the forward kernel
// walks it: the row's g_sums slice is loaded once into registers, and the
// warp visits the row's canonical edges through by_src.order, reading each
// e_new row and the values row of its dst directly (16 bytes per lane) and
// writing both outputs at the canonical position. No sums, so no order to
// keep; nothing assumes a row's edges lie near each other, so graphs with
// cross-locus edges take the same path (the TPU kernel needed banded
// windows for both gathers). Padded edges (order[offsets[N]:]) form one
// extra row whose outputs are zero.
#include "common.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(128) rev_bwd_kernel(
    const float* __restrict__ e_new, const float* __restrict__ g_sums,
    const float* __restrict__ values, const int* __restrict__ offsets,
    const int* __restrict__ order, const int* __restrict__ dst,
    float* __restrict__ d_e_new, float* __restrict__ d_v_rows, int64_t n_nodes,
    int64_t n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t u = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       u <= n_nodes; u += n_warps) {
    const bool tail = u == n_nodes;
    const int64_t beg = offsets[u];
    const int64_t end = tail ? n_rows : offsets[u + 1];
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      if (tail) {
        const float zero[VEC] = {};
        for (int64_t j = beg; j < end; ++j) {
          const int64_t k = order[j];
          gnnome::store_vec<VEC>(d_e_new + k * d + c, zero);
          gnnome::store_vec<VEC>(d_v_rows + k * d + c, zero);
        }
        continue;
      }
      float g1[VEC], g2[VEC];
      gnnome::load_vec<VEC>(g_sums + u * 2 * d + c, g1);
      gnnome::load_vec<VEC>(g_sums + u * 2 * d + d + c, g2);
      for (int64_t j = beg; j < end; ++j) {
        const int64_t k = order[j];
        const int64_t vo = (int64_t)dst[k] * d;
        float en[VEC], val[VEC], o_e[VEC], o_v[VEC];
        gnnome::load_vec<VEC>(e_new + k * d + c, en);
        gnnome::load_vec<VEC>(values + vo + c, val);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float s = gnnome::sigmoid(en[q]);
          o_e[q] = (g1[q] * val[q] + g2[q]) * (s * (1.0f - s));
          o_v[q] = g1[q] * s;
        }
        gnnome::store_vec<VEC>(d_e_new + k * d + c, o_e);
        gnnome::store_vec<VEC>(d_v_rows + k * d + c, o_v);
      }
    }
  }
}

}  // namespace

GNNOME_API int gnnome_rev_bwd_f32(const float* e_new, const float* g_sums,
                                  const float* values, const int* offsets,
                                  const int* order, const int* dst, float* d_e_new,
                                  float* d_v_rows, int64_t n_nodes, int64_t n_rows,
                                  int d, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 0 || n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;  // 4 rows per block
  const unsigned grid = gnnome::grid_for((n_nodes + 1) * 32, threads);
  if (vec4) {
    rev_bwd_kernel<4><<<grid, threads, 0, s>>>(e_new, g_sums, values, offsets, order,
                                               dst, d_e_new, d_v_rows, n_nodes,
                                               n_rows, d);
  } else {
    rev_bwd_kernel<1><<<grid, threads, 0, s>>>(e_new, g_sums, values, offsets, order,
                                               dst, d_e_new, d_v_rows, n_nodes,
                                               n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}
