// GatedGCN σ-weighted aggregation over a CSR, and its backward: per key row
//   sums[v] = [sum sigmoid(e[k]) * val(k) || sum sigmoid(e[k])]   (f32 [N, 2D])
// over the edges k keyed on v, with e in canonical (dst-sorted) order and
// val(k) one of (csrc/sigma_rows.cuh):
//   gather:      values[ids[k]], a node table read through an endpoint id
//                array (by_dst with ids = src: the LayerNorm layer's h_fwd);
//   pregathered: values[k], an [E, D] table already gathered per edge (the
//                wide-gather path's a2h[src] / a3h[dst] halves).
// The by_dst walk reads its rows contiguously; the by_src walk (pregathered
// only) goes through by_src.order. The backward, given g_sums = [g1 || g2]
// ([N, 2D]), writes per canonical edge
//   d_e = (g1 * val + g2) * s * (1 - s),   d_v = g1 * s,   s = sigmoid(e[k]),
// zero on padded edges: the JAX package's gather-only _fused_bwd. For the
// gather form d_values is then the segment sum of d_v over the CSR keyed on
// ids (csrc/segment_sum.cu); for the pregathered forms d_v is the gradient.
// (By_src with a node table is csrc/reverse_sum.cu and csrc/rev_bwd.cu.)
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:fused_sigma_aggregate_pallas
// (reached through gnnome_tpu/ops/segment.py:_fused_sigma_aggregate, from
// gated_aggregate and gated_aggregate_pregathered); its backward is the
// XLA/take_rows VJP _fused_bwd (no Pallas kernel of its own).
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k, forward: e read
// (1.02 GB), the sums written (307 MB), offsets (0.6 MB), and either the
// values table (154 MB) with ids (4 MB), about 1.49 GB, 0.44 ms, or the
// pregathered rows (1.02 GB), about 2.36 GB, 0.70 ms (by_src adds 4 MB of
// order). Backward: e read, two [E, D] outputs written (2.05 GB), g_sums
// (307 MB) and the values table or pregathered rows: about 3.54 GB, 1.06 ms
// (gather) or 4.40 GB, 1.31 ms (pregathered), at 3.35 TB/s. One exp per
// element: far below the f32 line.
//
// Design: the forward gives one warp per key row, 16 bytes per lane, f32
// register sums in CSR order (csrc/sigma_rows.cuh): deterministic, no
// atomics, so remat's recompute reproduces the forward bit for bit. The
// backward is the edge-balanced walk of gnnome::sigma_bwd_walk over the
// sorted positions (no sums): the padded tail and a hub row spread over as
// many walkers as their edges need. The TPU kernel's one-hot
// matmul blocks over key-sorted inputs exist for the MXU; here the by_dst
// walk reads canonical rows directly and the by_src walk reads them through
// order, so no permuted [E, D] copy is made.
#include "sigma_rows.cuh"

namespace {

using gnnome::VAL_AT_EDGE;
using gnnome::VAL_BY_EDGE;

constexpr int BWD_THREADS = 256;
constexpr int64_t MIN_SPAN = 32;  // positions a backward walker takes at least

#define SIGMA_AGGREGATE_KERNEL(NAME, ORDERED, VAL)                                    \
  template <int VEC>                                                                  \
  __global__ void __launch_bounds__(128) NAME(                                        \
      const float* __restrict__ e, const float* __restrict__ values,                  \
      const int* __restrict__ offsets, const int* __restrict__ order,                 \
      const int* __restrict__ ids, float* __restrict__ sums, int64_t n_nodes, int d) { \
    gnnome::sigma_sum_rows<float, VEC, ORDERED, VAL>(e, values, offsets, order, ids,    \
                                                     sums, n_nodes, d);               \
  }

#define SIGMA_AGGREGATE_BWD_KERNEL(NAME, ORDERED, VAL)                                 \
  template <int VEC, int CH>                                                           \
  __global__ void __launch_bounds__(BWD_THREADS) NAME(                                 \
      const float* __restrict__ e, const float* __restrict__ g_sums,                   \
      const float* __restrict__ values, const int* __restrict__ seg,                   \
      const int* __restrict__ order, const int* __restrict__ ids,                      \
      float* __restrict__ d_e, float* __restrict__ d_v, int64_t n_nodes,               \
      int64_t n_rows, int d, int lanes_log2) {                                         \
    gnnome::sigma_bwd_walk<float, VEC, CH, ORDERED, VAL, false>(                       \
        e, g_sums, values, seg, order, ids, d_e, d_v, n_nodes, n_rows, d, lanes_log2); \
  }

// one device kernel name per form, so a profile tells them apart
SIGMA_AGGREGATE_KERNEL(sigma_aggregate_gather_kernel, false, VAL_BY_EDGE)
SIGMA_AGGREGATE_KERNEL(sigma_aggregate_kernel, false, VAL_AT_EDGE)
SIGMA_AGGREGATE_KERNEL(sigma_aggregate_by_src_kernel, true, VAL_AT_EDGE)
SIGMA_AGGREGATE_BWD_KERNEL(sigma_aggregate_bwd_gather_kernel, false, VAL_BY_EDGE)
SIGMA_AGGREGATE_BWD_KERNEL(sigma_aggregate_bwd_kernel, false, VAL_AT_EDGE)
SIGMA_AGGREGATE_BWD_KERNEL(sigma_aggregate_bwd_by_src_kernel, true, VAL_AT_EDGE)

// The form from the pointers: order null = by_dst, ids null = pregathered.
// By_src with ids is the reverse aggregation's own entry (csrc/reverse_sum.cu).
template <int VEC>
cudaError_t forward(unsigned grid, cudaStream_t s, const float* e, const float* values,
                    const int* offsets, const int* order, const int* ids, float* sums,
                    int64_t n_nodes, int d) {
  const int threads = 128;  // 4 rows per block
  if (order == nullptr && ids != nullptr) {
    sigma_aggregate_gather_kernel<VEC><<<grid, threads, 0, s>>>(
        e, values, offsets, order, ids, sums, n_nodes, d);
  } else if (order == nullptr) {
    sigma_aggregate_kernel<VEC><<<grid, threads, 0, s>>>(e, values, offsets, order, ids,
                                                         sums, n_nodes, d);
  } else if (ids == nullptr) {
    sigma_aggregate_by_src_kernel<VEC><<<grid, threads, 0, s>>>(
        e, values, offsets, order, ids, sums, n_nodes, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int VEC, int CH>
cudaError_t backward(int device, cudaStream_t s, const float* e, const float* g_sums,
                     const float* values, const int* seg, const int* order,
                     const int* ids, float* d_e, float* d_v, int64_t n_nodes,
                     int64_t n_rows, int d, int lanes_log2) {
  void (*kernel)(const float*, const float*, const float*, const int*, const int*,
                 const int*, float*, float*, int64_t, int64_t, int, int);
  if (order == nullptr && ids != nullptr) {
    kernel = sigma_aggregate_bwd_gather_kernel<VEC, CH>;
  } else if (order == nullptr) {
    kernel = sigma_aggregate_bwd_kernel<VEC, CH>;
  } else if (ids == nullptr) {
    kernel = sigma_aggregate_bwd_by_src_kernel<VEC, CH>;
  } else {
    return cudaErrorInvalidValue;
  }
  unsigned grid = 0;
  cudaError_t err = gnnome::walk_grid(kernel, BWD_THREADS, 0, device, n_rows,
                                      (BWD_THREADS / 32) * (32 >> lanes_log2), MIN_SPAN,
                                      &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BWD_THREADS, 0, s>>>(e, g_sums, values, seg, order, ids, d_e, d_v,
                                      n_nodes, n_rows, d, lanes_log2);
  return cudaGetLastError();
}

}  // namespace

GNNOME_API int gnnome_sigma_aggregate_f32(const float* e, const float* values,
                                          const int* offsets, const int* order,
                                          const int* ids, float* sums, int64_t n_nodes,
                                          int d, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = gnnome::grid_for(n_nodes * 32, 128);
  err = vec4 ? forward<4>(grid, s, e, values, offsets, order, ids, sums, n_nodes, d)
             : forward<1>(grid, s, e, values, offsets, order, ids, sums, n_nodes, d);
  return static_cast<int>(err);
}

// seg: the walk's CSR segment_ids (the key at each sorted position,
// PAD_SEGMENT on padded edges)
GNNOME_API int gnnome_sigma_aggregate_bwd_f32(
    const float* e, const float* g_sums, const float* values, const int* seg,
    const int* order, const int* ids, float* d_e, float* d_v, int64_t n_nodes,
    int64_t n_rows, int d, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 0 || n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int lanes_log2 = 5, chunks = 1;
  gnnome::lane_layout(vec4 ? d / 4 : d, &lanes_log2, &chunks);
  const auto run = [&](auto vec) {
    return gnnome::with_chunks(chunks, [&](auto ch) {
      return backward<decltype(vec)::value, decltype(ch)::value>(
          device, s, e, g_sums, values, seg, order, ids, d_e, d_v, n_nodes, n_rows, d,
          lanes_log2);
    });
  };
  return static_cast<int>(vec4 ? run(gnnome::Int<4>{}) : run(gnnome::Int<1>{}));
}
