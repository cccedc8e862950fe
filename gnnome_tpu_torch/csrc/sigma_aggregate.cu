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
// The bf16 entries (compute_dtype="bfloat16"): e and the values (and d_e,
// d_v) bf16, the sums and g_sums f32. They round where the TPU kernel
// rounds (_fused_sigma_kernel): sigmoid in f32 of the bf16 e, each summand
// sigmoid * v and sigmoid rounded to bf16, summed in f32; the backward, as
// the JAX _fused_bwd, rounds the g_sums rows to bf16 as it loads them,
// computes in f32 and rounds d_e and d_v as it stores them. Bytes at
// E = 1M, D = 256: the forward's [E, D] and [N, D] data in half (about
// 0.90 GB gathered, 1.33 GB pregathered), the backward's about 1.93 GB
// gathered, 2.36 GB pregathered.
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

// T: the stored type of e, the values, d_e and d_v (float, or bf16 for the
// bf16 entries, whose forward rounds its summands to bf16)
#define SIGMA_AGGREGATE_KERNEL(NAME, ORDERED, VAL)                                    \
  template <typename T, int VEC>                                                      \
  __global__ void __launch_bounds__(128) NAME(                                        \
      const T* __restrict__ e, const T* __restrict__ values,                          \
      const int* __restrict__ offsets, const int* __restrict__ order,                 \
      const int* __restrict__ ids, float* __restrict__ sums, int64_t n_nodes, int d) { \
    gnnome::sigma_sum_rows<T, VEC, ORDERED, VAL, gnnome::is_bf16<T>>(                 \
        e, values, offsets, order, ids, sums, n_nodes, d);                            \
  }

#define SIGMA_AGGREGATE_BWD_KERNEL(NAME, ORDERED, VAL)                                 \
  template <typename T, int VEC, int CH>                                               \
  __global__ void __launch_bounds__(BWD_THREADS) NAME(                                 \
      const T* __restrict__ e, const float* __restrict__ g_sums,                       \
      const T* __restrict__ values, const int* __restrict__ seg,                       \
      const int* __restrict__ order, const int* __restrict__ ids,                      \
      T* __restrict__ d_e, T* __restrict__ d_v, int64_t n_nodes,                       \
      int64_t n_rows, int d, int lanes_log2) {                                         \
    gnnome::sigma_bwd_walk<T, VEC, CH, ORDERED, VAL, false>(                           \
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
template <typename T, int VEC>
cudaError_t forward(unsigned grid, cudaStream_t s, const T* e, const T* values,
                    const int* offsets, const int* order, const int* ids, float* sums,
                    int64_t n_nodes, int d) {
  const int threads = 128;  // 4 rows per block
  if (order == nullptr && ids != nullptr) {
    sigma_aggregate_gather_kernel<T, VEC><<<grid, threads, 0, s>>>(
        e, values, offsets, order, ids, sums, n_nodes, d);
  } else if (order == nullptr) {
    sigma_aggregate_kernel<T, VEC><<<grid, threads, 0, s>>>(e, values, offsets, order, ids,
                                                            sums, n_nodes, d);
  } else if (ids == nullptr) {
    sigma_aggregate_by_src_kernel<T, VEC><<<grid, threads, 0, s>>>(
        e, values, offsets, order, ids, sums, n_nodes, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int VEC, int CH>
cudaError_t backward(int device, cudaStream_t s, const T* e, const float* g_sums,
                     const T* values, const int* seg, const int* order, const int* ids,
                     T* d_e, T* d_v, int64_t n_nodes, int64_t n_rows, int d,
                     int lanes_log2) {
  void (*kernel)(const T*, const float*, const T*, const int*, const int*, const int*, T*,
                 T*, int64_t, int64_t, int, int);
  if (order == nullptr && ids != nullptr) {
    kernel = sigma_aggregate_bwd_gather_kernel<T, VEC, CH>;
  } else if (order == nullptr) {
    kernel = sigma_aggregate_bwd_kernel<T, VEC, CH>;
  } else if (ids == nullptr) {
    kernel = sigma_aggregate_bwd_by_src_kernel<T, VEC, CH>;
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

// vec: 16-byte accesses (4 f32 or 8 bf16; rows of a multiple of 16 bytes,
// aligned bases)
template <typename T>
int run_forward(const T* e, const T* values, const int* offsets, const int* order,
                const int* ids, float* sums, int64_t n_nodes, int d, int vec, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = gnnome::grid_for(n_nodes * 32, 128);
  err = vec ? forward<T, gnnome::VEC16<T>>(grid, s, e, values, offsets, order, ids, sums,
                                           n_nodes, d)
            : forward<T, 1>(grid, s, e, values, offsets, order, ids, sums, n_nodes, d);
  return static_cast<int>(err);
}

template <typename T>
int run_backward(const T* e, const float* g_sums, const T* values, const int* seg,
                 const int* order, const int* ids, T* d_e, T* d_v, int64_t n_nodes,
                 int64_t n_rows, int d, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 0 || n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = gnnome::VEC16<T>;
  int lanes_log2 = 5, chunks = 1;
  gnnome::lane_layout(vec ? d / V : d, &lanes_log2, &chunks);
  const auto run = [&](auto v) {
    return gnnome::with_chunks(chunks, [&](auto ch) {
      return backward<T, decltype(v)::value, decltype(ch)::value>(
          device, s, e, g_sums, values, seg, order, ids, d_e, d_v, n_nodes, n_rows, d,
          lanes_log2);
    });
  };
  return static_cast<int>(vec ? run(gnnome::Int<V>{}) : run(gnnome::Int<1>{}));
}

}  // namespace

GNNOME_API int gnnome_sigma_aggregate_f32(const float* e, const float* values,
                                          const int* offsets, const int* order,
                                          const int* ids, float* sums, int64_t n_nodes,
                                          int d, int vec4, int device, void* stream) {
  return run_forward(e, values, offsets, order, ids, sums, n_nodes, d, vec4, device,
                     stream);
}

// e and values bf16, sums f32
GNNOME_API int gnnome_sigma_aggregate_bf16(const gnnome::bf16* e, const gnnome::bf16* values,
                                           const int* offsets, const int* order,
                                           const int* ids, float* sums, int64_t n_nodes,
                                           int d, int vec, int device, void* stream) {
  return run_forward(e, values, offsets, order, ids, sums, n_nodes, d, vec, device, stream);
}

// seg: the walk's CSR segment_ids (the key at each sorted position,
// PAD_SEGMENT on padded edges)
GNNOME_API int gnnome_sigma_aggregate_bwd_f32(
    const float* e, const float* g_sums, const float* values, const int* seg,
    const int* order, const int* ids, float* d_e, float* d_v, int64_t n_nodes,
    int64_t n_rows, int d, int vec4, int device, void* stream) {
  return run_backward(e, g_sums, values, seg, order, ids, d_e, d_v, n_nodes, n_rows, d, vec4,
                      device, stream);
}

// e, values, d_e and d_v bf16; g_sums f32
GNNOME_API int gnnome_sigma_aggregate_bwd_bf16(
    const gnnome::bf16* e, const float* g_sums, const gnnome::bf16* values, const int* seg,
    const int* order, const int* ids, gnnome::bf16* d_e, gnnome::bf16* d_v, int64_t n_nodes,
    int64_t n_rows, int d, int vec, int device, void* stream) {
  return run_backward(e, g_sums, values, seg, order, ids, d_e, d_v, n_nodes, n_rows, d, vec,
                      device, stream);
}
