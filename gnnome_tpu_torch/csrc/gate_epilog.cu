// GatedGCN gate epilog with the forward aggregation: per canonical edge k
//   e_new[k] = relu(gate[k] * scale2 + bias2) + e_in[k]
// and per destination node v, over its in-edges (CSR by_dst)
//   sums[v] = [sum_k sigmoid(e_new[k]) * val(k) || sum_k sigmoid(e_new[k])]
// (f32 [N, 2D]). scale2/bias2 are the folded BatchNorm affine ([2, D]). Two
// entry points:
//   gate_sigma_gather:    val(k) = values[src[k]], the node table gathered
//                         inside the kernel;
//   gate_sigma_aggregate: val(k) = vals[k], an [E, D] table already gathered
//                         per edge (the wide-gather path's a2h[src] half).
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:fused_gate_sigma_gather_pallas
// (gate_sigma_gather; one call per GatedGCN layer, 16 per forward) and
// fused_gate_sigma_aggregate_pallas (gate_sigma_aggregate; the same per
// layer under wide_gathers).
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k: gate and e_in
// read (2.05 GB), e_new written (1.02 GB), the sums written (307 MB), ids and
// offsets (5 MB), and the values table (154 MB): about 3.54 GB, 1.06 ms at
// 3.35 TB/s; with pregathered rows (1.02 GB) in its place about 4.40 GB,
// 1.31 ms; the bf16 entries read and write their [E, D] and [N, D] data in
// half the bytes, about 1.92 GB, 0.57 ms (gather) or 2.36 GB, 0.70 ms
// (pregathered). The arithmetic (one exp per element) is far below the
// line.
//
// bf16 rounding: both entries round where their TPU kernels round
// (fused_gate_sigma_gather_pallas, spmm_pallas.py:2951-2956;
// _fused_gate_kernel, :1395-1399). e_new is computed in f32 and stored
// rounded to bf16; sigma is taken of the unrounded f32 e_new, and each
// summand sigma * v and sigma is rounded to bf16 before its f32 sum
// (tests/test_torch_gather_round.py, tests/test_torch_bf16.py).
//
// Design: one warp per destination row. Canonical order is dst-sorted, so
// the row's edges are the contiguous range offsets[v]:offsets[v+1]; the
// warp walks them in order and accumulates in f32 registers, each lane
// owning one 16-byte access of consecutive columns per slice (4 f32 of
// 128, 8 bf16 of 256).
// Every sum is a fixed-order CSR row reduction: deterministic, no atomics.
// Padded edges (past offsets[N]) belong to no row; a second, elementwise
// kernel writes their e_new so the whole output is defined.
#include "common.cuh"

namespace {

// GATHER: the value row of edge k is values[src[k]], else vals[k]. T: the
// stored type of gate, e_in, values and e_new (float, or bf16 for the bf16
// entries: e_new is rounded as it is stored). Both forms round where the
// TPU kernels do: σ of the f32 e_new, each summand rounded to T (for
// T = float the rounding is the identity).
template <typename T, int VEC, bool GATHER>
__device__ __forceinline__ void gate_epilog_rows(
    const T* __restrict__ gate, const T* __restrict__ e_in,
    const T* __restrict__ values, const float* __restrict__ affine,
    const int* __restrict__ offsets, const int* __restrict__ src,
    float* __restrict__ sums, T* __restrict__ e_new, int64_t n_nodes,
    int d) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t v = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       v < n_nodes; v += n_warps) {
    const int64_t beg = offsets[v];
    const int64_t end = offsets[v + 1];
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float sc[VEC], bi[VEC];
      gnnome::load_vec<VEC>(affine + c, sc);
      gnnome::load_vec<VEC>(affine + d + c, bi);
      float acc1[VEC] = {};
      float acc2[VEC] = {};
      for (int64_t k = beg; k < end; ++k) {
        const int64_t so = (GATHER ? (int64_t)src[k] : k) * d;
        float g[VEC], x[VEC], val[VEC], en[VEC];
        gnnome::load_vec<VEC>(gate + k * d + c, g);
        gnnome::load_vec<VEC>(e_in + k * d + c, x);
        gnnome::load_vec<VEC>(values + so + c, val);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float e32 = fmaxf(gnnome::bn_affine(g[q], sc[q], bi[q]), 0.0f) + x[q];
          en[q] = gnnome::round_to<T>(e32);
          const float sg = gnnome::sigmoid(e32);
          acc1[q] += gnnome::round_to<T>(sg * val[q]);
          acc2[q] += gnnome::round_to<T>(sg);
        }
        gnnome::store_vec<VEC>(e_new + k * d + c, en);
      }
      gnnome::store_vec<VEC>(sums + v * 2 * d + c, acc1);
      gnnome::store_vec<VEC>(sums + v * 2 * d + d + c, acc2);
    }
  }
}

#define GATE_EPILOG_KERNEL(NAME, GATHER)                                               \
  template <typename T, int VEC>                                                       \
  __global__ void __launch_bounds__(128) NAME(                                         \
      const T* __restrict__ gate, const T* __restrict__ e_in,                          \
      const T* __restrict__ values, const float* __restrict__ affine,                  \
      const int* __restrict__ offsets, const int* __restrict__ src,                    \
      float* __restrict__ sums, T* __restrict__ e_new, int64_t n_nodes, int d) {       \
    gate_epilog_rows<T, VEC, GATHER>(gate, e_in, values, affine, offsets, src, sums,   \
                                     e_new, n_nodes, d);                               \
  }

GATE_EPILOG_KERNEL(gate_sigma_gather_kernel, true)
GATE_EPILOG_KERNEL(gate_sigma_aggregate_kernel, false)

// e_new for the padded edges [offsets[n_nodes], n_rows), which no row owns.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) gate_epilog_tail_kernel(
    const T* __restrict__ gate, const T* __restrict__ e_in,
    const float* __restrict__ affine, const int* __restrict__ offsets,
    T* __restrict__ e_new, int64_t n_nodes, int64_t n_rows, int d) {
  const int64_t start = offsets[n_nodes];
  const int per_row = d / VEC;
  const int64_t total = (n_rows - start) * per_row;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = start + t / per_row;
    const int c = static_cast<int>(t % per_row) * VEC;
    float g[VEC], x[VEC], sc[VEC], bi[VEC], en[VEC];
    gnnome::load_vec<VEC>(gate + k * d + c, g);
    gnnome::load_vec<VEC>(e_in + k * d + c, x);
    gnnome::load_vec<VEC>(affine + c, sc);
    gnnome::load_vec<VEC>(affine + d + c, bi);
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      en[q] = fmaxf(gnnome::bn_affine(g[q], sc[q], bi[q]), 0.0f) + x[q];
    }
    gnnome::store_vec<VEC>(e_new + k * d + c, en);
  }
}

template <typename T, int VEC>
int launch(const T* gate, const T* e_in, const T* values,
           const float* affine, const int* offsets, const int* src,
           float* sums, T* e_new, int64_t n_nodes, int64_t n_rows, int d,
           cudaStream_t s) {
  const int threads = 128;  // 4 rows per block
  const unsigned grid = gnnome::grid_for(n_nodes * 32, threads);
  if (src != nullptr) {
    gate_sigma_gather_kernel<T, VEC><<<grid, threads, 0, s>>>(
        gate, e_in, values, affine, offsets, src, sums, e_new, n_nodes, d);
  } else {
    gate_sigma_aggregate_kernel<T, VEC><<<grid, threads, 0, s>>>(
        gate, e_in, values, affine, offsets, src, sums, e_new, n_nodes, d);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the tail is usually empty: a small fixed grid, each thread reads the
  // start offset on the device and strides over what is there
  gate_epilog_tail_kernel<T, VEC><<<264, 256, 0, s>>>(gate, e_in, affine, offsets,
                                                      e_new, n_nodes, n_rows, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* gate, const T* e_in, const T* values,
             const float* affine, const int* offsets, const int* src, float* sums,
             T* e_new, int64_t n_nodes, int64_t n_rows, int d, int vec,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<T, gnnome::VEC16<T>>(gate, e_in, values, affine, offsets, src, sums,
                                           e_new, n_nodes, n_rows, d, s)
             : launch<T, 1>(gate, e_in, values, affine, offsets, src, sums, e_new,
                            n_nodes, n_rows, d, s);
}

}  // namespace

// vec: 16-byte accesses (rows of a multiple of 16 bytes, aligned bases)
GNNOME_API int gnnome_gate_sigma_gather_f32(
    const float* gate, const float* e_in, const float* values,
    const float* affine, const int* offsets, const int* src, float* sums,
    float* e_new, int64_t n_nodes, int64_t n_rows, int d, int vec,
    int device, void* stream) {
  if (src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(gate, e_in, values, affine, offsets, src, sums, e_new, n_nodes,
                  n_rows, d, vec, device, stream);
}

// gate, e_in, values, e_new bf16; affine and sums f32
GNNOME_API int gnnome_gate_sigma_gather_bf16(
    const gnnome::bf16* gate, const gnnome::bf16* e_in, const gnnome::bf16* values,
    const float* affine, const int* offsets, const int* src, float* sums,
    gnnome::bf16* e_new, int64_t n_nodes, int64_t n_rows, int d, int vec,
    int device, void* stream) {
  if (src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(gate, e_in, values, affine, offsets, src, sums, e_new, n_nodes,
                  n_rows, d, vec, device, stream);
}

// vals: [n_rows, d], one pregathered value row per canonical edge
GNNOME_API int gnnome_gate_sigma_aggregate_f32(
    const float* gate, const float* e_in, const float* vals, const float* affine,
    const int* offsets, float* sums, float* e_new, int64_t n_nodes, int64_t n_rows,
    int d, int vec, int device, void* stream) {
  return dispatch(gate, e_in, vals, affine, offsets, static_cast<const int*>(nullptr),
                  sums, e_new, n_nodes, n_rows, d, vec, device, stream);
}

// gate, e_in, vals, e_new bf16; affine and sums f32
GNNOME_API int gnnome_gate_sigma_aggregate_bf16(
    const gnnome::bf16* gate, const gnnome::bf16* e_in, const gnnome::bf16* vals,
    const float* affine, const int* offsets, float* sums, gnnome::bf16* e_new,
    int64_t n_nodes, int64_t n_rows, int d, int vec, int device, void* stream) {
  return dispatch(gate, e_in, vals, affine, offsets, static_cast<const int*>(nullptr),
                  sums, e_new, n_nodes, n_rows, d, vec, device, stream);
}
