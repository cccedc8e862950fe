// Segment sum of edge rows into node rows along one CSR layout:
//   out[v] = sum over the edges k keyed on node v of data[k]   (f32 [N, D])
// with data in canonical (dst-sorted) edge order. Two entry points:
//   by_dst: the edges of v are the canonical range offsets[v]:offsets[v+1];
//   by_src: they are order[offsets[v]:offsets[v+1]] (canonical positions,
//           ascending within a row because the src sort is stable).
// Padded edges (key PAD_SEGMENT, past offsets[N]) belong to no row and
// pad nodes own no edge, so neither enters a sum.
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:sorted_segment_sum_pallas
// (by_dst) and segment_sum_unsorted_pallas (by_src): the transpose
// reductions of the backward pass (d_b2h / d_b1h of the gate front,
// d_values of both aggregations, the score head's endpoint gathers);
// 33 calls of each entry per training step of the 16-layer model.
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k: data read once
// (1.02 GB), the node sums written (154 MB), offsets and order (5-9 MB):
// about 1.18 GB, 0.35 ms at 3.35 TB/s (bf16 data: about 0.67 GB, 0.20 ms).
// No arithmetic to speak of.
//
// Design: one warp per node row, each lane owning one 16-byte access of
// consecutive columns per slice (4 f32 of 128, or 8 bf16 of 256), the
// row's edges summed in f32 registers in CSR order: deterministic, no
// atomics, and nothing assumes the rows of a segment lie near each other
// (the TPU kernels' one-hot blocks needed banded keys). The TPU's sequential grid carried a node
// block's sum across edge tiles; here a warp owns its row outright.
#include "common.cuh"

namespace {

using gnnome::bf16;

// T: the stored type of data (float, or bf16 for the bf16 entries); the
// sums are f32 either way. VEC: elements per access (16 / sizeof(T), or 1).
template <typename T, int VEC, bool ORDERED>
__global__ void __launch_bounds__(128) segment_sum_kernel(
    const T* __restrict__ data, const int* __restrict__ offsets,
    const int* __restrict__ order, float* __restrict__ out, int64_t n_nodes,
    int d) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t v = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       v < n_nodes; v += n_warps) {
    const int64_t beg = offsets[v];
    const int64_t end = offsets[v + 1];
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float acc[VEC] = {};
#pragma unroll 4
      for (int64_t j = beg; j < end; ++j) {
        const int64_t k = ORDERED ? (int64_t)order[j] : j;
        float x[VEC];
        gnnome::load_vec<VEC>(data + k * d + c, x);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] += x[q];
      }
      gnnome::store_vec<VEC>(out + v * d + c, acc);
    }
  }
}

template <typename T, bool ORDERED>
int launch(const T* data, const int* offsets, const int* order, float* out,
           int64_t n_nodes, int d, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_nodes == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;  // 4 rows per block
  const unsigned grid = gnnome::grid_for(n_nodes * 32, threads);
  if (vec) {
    segment_sum_kernel<T, gnnome::VEC16<T>, ORDERED><<<grid, threads, 0, s>>>(
        data, offsets, order, out, n_nodes, d);
  } else {
    segment_sum_kernel<T, 1, ORDERED><<<grid, threads, 0, s>>>(data, offsets, order,
                                                              out, n_nodes, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec: 16-byte accesses (rows of a multiple of 16 bytes, aligned bases)
GNNOME_API int gnnome_segment_sum_by_dst_f32(const float* data, const int* offsets,
                                             float* out, int64_t n_nodes, int d,
                                             int vec, int device, void* stream) {
  return launch<float, false>(data, offsets, nullptr, out, n_nodes, d, vec, device, stream);
}

GNNOME_API int gnnome_segment_sum_by_src_f32(const float* data, const int* offsets,
                                             const int* order, float* out,
                                             int64_t n_nodes, int d, int vec,
                                             int device, void* stream) {
  return launch<float, true>(data, offsets, order, out, n_nodes, d, vec, device, stream);
}

// bf16 data, f32 sums
GNNOME_API int gnnome_segment_sum_by_dst_bf16(const bf16* data, const int* offsets,
                                              float* out, int64_t n_nodes, int d,
                                              int vec, int device, void* stream) {
  return launch<bf16, false>(data, offsets, nullptr, out, n_nodes, d, vec, device, stream);
}

GNNOME_API int gnnome_segment_sum_by_src_bf16(const bf16* data, const int* offsets,
                                              const int* order, float* out,
                                              int64_t n_nodes, int d, int vec,
                                              int device, void* stream) {
  return launch<bf16, true>(data, offsets, order, out, n_nodes, d, vec, device, stream);
}
