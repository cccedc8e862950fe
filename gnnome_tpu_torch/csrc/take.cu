// Row gather: out[i] = table[ids[i]], a zero row where ids[i] is outside
// [0, n_rows) (PAD_SEGMENT on padded edges).
//
// Replaces: gnnome_tpu/ops/banded.py:banded_take_pallas (reached through
// take_rows / gather_by_endpoint; the score head's two endpoint gathers,
// gnnome_tpu/models/model.py:67-69).
//
// Bound on the H100: bytes. At E = 1M ids and D = 256 f32 it moves 1.02 GB
// of output, 4 MB of ids and at most 154 MB of a 150k-row table: about
// 1.18 GB, 0.35 ms at 3.35 TB/s. On the score-head path D = 64 (the
// hidden_edge_scores projection): about 0.30 GB, 0.09 ms.
//
// Design: one thread per 16-byte chunk of an output row (4 floats when
// D % 4 == 0, else one float), grid-stride over all chunks, so neighbouring
// threads write neighbouring addresses and each table row is read with
// full-width loads. The TPU kernel's band plans and one-hot selection exist
// because the TPU is slow at random row reads; Hopper's memory system
// serves them directly, so no banding is assumed.
#include "common.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(256) take_rows_kernel(
    const float* __restrict__ table, const int* __restrict__ ids,
    float* __restrict__ out, int64_t n_ids, int64_t n_rows, int d) {
  const int per_row = d / VEC;
  const int64_t total = n_ids * per_row;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = t / per_row;
    const int c = static_cast<int>(t - i * per_row) * VEC;
    const int id = ids[i];
    float v[VEC];
    if (id >= 0 && id < n_rows) {
      gnnome::load_vec<VEC>(table + (int64_t)id * d + c, v);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[q] = 0.0f;
    }
    gnnome::store_vec<VEC>(out + i * d + c, v);
  }
}

}  // namespace

GNNOME_API int gnnome_take_rows_f32(const float* table, const int* ids,
                                    float* out, int64_t n_ids, int64_t n_rows,
                                    int d, int vec4, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (vec4) {
    take_rows_kernel<4><<<gnnome::grid_for(n_ids * (d / 4), threads),
                          threads, 0, s>>>(table, ids, out, n_ids, n_rows, d);
  } else {
    take_rows_kernel<1><<<gnnome::grid_for(n_ids * d, threads), threads, 0,
                          s>>>(table, ids, out, n_ids, n_rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}
