// Shared helpers for the port's hand-written kernels.
//
// Every kernel library entry point has a plain C interface (bound with
// ctypes from gnnome_tpu_torch/ops/cuda_lib.py): raw device pointers, sizes
// as int64, the device index and the caller's cudaStream_t. It launches on
// that stream, allocates nothing, and returns cudaGetLastError() as an int
// (0 = launched); the Python wrapper raises on anything else.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GNNOME_API extern "C" __attribute__((visibility("default")))

namespace gnnome {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// VEC consecutive floats; VEC == 4 uses one 16-byte access (the caller
// guarantees 16-byte alignment: row width % 4 == 0 and aligned bases).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = p[q];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) p[q] = v[q];
  }
}

// Blocks for a grid-stride loop over `work` items: enough to fill the card,
// never more than the work needs.
inline unsigned grid_for(int64_t work, int threads, int64_t cap = 1 << 20) {
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks);
}

}  // namespace gnnome
