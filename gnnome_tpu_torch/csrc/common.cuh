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

// The folded BatchNorm affine x * scale + bias, rounded after the product
// and after the sum as PyTorch's separate multiply and add round it (no
// fused multiply-add): the forward epilog, its backward and the plain
// versions then take the same side of the ReLU at pre = 0.
__device__ __forceinline__ float bn_affine(float x, float scale, float bias) {
  return __fadd_rn(__fmul_rn(x, scale), bias);
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

// The second pass of a cross-block column sum, in a fixed order (no float
// atomics): out[i] = sum over p of partial[p * width + i]. Launch with
// 256 threads and (width + 31) / 32 blocks; each of the 8 warps sums a
// strided subset of the parts for 32 columns, then warp 0 adds the 8
// results in order.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ partial,
                                                float* __restrict__ out,
                                                int n_parts, int64_t width) {
  __shared__ float sm[8][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t col = (int64_t)blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (col < width) {
    for (int p = warp; p < n_parts; p += 8) acc += partial[(int64_t)p * width + col];
  }
  sm[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < width) {
    float t = 0.0f;
    for (int w = 0; w < 8; ++w) t += sm[w][lane];
    out[col] = t;
  }
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gnnome
