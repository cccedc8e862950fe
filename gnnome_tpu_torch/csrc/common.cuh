// Shared helpers for the port's hand-written kernels.
//
// Every kernel library entry point has a plain C interface (bound with
// ctypes from gnnome_tpu_torch/ops/cuda_lib.py): raw device pointers, sizes
// as int64, the device index and the caller's cudaStream_t. It launches on
// that stream, allocates nothing, and returns cudaGetLastError() as an int
// (0 = launched); the Python wrapper raises on anything else.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Storage types. Every kernel reads and writes its [E, D] and [N, D] data
// as T, float or __nv_bfloat16 (the bf16 entries); loads convert to f32,
// all arithmetic runs in f32, and stores round to nearest
// (__float2bfloat16_rn). Sums, moments and the affine stay f32 arrays.
using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

// elements of T in one 16-byte access: 4 floats or 8 bf16
template <typename T>
constexpr int VEC16 = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// x as a store into T keeps it: rounded to bf16 and back for T = bf16
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (is_bf16<T>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (is_bf16<T>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// 8 bf16 packed in 16 bytes <-> 8 floats (element 0 in the low half). A
// bf16 is the high half of the f32 with the same value.
__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// VEC consecutive elements of T as floats. A multiple of 16 bytes (VEC a
// multiple of 4 floats or 8 bf16) uses 16-byte accesses: the caller
// guarantees 16-byte alignment (row bytes % 16 == 0 and aligned bases).
// CS: streaming forms for [E, D] data that is read or written once and is
// far larger than the L2 (ld.global.cs / st.global.cs: evict first), so it
// does not push out the node tables that neighbouring edges share.
template <int VEC, bool CS, typename T>
__device__ __forceinline__ void load_as_f32(const T* p, float (&v)[VEC]) {
  if constexpr (!is_bf16<T> && VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4* q = reinterpret_cast<const float4*>(p) + i;
      const float4 t = CS ? __ldcs(q) : *q;
      v[4 * i] = t.x; v[4 * i + 1] = t.y; v[4 * i + 2] = t.z; v[4 * i + 3] = t.w;
    }
  } else if constexpr (is_bf16<T> && VEC % 8 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      const uint4* q = reinterpret_cast<const uint4*>(p) + i;
      unpack8(CS ? __ldcs(q) : *q, v + 8 * i);
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = to_f32(CS ? __ldcs(p + q) : p[q]);
  }
}

template <int VEC, bool CS, typename T>
__device__ __forceinline__ void store_from_f32(T* p, const float (&v)[VEC]) {
  if constexpr (!is_bf16<T> && VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      float4* q = reinterpret_cast<float4*>(p) + i;
      const float4 t = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
      if constexpr (CS) {
        __stcs(q, t);
      } else {
        *q = t;
      }
    }
  } else if constexpr (is_bf16<T> && VEC % 8 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      uint4* q = reinterpret_cast<uint4*>(p) + i;
      const uint4 t = pack8(v + 8 * i);
      if constexpr (CS) {
        __stcs(q, t);
      } else {
        *q = t;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      if constexpr (CS) {
        __stcs(p + q, from_f32<T>(v[q]));
      } else {
        p[q] = from_f32<T>(v[q]);
      }
    }
  }
}

template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  load_as_f32<VEC, false>(p, v);
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  store_from_f32<VEC, false>(p, v);
}

template <int VEC, typename T>
__device__ __forceinline__ void load_vec_cs(const T* p, float (&v)[VEC]) {
  load_as_f32<VEC, true>(p, v);
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec_cs(T* p, const float (&v)[VEC]) {
  store_from_f32<VEC, true>(p, v);
}

// load_vec_cs where CS, else load_vec. The walks stream [E, D] inputs with
// ld.global.cs where they also gather node-table rows (which the streamed
// data would push out of the L2), and with plain loads where they do not
// (the pregathered forms: 0-3% faster so on the H100, PERF.md section 6).
template <bool CS, int VEC, typename T>
__device__ __forceinline__ void load_stream(const T* p, float (&v)[VEC]) {
  load_as_f32<VEC, CS>(p, v);
}

// The norm kernels' chunks (csrc/layer_norm.cu, csrc/batch_norm.cu): VEC
// elements at p as floats in one access where `aligned` (4 f32 or 8 bf16 in
// 16 bytes, 4 bf16 in 8), else element by element, the same values either
// way; `aligned` vouches for the base and the row stride.
template <int VEC, bool CS, typename T>
__device__ __forceinline__ void load_chunk(const T* p, bool aligned, float (&v)[VEC]) {
  if constexpr (VEC == 4 && is_bf16<T>) {
    if (aligned) {
      const uint2* q = reinterpret_cast<const uint2*>(p);
      const uint2 u = CS ? __ldcs(q) : *q;
      v[0] = __uint_as_float(u.x << 16);
      v[1] = __uint_as_float(u.x & 0xffff0000u);
      v[2] = __uint_as_float(u.y << 16);
      v[3] = __uint_as_float(u.y & 0xffff0000u);
      return;
    }
  } else if constexpr (VEC > 1) {
    if (aligned) {
      load_as_f32<VEC, CS>(p, v);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < VEC; ++q) v[q] = to_f32(CS ? __ldcs(p + q) : p[q]);
}

// ... and stored rounded to T with st.global.cs
template <int VEC, typename T>
__device__ __forceinline__ void store_chunk(T* p, bool aligned, const float (&v)[VEC]) {
  if constexpr (VEC == 4 && is_bf16<T>) {
    if (aligned) {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3])));
      return;
    }
  } else if constexpr (VEC > 1) {
    if (aligned) {
      store_vec_cs<VEC>(p, v);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < VEC; ++q) __stcs(p + q, from_f32<T>(v[q]));
}

// The norms' xh = (x - mean) * rstd and y = xh * scale + bias, rounded after
// each step as PyTorch's separate operations round them and then to the
// stored dtype T (the plain chains round the norm's output before the
// ReLU), and the ReLU's mask as torch.relu takes it (y <= 0 gives 0; NaN
// passes). The backward passes recompute y with these same instructions,
// so their mask is the forward's bit for bit.
__device__ __forceinline__ float normalize(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

template <typename T>
__device__ __forceinline__ float affine(float xh, float s, float b) {
  return round_to<T>(bn_affine(xh, s, b));
}

__device__ __forceinline__ bool kept(float y) { return !(y <= 0.0f); }

// Edge-balanced walks (csrc/epilog_bwd.cu, csrc/sigma_rows.cuh). A walker
// is a group of 2^lanes_log2 lanes of one warp (8, 16 or 32). The positions
// [0, n_rows) are cut into tiles of 4 consecutive positions, and walker w
// of W takes tiles w, w + W, w + 2W, ...: a fixed set of equal spans, from
// the block and warp index alone (no work counter, so a launch repeats
// exactly). A row's edges may fall in several tiles (a hub row is split),
// and padded positions are ordinary positions of the last tiles. The
// walkers that run at once work on neighbouring tiles, so the rows their
// edges gather (node-table rows, and the [E, D] rows a by_src walk reads
// through order) lie in a window of W tiles: one span of n_rows / W
// positions per walker spread them over the whole graph and ran rev_bwd
// 17-20% slower than a warp per row did; tiles of 32 positions 6% slower,
// of 4 positions 2% faster (H100, 150k / 1M; PERF.md section 6).
//
// A walker goes a tile at a time: each lane of the first `tile` of the
// group reads the ids of one position of the tile (those of the next tile
// are in flight meanwhile), and the group takes them position by position
// with shuffles over its own lanes (`mask`), so no load waits on an id load
// per edge.

// log2 of the positions of a tile: 4 (of 32, 16, 8, 4 and 2 tried on the
// H100 at 150k / 1M, D = 256; PERF.md section 6)
constexpr int WALK_TILE_LOG2 = 2;

struct Walker {
  int lanes;      // lanes of the group
  int tile;       // positions in a tile (at most lanes)
  int sl;         // this lane's index in its group
  unsigned mask;  // the group's lanes in the warp
  int64_t first;  // the walker's first tile starts here
  int64_t stride; // positions from one of its tiles to the next
};

__device__ __forceinline__ Walker edge_walker(int lanes_log2) {
  const int lane = threadIdx.x & 31;
  const int slots = 32 >> lanes_log2;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t walkers = ((int64_t)gridDim.x * blockDim.x >> 5) * slots;
  Walker w;
  w.lanes = 1 << lanes_log2;
  w.sl = lane & (w.lanes - 1);
  w.mask = w.lanes == 32 ? 0xffffffffu : ((1u << w.lanes) - 1u) << (lane & ~(w.lanes - 1));
  const int tile_log2 = lanes_log2 < WALK_TILE_LOG2 ? lanes_log2 : WALK_TILE_LOG2;
  w.tile = 1 << tile_log2;
  w.first = (warp * slots + (lane >> lanes_log2)) << tile_log2;
  w.stride = walkers << tile_log2;
  return w;
}

// position i of the group's tile: the value `mine` that its lane holds
template <typename T>
__device__ __forceinline__ T tile_take(const Walker& w, T mine, int i) {
  return __shfl_sync(w.mask, mine, i, w.lanes);
}

// The lane group and chunks per lane (1, 2 or 4) for rows of per_row chunks
// of VEC floats (csrc/take.cu and the walks): the power of two nearest
// per_row, 8 to 32 lanes, so that a row of up to 128 chunks (D = 512 at
// VEC = 4) is one pass; the walks take wider rows (only VEC = 1 at D > 128)
// in several column passes.
inline void lane_layout(int per_row, int* lanes_log2, int* chunks) {
  int l = 3;
  while (l < 5 && (1 << l) < per_row) ++l;
  const int per_lane = (per_row + (1 << l) - 1) >> l;
  *lanes_log2 = l;
  *chunks = per_lane <= 1 ? 1 : per_lane <= 2 ? 2 : 4;
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<CH>{}) for the chunks per lane that lane_layout chose: the host
// side's one switch from that count to a kernel instance, as in
// with_chunks(chunks, [&](auto ch) { return launch<VEC, decltype(ch)::value>(...); })
template <class F>
inline auto with_chunks(int chunks, F f) {
  if (chunks == 1) return f(Int<1>{});
  if (chunks == 2) return f(Int<2>{});
  return f(Int<4>{});
}

// Blocks of `threads` that fill the card once for `kernel` (resident blocks
// per SM times the SMs), and no more than give every walker `min_span`
// positions of n_rows (a tile at least): the one fixed grid of an
// edge-balanced walk.
template <typename K>
inline cudaError_t walk_grid(K kernel, int threads, size_t smem, int device,
                             int64_t n_rows, int64_t walkers_per_block, int64_t min_span,
                             unsigned* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  int64_t blocks = (n_rows + walkers_per_block * min_span - 1) / (walkers_per_block * min_span);
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > full) blocks = full;
  if (blocks < 1) blocks = 1;
  *grid = static_cast<unsigned>(blocks);
  return cudaSuccess;
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
