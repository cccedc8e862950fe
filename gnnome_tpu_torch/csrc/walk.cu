// Greedy decode walks: one leg of B candidate walks in one launch.
//
// Replaces: gnnome_tpu/decode/tpu_walker.py:_walk_batch. That is jnp code
// in a lax.while_loop, not a Pallas kernel, so this is not a port of a TPU
// kernel; it is the device half of the decode engine (the JAX package's
// engine="tpu", the port's engine="device").
//
// Per walk b, from starts[b]: record the node, mark it and its strand mate
// (node ^ 1, clamped to n_pad - 1) in the walk's visited row, then hop to
// the first best-scoring usable slot of the node's row in the padded
// [n_pad, K] tables. A slot is usable if it holds a neighbour (id >= 0)
// that is marked neither in vg (the global visited set), nor in frozen[b]
// (the forward leg's visited row, for the backward leg), nor in the walk's
// own row; a node with a single neighbour hops to it whatever the marks
// (inference.py:42-44). The walk stops when no slot is usable, when the
// best score is below min_score, or after max_steps nodes. bp[b] sums the
// prefix lengths of the taken edges in int64: JAX's int32 overflows on long
// walks at real prefix lengths, the host engines' Python ints do not.
// Every operation is an integer operation or a compare, so the walks equal
// the host engines' exactly.
//
// Bound on the H100: latency. A leg is a chain of dependent reads: each
// step reads the row of the node the previous step chose. A launch takes
// at least its longest leg's steps times one dependent global read;
// gnnome_pointer_chase below measures that read (chip_smoke.py phase 11).
// The bytes (about 100 a step) and operations are far below that line.
//
// Design: one warp per walk, one walk per block, so the walks spread over
// the SMs. The lanes cover the K slots of the row in strides of 32, each
// keeping its first best (score, slot); a butterfly reduction on the pair
// (score, -slot) gives the first max of the row (jnp.argmax's tie-break,
// the host engines' first max). Lane 0 writes the walk and the marks; a
// __syncwarp orders the marks before the lanes read the next row's marks.
// The kernel also clears the visited row and writes the walk row's -1
// tail, so the caller's buffers are reused across launches without a fill.
// No float atomics.
#include <math.h>

#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t lesser(int64_t a, int64_t b) { return a < b ? a : b; }

// the warp zeroes n bytes at p: 16-byte stores over the aligned middle
__device__ __forceinline__ void warp_zero(uint8_t* p, int64_t n, int lane) {
  const int64_t head = lesser(n, (int64_t)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15));
  const int64_t body = (n - head) >> 4;
  for (int64_t i = lane; i < head; i += 32) p[i] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = lane; i < body; i += 32) q[i] = make_uint4(0, 0, 0, 0);
  for (int64_t i = head + (body << 4) + lane; i < n; i += 32) p[i] = 0;
}

// the warp writes -1 to n ints at p (4-byte aligned)
__device__ __forceinline__ void warp_fill_minus_one(int* p, int64_t n, int lane) {
  const int64_t head =
      lesser(n, (int64_t)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
  const int64_t body = (n - head) >> 2;
  for (int64_t i = lane; i < head; i += 32) p[i] = -1;
  int4* q = reinterpret_cast<int4*>(p + head);
  for (int64_t i = lane; i < body; i += 32) q[i] = make_int4(-1, -1, -1, -1);
  for (int64_t i = head + (body << 2) + lane; i < n; i += 32) p[i] = -1;
}

__global__ void __launch_bounds__(32) walk_kernel(
    const int* __restrict__ nbr, const float* __restrict__ score,
    const int* __restrict__ prefix, const int* __restrict__ deg,
    const int* __restrict__ starts, const uint8_t* __restrict__ vg,
    const uint8_t* __restrict__ frozen, float min_score, int64_t max_steps,
    int64_t n_pad, int k, int* __restrict__ walks, int* __restrict__ lengths,
    int64_t* __restrict__ bp, uint8_t* visited) {
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  // the walk's own marks are written and read in this launch: plain loads
  uint8_t* vis = visited + b * n_pad;
  const uint8_t* fz = frozen == nullptr ? nullptr : frozen + b * n_pad;
  int* walk = walks + b * max_steps;
  warp_zero(vis, n_pad, lane);
  __syncwarp();

  int cur = starts[b];
  int64_t acc = 0;
  int64_t step = 0;
  while (step < max_steps) {
    if (lane == 0) {
      walk[step] = cur;
      vis[lesser(cur, n_pad - 1)] = 1;
      vis[lesser(cur ^ 1, n_pad - 1)] = 1;
    }
    ++step;
    __syncwarp();
    const int64_t row = (int64_t)cur * k;
    const bool single = __ldg(deg + cur) == 1;
    float best = -INFINITY;
    int best_j = INT_MAX, best_nb = -1, best_pf = 0;
    for (int j = lane; j < k; j += 32) {
      const int nb = __ldg(nbr + row + j);
      if (nb < 0) continue;
      const float s = __ldg(score + row + j);
      const int pf = __ldg(prefix + row + j);
      const bool blocked = __ldg(vg + nb) | (fz != nullptr ? __ldg(fz + nb) : 0) | vis[nb];
      if ((single || !blocked) && s > best) {  // strict: a lane's first max
        best = s;
        best_j = j;
        best_nb = nb;
        best_pf = pf;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(kFull, best, off);
      const int oj = __shfl_xor_sync(kFull, best_j, off);
      const int onb = __shfl_xor_sync(kFull, best_nb, off);
      const int opf = __shfl_xor_sync(kFull, best_pf, off);
      if (os > best || (os == best && oj < best_j)) {
        best = os;
        best_j = oj;
        best_nb = onb;
        best_pf = opf;
      }
    }
    // lane 0's decision for every lane (NaN scores would leave the lanes
    // unordered)
    best = __shfl_sync(kFull, best, 0);
    best_nb = __shfl_sync(kFull, best_nb, 0);
    best_pf = __shfl_sync(kFull, best_pf, 0);
    if (!(best > -INFINITY && best >= min_score)) break;
    acc += best_pf;
    cur = best_nb;
  }
  if (lane == 0) {
    lengths[b] = static_cast<int>(step);
    bp[b] = acc;
  }
  warp_fill_minus_one(walk + step, max_steps - step, lane);
}

// One thread follows `hops` links of `next` from `start`: the latency of a
// dependent global read (through the read-only path, as the walk's table
// reads) is the kernel's time over `hops`.
__global__ void pointer_chase_kernel(const int* __restrict__ next, int64_t hops, int start,
                                     int* __restrict__ out) {
  int i = start;
  for (int64_t h = 0; h < hops; ++h) i = __ldg(next + i);
  *out = i;
}

}  // namespace

// nbr, prefix: int32 [n_pad, k]; score: f32 [n_pad, k]; deg: int32 [n_pad];
// starts: int32 [n_walks], each in [0, n_pad); vg: uint8 [n_pad]; frozen:
// uint8 [n_walks, n_pad] or null; outputs walks int32 [n_walks, max_steps]
// (-1 past each walk), lengths int32 [n_walks], bp int64 [n_walks], visited
// uint8 [n_walks, n_pad].
GNNOME_API int gnnome_walk(const int* nbr, const float* score, const int* prefix,
                           const int* deg, const int* starts, const uint8_t* vg,
                           const uint8_t* frozen, float min_score, int64_t max_steps,
                           int64_t n_pad, int k, int64_t n_walks, int* walks,
                           int* lengths, int64_t* bp, uint8_t* visited, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_walks == 0) return 0;
  if (n_walks > INT_MAX || max_steps < 1 || n_pad < 1 || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  walk_kernel<<<static_cast<unsigned>(n_walks), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      nbr, score, prefix, deg, starts, vg, frozen, min_score, max_steps, n_pad, k, walks,
      lengths, bp, visited);
  return static_cast<int>(cudaGetLastError());
}

GNNOME_API int gnnome_pointer_chase(const int* next, int64_t hops, int start, int* out,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, hops, start, out);
  return static_cast<int>(cudaGetLastError());
}
