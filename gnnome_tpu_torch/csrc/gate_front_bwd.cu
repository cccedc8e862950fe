// Backward of the GatedGCN gate front, its elementwise part: per canonical
// edge k
//   d_total[k] = d_gate[k] + [k < n_real] * (d_mom[0] + 2 * gate[k] * d_mom[1])
// (the cotangent of the gate plus the chain of the BatchNorm sums
// mom = [sum gate || sum gate^2], taken over real edges only), written once,
// and d_bias3 = sum over all rows k of d_total[k] (f32 [D]; padded rows
// included, where d_total is d_gate, as the JAX VJP sums them).
// d_b1h / d_b2h are the two segment sums of d_total (csrc/segment_sum.cu),
// and d_e = d_total . W3^T, d_W3 = e^T . d_total stay matrix products.
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:gate_front_bwd_stream_pallas
// (one call per GatedGCN layer, 16 per training step). The TPU kernel also
// accumulates d_total into both endpoint tables in the same stream; here
// those are two launches of the segment sum, to be fused in a later change.
//
// Bound on the H100: bytes. At E = 1M, D = 256: d_gate and gate read
// (2.05 GB), d_total written (1.02 GB): about 3.07 GB, 0.92 ms at
// 3.35 TB/s (bf16: half, 0.46 ms). Three flops per element.
//
// Design: each block walks a fixed, blockIdx-strided set of 64-row tiles;
// its 8 warps take the rows of a tile in turn, each lane one 16-byte
// access of consecutive columns per slice (4 f32 of 128, 8 bf16 of 256),
// and keep column sums in registers. The warps' sums meet in shared memory and leave the block as
// one partial row; a second kernel adds the partials in a fixed order.
// Deterministic, no float atomics (the TPU kernel carried the sum across
// its sequential grid; CUDA blocks run in no order).
#include "common.cuh"

namespace {

constexpr int ROWS = 64;    // rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// T: the stored type of d_gate, gate and d_total (float, or bf16 for the
// bf16 entry: d_total is rounded once, as it is stored; d_bias3 sums the
// unrounded f32 values, as the JAX VJP sums d_total32)
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) gate_front_bwd_kernel(
    const T* __restrict__ d_gate, const T* __restrict__ gate,
    const float* __restrict__ d_mom, T* __restrict__ d_total,
    float* __restrict__ partial, int64_t n_rows, int64_t n_real, int d) {
  extern __shared__ float red[];  // [WARPS][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_tiles = (n_rows + ROWS - 1) / ROWS;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float m0[VEC], m1[VEC];
    gnnome::load_vec<VEC>(d_mom + c, m0);
    gnnome::load_vec<VEC>(d_mom + d + c, m1);
    float acc[VEC] = {};
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int r = warp; r < ROWS; r += WARPS) {
        const int64_t row = tile * ROWS + r;
        if (row >= n_rows) break;
        float dg[VEC], g[VEC], t[VEC];
        gnnome::load_vec<VEC>(d_gate + row * d + c, dg);
        gnnome::load_vec<VEC>(gate + row * d + c, g);
        const bool real = row < n_real;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          t[q] = real ? dg[q] + (m0[q] + 2.0f * g[q] * m1[q]) : dg[q];
          acc[q] += t[q];
        }
        gnnome::store_vec<VEC>(d_total + row * d + c, t);
      }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) red[warp * d + c + q] = acc[q];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += red[w * d + c];
    partial[(int64_t)blockIdx.x * d + c] = s;
  }
}

__global__ void __launch_bounds__(256) bias3_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ d_bias3, int n_parts,
    int d) {
  gnnome::reduce_partials(partial, d_bias3, n_parts, d);
}

template <typename T, int VEC>
int launch(const T* d_gate, const T* gate, const float* d_mom,
           T* d_total, float* partial, float* d_bias3, int64_t n_rows,
           int64_t n_real, int d, int n_parts, cudaStream_t s) {
  const size_t smem = sizeof(float) * WARPS * d;
  cudaError_t err = gnnome::allow_smem(gate_front_bwd_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_front_bwd_kernel<T, VEC><<<n_parts, THREADS, smem, s>>>(
      d_gate, gate, d_mom, d_total, partial, n_rows, n_real, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bias3_reduce_kernel<<<(d + 31) / 32, 256, 0, s>>>(partial, d_bias3, n_parts, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* d_gate, const T* gate, const float* d_mom, T* d_total,
             float* partial, float* d_bias3, int64_t n_rows, int64_t n_real, int d,
             int n_parts, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<T, gnnome::VEC16<T>>(d_gate, gate, d_mom, d_total, partial, d_bias3,
                                           n_rows, n_real, d, n_parts, s)
             : launch<T, 1>(d_gate, gate, d_mom, d_total, partial, d_bias3, n_rows,
                            n_real, d, n_parts, s);
}

}  // namespace

// partial: scratch f32 [n_parts, d]; n_parts blocks walk the row tiles.
// vec: 16-byte accesses (rows of a multiple of 16 bytes, aligned bases).
GNNOME_API int gnnome_gate_front_bwd_f32(
    const float* d_gate, const float* gate, const float* d_mom, float* d_total,
    float* partial, float* d_bias3, int64_t n_rows, int64_t n_real, int d,
    int n_parts, int vec, int device, void* stream) {
  return dispatch(d_gate, gate, d_mom, d_total, partial, d_bias3, n_rows, n_real, d,
                  n_parts, vec, device, stream);
}

// d_gate, gate, d_total bf16; d_mom, partial, d_bias3 f32
GNNOME_API int gnnome_gate_front_bwd_bf16(
    const gnnome::bf16* d_gate, const gnnome::bf16* gate, const float* d_mom,
    gnnome::bf16* d_total, float* partial, float* d_bias3, int64_t n_rows, int64_t n_real,
    int d, int n_parts, int vec, int device, void* stream) {
  return dispatch(d_gate, gate, d_mom, d_total, partial, d_bias3, n_rows, n_real, d,
                  n_parts, vec, device, stream);
}
