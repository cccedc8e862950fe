// GatedGCN gate front: per canonical edge k
//   gate[k] = (b1h[src[k]] + b2h[dst[k]]) + (e[k] . W3 + b3)
// plus the BatchNorm moments over real edges (k < n_real)
//   mom = [sum_k gate[k] || sum_k gate[k]^2]   (f32 [2, D]).
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:gate_front_pallas (one call per
// GatedGCN layer, 16 per forward of the shipped model).
//
// Bound on the H100: operations. At E = 1M, D = 256 the product e . W3 is
// 2*E*D*D = 134 GFLOP; in f32 on the CUDA cores (67 TFLOP/s) that is
// 2.0 ms. Bytes: e and gate 1.02 GB each, two 150k-row node tables 154 MB
// each, ids 8 MB: about 2.36 GB, 0.70 ms at 3.35 TB/s.
//
// Design: a plain shared-memory tiled SGEMM. A block owns 64 output columns
// and walks 64-edge row tiles (blockIdx.x-strided, so the assignment of
// tiles to blocks is fixed); 256 threads each hold a 4x4 register tile and
// step through K in slices of 16 staged in shared memory. The epilogue adds
// the two gathered endpoint rows and the bias, writes the gate, and folds
// the real rows into per-thread column moments. Moments leave the block as
// one partial row per block, and a second kernel sums the partials in a
// fixed order: deterministic, with no float atomics, and padded rows never
// enter a sum. The TPU kernel's banded endpoint windows are not needed:
// endpoint rows are read directly.
#include "common.cuh"

namespace {

constexpr int BM = 64;        // edges per row tile
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // K slice staged in shared memory
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int TX = BN / TN;   // 16 threads across the columns
constexpr int TY = BM / TM;   // 16 threads down the rows
constexpr int APAD = 4;       // keeps the transposed A tile's stores spread

__global__ void __launch_bounds__(THREADS) gate_front_kernel(
    const float* __restrict__ b1h, const float* __restrict__ b2h,
    const float* __restrict__ e, const float* __restrict__ w3,
    const float* __restrict__ b3, const int* __restrict__ src,
    const int* __restrict__ dst, float* __restrict__ gate,
    float* __restrict__ partial, int64_t n_rows, int64_t n_real, int d) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // e tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];         // W3 tile
  __shared__ float red[2][TY][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int col0 = blockIdx.y * BN;
  const int64_t n_tiles = (n_rows + BM - 1) / BM;

  float s[TN] = {};
  float ss[TN] = {};

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * BM;
    float acc[TM][TN] = {};
    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int i = 0; i < (BM * BK) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / BK;
        const int c = idx % BK;
        const int64_t gr = row0 + r;
        const int gk = k0 + c;
        As[c][r] = (gr < n_rows && gk < d) ? e[gr * d + gk] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < (BK * BN) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int r = idx / BN;
        const int c = idx % BN;
        const int gk = k0 + r;
        const int gc = col0 + c;
        Bs[r][c] = (gk < d && gc < d) ? w3[(int64_t)gk * d + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
        const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
        const float b[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = row0 + ty * TM + i;
      if (row >= n_rows) break;
      const int64_t so = (int64_t)src[row] * d;
      const int64_t dO = (int64_t)dst[row] * d;
      const bool real = row < n_real;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col0 + tx * TN + j;
        if (col < d) {
          const float g = (b1h[so + col] + b2h[dO + col]) + (acc[i][j] + b3[col]);
          gate[row * d + col] = g;
          if (real) {
            s[j] += g;
            ss[j] += g * g;
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    red[0][ty][tx * TN + j] = s[j];
    red[1][ty][tx * TN + j] = ss[j];
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int k = tid / BN;
    const int c = tid % BN;
    float t = 0.0f;
    for (int r = 0; r < TY; ++r) t += red[k][r][c];
    if (col0 + c < d) partial[((int64_t)blockIdx.x * 2 + k) * d + col0 + c] = t;
  }
}

// mom[k, c] = sum over parts p of partial[p, k, c], in a fixed order: each
// of 8 warps sums a strided subset of the parts, then warp 0 adds the 8.
__global__ void __launch_bounds__(256) moments_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ mom, int n_parts,
    int d) {
  __shared__ float sm[8][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t out = (int64_t)blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (out < 2 * (int64_t)d) {
    const int64_t k = out / d;
    const int64_t c = out % d;
    for (int p = warp; p < n_parts; p += 8) acc += partial[((int64_t)p * 2 + k) * d + c];
  }
  sm[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && out < 2 * (int64_t)d) {
    float t = 0.0f;
    for (int w = 0; w < 8; ++w) t += sm[w][lane];
    mom[out] = t;
  }
}

}  // namespace

// partial: scratch f32 [n_parts, 2, d]; n_parts blocks walk the row tiles.
GNNOME_API int gnnome_gate_front_f32(
    const float* b1h, const float* b2h, const float* e, const float* w3,
    const float* b3, const int* src, const int* dst, float* gate,
    float* partial, float* mom, int64_t n_rows, int64_t n_real, int d,
    int n_parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_parts, (d + BN - 1) / BN);
  gate_front_kernel<<<grid, THREADS, 0, s>>>(b1h, b2h, e, w3, b3, src, dst,
                                             gate, partial, n_rows, n_real, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_reduce_kernel<<<(2 * d + 31) / 32, 256, 0, s>>>(partial, mom,
                                                          n_parts, d);
  return static_cast<int>(cudaGetLastError());
}
