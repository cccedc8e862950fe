// BatchNorm -> ReLU -> residual over the rows of an [N, D] tensor with a row
// mask, statistics over the rows where the mask is set,
//   out = relu(BN(x) * scale + bias) + residual,
// forward and backward: the BatchNorm GatedGCN's node norm with the ReLU and
// the residual add after it (gnnome_tpu_torch/ops/norm.py
// batch_norm_relu_residual).
//
// Replaces no TPU kernel: the JAX package leaves masked_batch_norm
// (gnnome_tpu/ops/norm.py:43) and the ReLU and residual around it to XLA,
// which fuses them. Run op by op, as PyTorch runs the plain version, the
// moments alone make an f32 copy, x * m, x * x * m and two column sums, and
// the normalisation, the ReLU and the add are a pass each, all replayed
// backward by autograd.
//
// Bound on the H100: bytes. At N = 150k rows, D = 256 f32 x is 153.6 MB,
// more than the 50 MB L2, so a BatchNorm reads x twice each way: the
// forward's column sums read x (real rows only) and the mask, its apply pass
// reads x and the residual and writes out (614 MB, 0.18 ms at 3.35 TB/s);
// the backward's column sums read x and the cotangent g, its dx pass reads
// them again and writes dx (768 MB, 0.23 ms); bf16 half that. A few flops an
// element.
//
// Design, for two reads of x each way and no [N, D] intermediate:
// - Column layout (the launch plan of ops/norm.py batch_norm_plan, from D
//   alone): a row is cut into chunks of VEC = 4 elements where D allows
//   (16-byte accesses in f32, 8-byte in bf16, so that a bf16 thread holds
//   the statistics of as few columns as an f32 one: 16-byte bf16 chunks
//   held twice the registers, and ran at 50-58% of the bound against
//   73-84% in f32 at N = 150k, D = 256 on the H100), else 1; a group of `lanes`
//   consecutive threads takes a row, lane l chunks l, l + lanes, ... (CH of
//   them, at most 16 values), and the THREADS / lanes groups of a block take
//   that many rows at once. Each thread keeps its own columns in registers
//   for every row it visits; a block visits rows blockIdx.x * slots + slot,
//   then a grid's worth of rows further. Rows wider than lanes * CH chunks
//   take several column tiles (blockIdx.y).
// - The two column-sum passes (forward moments; backward sum gy * xh and
//   sum gy) add into registers over the thread's rows, then over the block's
//   row groups in a fixed order through shared memory into one partial row a
//   block; a second kernel adds the partial rows in a fixed order. No float
//   atomics, so a launch repeats bit for bit, and the recompute of a
//   checkpointed layer reproduces its forward.
// - The forward's moments count, sum and sum the squares of the real rows
//   only, skipping the loads of padded rows. Between the two forward
//   launches the one f32 row [count | sum x | sum x^2] may be all-reduced
//   over ranks (the sharded step); every block of the apply pass derives
//   mean, var = max(sum x^2 / n - mean^2, 0) and 1 / sqrt(var + eps) of its
//   columns from that row itself, as masked_moments does, so no PyTorch op
//   sits between the launches.
// - The apply pass and both backward passes compute the normalisation and
//   the affine ((x - mean) * rstd) * scale + bias with explicit roundings
//   (no contraction into fused multiply-adds, the gnnome::bn_affine rule), in
//   masked_batch_norm's order: the backward's ReLU mask is the forward's bit
//   for bit. bf16 rounds the BatchNorm's output before the ReLU and the sum
//   with the residual once, as JAX's bf16 layer rounds them.
// - The backward's column sums run over every row, padded rows too (their
//   output was computed, so autograd sums them), and serve both d_scale /
//   d_bias and the statistics' gradient:
//     dx = rstd * (gy * scale) - m * (rstd / n) * (A + xh * B),
//   A = scale * sum gy, B = scale * sum gy * xh (0 where var was clamped).
//   Where the rows are sharded, a copy of the sums is all-reduced between
//   the two launches.
// x, the residual and g are read once a pass and are far larger than the
// L2: they stream with ld.global.cs, and out and dx leave with st.global.cs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_VALUES = 16;  // values of a row a lane (CH * VEC)
// rows a thread of the moments pass loads before it adds them, for loads
// in flight in a pass that reads one tensor; the passes over two tensors
// take a row at a time (two rows a thread ran bf16 at 52-67% of the bound
// against 60-71% with one, f32 alike, H100, N = 150k, D = 256)
constexpr int ROWS = 2;

using gnnome::affine;
using gnnome::kept;
using gnnome::load_chunk;
using gnnome::normalize;
using gnnome::store_chunk;

// The thread's place in the plan's layout: its lane in the row's group, the
// group's row slot, and the element column of each of its CH chunks
// (`in`: the chunk lies inside the row).
template <int VEC, int CH>
struct Cols {
  int lanes, sl, slot, slots;
  int tile;   // elements of a column tile
  int tile0;  // the tile's first element column
  int col[CH];
  bool in[CH];
  int64_t first, stride;  // the thread's first row and the step to its next

  __device__ __forceinline__ Cols(int lanes_log2, int d) {
    lanes = 1 << lanes_log2;
    sl = threadIdx.x & (lanes - 1);
    slot = threadIdx.x >> lanes_log2;
    slots = THREADS >> lanes_log2;
    tile = lanes * CH * VEC;
    tile0 = blockIdx.y * tile;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      col[k] = tile0 + (k * lanes + sl) * VEC;
      in[k] = col[k] < d;
    }
    first = static_cast<int64_t>(blockIdx.x) * slots + slot;
    stride = static_cast<int64_t>(gridDim.x) * slots;
  }
  // the column's place in the tile
  __device__ __forceinline__ int at(int k, int q) const { return col[k] - tile0 + q; }
};

// the thread's chunks of a row (CS: streamed, for the [R, D] inputs) or of
// a [D] vector, zeros past the row
template <bool CS, int VEC, int CH, typename T>
__device__ __forceinline__ void load_cols(const T* p, const Cols<VEC, CH>& c, bool aligned,
                                          float (&v)[CH][VEC]) {
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (c.in[k]) {
      load_chunk<VEC, CS>(p + c.col[k], aligned, v[k]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[k][q] = 0.0f;
    }
  }
}

// The passes over two tensors ask the L2 for the thread's chunks of the
// row PREFETCH strides ahead of the one they load, so that more bytes are
// in flight than a thread's registers hold: at N = 150k, D = 256 on the
// H100 that took the bf16 passes from 60-75% to 67-85% of their bound
// (distances 0, 2, 4, 8 tried; f32 moved by under 2%, and the moments pass,
// over one tensor, lost 6-9%, so it asks for none).
constexpr int PREFETCH = 2;

template <int VEC, int CH, typename T>
__device__ __forceinline__ void prefetch_row(const T* p, const Cols<VEC, CH>& c, int d,
                                             int64_t row, int64_t n_rows) {
  const int64_t ahead = row + PREFETCH * c.stride;
  if (ahead >= n_rows) return;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (c.in[k]) asm volatile("prefetch.global.L2 [%0];" ::"l"(p + ahead * d + c.col[k]));
  }
}

// The statistics of column `col` from sums = [count | sum x | sum x^2], as
// masked_moments and masked_batch_norm take them: n = max(count, 1),
// mean = sum x / n, var = sum x^2 / n - mean^2 clamped at 0 (`clamped`:
// it was below 0, so no gradient reaches it), rstd = 1 / sqrt(var + eps).
struct Stats {
  float n, mean, rstd;
  bool clamped;
};

__device__ __forceinline__ Stats col_stats(const float* sums, int d, int col, float eps) {
  Stats s;
  s.n = fmaxf(sums[0], 1.0f);
  s.mean = __fdiv_rn(sums[1 + col], s.n);
  const float var = __fsub_rn(__fdiv_rn(sums[1 + d + col], s.n), __fmul_rn(s.mean, s.mean));
  s.clamped = var < 0.0f;
  s.rstd = rsqrtf(__fadd_rn(s.clamped ? 0.0f : var, eps));
  return s;
}

// The block's column sums of a and b: over its row groups in slot order
// through shared memory (red: [slots][2 * tile]), into out[col] and
// out[d + col] for the tile's columns.
template <int VEC, int CH>
__device__ __forceinline__ void block_partial(const float (&a)[CH][VEC],
                                              const float (&b)[CH][VEC],
                                              const Cols<VEC, CH>& c, int d, float* red,
                                              float* out) {
  float* mine = red + c.slot * 2 * c.tile;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (!c.in[k]) continue;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      mine[c.at(k, q)] = a[k][q];
      mine[c.tile + c.at(k, q)] = b[k][q];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * c.tile; e += THREADS) {
    const int half = e >= c.tile;
    const int col = c.tile0 + e - half * c.tile;
    if (col >= d) continue;
    float t = 0.0f;
    for (int w = 0; w < c.slots; ++w) t = __fadd_rn(t, red[w * 2 * c.tile + e]);
    out[half * d + col] = t;
  }
}

// forward, first pass: a partial row [count | sum x | sum x^2] a block over
// the real rows it visits
template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) batch_norm_moments_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, float* __restrict__ partial,
    int64_t n_rows, int d, int lanes_log2, bool aligned) {
  __shared__ float red[2 * THREADS * CH * VEC];
  __shared__ int counts[THREADS];
  const Cols<VEC, CH> c(lanes_log2, d);
  float s[CH][VEC], ss[CH][VEC];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) s[k][q] = ss[k][q] = 0.0f;
  }
  int count = 0;
  for (int64_t row0 = c.first; row0 < n_rows; row0 += ROWS * c.stride) {
    bool real[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int64_t row = row0 + u * c.stride;
      real[u] = row < n_rows && mask[row] != 0;
    }
    float v[ROWS][CH][VEC];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (real[u]) load_cols<true, VEC, CH>(x + (row0 + u * c.stride) * d, c, aligned, v[u]);
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (!real[u]) continue;
      ++count;
#pragma unroll
      for (int k = 0; k < CH; ++k) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          s[k][q] = __fadd_rn(s[k][q], v[u][k][q]);
          ss[k][q] = __fmaf_rn(v[u][k][q], v[u][k][q], ss[k][q]);
        }
      }
    }
  }
  if (c.sl == 0) counts[c.slot] = count;
  float* out = partial + static_cast<int64_t>(blockIdx.x) * (1 + 2 * static_cast<int64_t>(d));
  block_partial<VEC, CH>(s, ss, c, d, red, out + 1);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < c.slots; ++w) t += counts[w];
    out[0] = static_cast<float>(t);
  }
}

// The second pass of both column sums: out[i] = sum over p of
// partial[p * width + i] in a fixed order. A block of REDUCE_WARPS warps
// takes 32 columns; warp w adds parts w, w + REDUCE_WARPS, ..., then warp 0
// adds the warps' sums in order (a thousand partial rows are 33 dependent
// loads a warp).
constexpr int REDUCE_WARPS = 32;

__global__ void __launch_bounds__(REDUCE_WARPS * 32) bn_partials_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int n_parts, int64_t width) {
  __shared__ float sm[REDUCE_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  float acc = 0.0f;
  if (col < width) {
    for (int p = warp; p < n_parts; p += REDUCE_WARPS)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(p) * width + col]);
  }
  sm[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < width) {
    float t = 0.0f;
    for (int w = 0; w < REDUCE_WARPS; ++w) t = __fadd_rn(t, sm[w][lane]);
    out[col] = t;
  }
}

cudaError_t sum_partials(const float* partial, float* out, int n_parts, int64_t width,
                         cudaStream_t s) {
  bn_partials_reduce_kernel<<<static_cast<unsigned>((width + 31) / 32), REDUCE_WARPS * 32, 0,
                              s>>>(partial, out, n_parts, width);
  return cudaGetLastError();
}

// the thread's columns: statistics, scale and bias
template <typename T, int VEC, int CH>
struct ColParams {
  float mean[CH][VEC], rstd[CH][VEC], s[CH][VEC], b[CH][VEC];

  __device__ __forceinline__ ColParams(const float* sums, const T* scale, const T* bias,
                                       const Cols<VEC, CH>& c, int d, float eps, bool aligned,
                                       float (*n)[VEC] = nullptr,
                                       bool (*clamped)[VEC] = nullptr) {
    load_cols<false, VEC, CH>(scale, c, aligned, s);
    load_cols<false, VEC, CH>(bias, c, aligned, b);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const Stats st = col_stats(sums, d, c.in[k] ? c.col[k] + q : 0, eps);
        mean[k][q] = st.mean;
        rstd[k][q] = st.rstd;
        if (n) n[k][q] = st.n;
        if (clamped) clamped[k][q] = st.clamped;
      }
    }
  }
};

// forward, second pass: out = relu(BN(x)) + residual over every row
template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) batch_norm_relu_residual_kernel(
    const T* __restrict__ x, const float* __restrict__ sums, const T* __restrict__ scale,
    const T* __restrict__ bias, const T* __restrict__ residual, T* __restrict__ out,
    int64_t n_rows, int d, float eps, int lanes_log2, bool aligned) {
  const Cols<VEC, CH> c(lanes_log2, d);
  const ColParams<T, VEC, CH> p(sums, scale, bias, c, d, eps, aligned);
  for (int64_t row = c.first; row < n_rows; row += c.stride) {
    prefetch_row<VEC, CH>(x, c, d, row, n_rows);
    prefetch_row<VEC, CH>(residual, c, d, row, n_rows);
    float v[CH][VEC], r[CH][VEC];
    load_cols<true, VEC, CH>(x + row * d, c, aligned, v);
    load_cols<true, VEC, CH>(residual + row * d, c, aligned, r);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (!c.in[k]) continue;
      float o[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float y = affine<T>(normalize(v[k][q], p.mean[k][q], p.rstd[k][q]), p.s[k][q],
                                  p.b[k][q]);
        o[q] = __fadd_rn(kept(y) ? y : 0.0f, r[k][q]);
      }
      store_chunk<VEC>(out + row * d + c.col[k], aligned, o);
    }
  }
}

// backward, first pass: a partial row [sum gy * xh | sum gy] a block over
// every row it visits, gy = g [y > 0]
template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) batch_norm_relu_residual_bwd_sums_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ sums,
    const T* __restrict__ scale, const T* __restrict__ bias, float* __restrict__ partial,
    int64_t n_rows, int d, float eps, int lanes_log2, bool aligned) {
  __shared__ float red[2 * THREADS * CH * VEC];
  const Cols<VEC, CH> c(lanes_log2, d);
  const ColParams<T, VEC, CH> p(sums, scale, bias, c, d, eps, aligned);
  float as[CH][VEC], ab[CH][VEC];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) as[k][q] = ab[k][q] = 0.0f;
  }
  for (int64_t row = c.first; row < n_rows; row += c.stride) {
    prefetch_row<VEC, CH>(x, c, d, row, n_rows);
    prefetch_row<VEC, CH>(g, c, d, row, n_rows);
    float v[CH][VEC], gg[CH][VEC];
    load_cols<true, VEC, CH>(x + row * d, c, aligned, v);
    load_cols<true, VEC, CH>(g + row * d, c, aligned, gg);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xh = normalize(v[k][q], p.mean[k][q], p.rstd[k][q]);
        const float gy = kept(affine<T>(xh, p.s[k][q], p.b[k][q])) ? gg[k][q] : 0.0f;
        as[k][q] = __fmaf_rn(gy, xh, as[k][q]);
        ab[k][q] = __fadd_rn(ab[k][q], gy);
      }
    }
  }
  block_partial<VEC, CH>(as, ab, c, d, red,
                         partial + static_cast<int64_t>(blockIdx.x) * 2 * d);
}

// backward, second pass: dx over every row from the (all-reduced) column
// sums total = [sum gy * xh | sum gy]
template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) batch_norm_relu_residual_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const uint8_t* __restrict__ mask,
    const float* __restrict__ sums, const T* __restrict__ scale, const T* __restrict__ bias,
    const float* __restrict__ total, T* __restrict__ dx, int64_t n_rows, int d, float eps,
    int lanes_log2, bool aligned) {
  const Cols<VEC, CH> c(lanes_log2, d);
  float n[CH][VEC];
  bool clamped[CH][VEC];
  const ColParams<T, VEC, CH> p(sums, scale, bias, c, d, eps, aligned, n, clamped);
  // A = scale * sum gy, B = scale * sum gy * xh, kc = rstd / n
  float A[CH][VEC], B[CH][VEC], kc[CH][VEC];
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int col = c.in[k] ? c.col[k] + q : 0;
      A[k][q] = __fmul_rn(p.s[k][q], total[d + col]);
      B[k][q] = clamped[k][q] ? 0.0f : __fmul_rn(p.s[k][q], total[col]);
      kc[k][q] = __fdiv_rn(p.rstd[k][q], n[k][q]);
    }
  }
  for (int64_t row = c.first; row < n_rows; row += c.stride) {
    const bool real = mask[row] != 0;
    prefetch_row<VEC, CH>(x, c, d, row, n_rows);
    prefetch_row<VEC, CH>(g, c, d, row, n_rows);
    float v[CH][VEC], gg[CH][VEC];
    load_cols<true, VEC, CH>(x + row * d, c, aligned, v);
    load_cols<true, VEC, CH>(g + row * d, c, aligned, gg);
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (!c.in[k]) continue;
      float o[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xh = normalize(v[k][q], p.mean[k][q], p.rstd[k][q]);
        const float gy = kept(affine<T>(xh, p.s[k][q], p.b[k][q])) ? gg[k][q] : 0.0f;
        const float direct = __fmul_rn(p.rstd[k][q], __fmul_rn(gy, p.s[k][q]));
        o[q] = real ? __fsub_rn(direct, __fmul_rn(kc[k][q], __fadd_rn(A[k][q],
                                                                      __fmul_rn(xh, B[k][q]))))
                    : direct;
      }
      store_chunk<VEC>(dx + row * d + c.col[k], aligned, o);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Plan {
  int vec, lanes_log2, chunks;
};

// The plan the caller computed (ops/norm.py batch_norm_plan), checked: VEC
// elements a chunk (1, or 4 where d allows), a group of 1-256 lanes a row,
// 1, 2 or 4 chunks a lane of at most 16 values.
bool plan_ok(const Plan& p, int d) {
  if (d < 1) return false;
  if (p.vec != 1 && !(p.vec == 4 && d % 4 == 0)) return false;
  if (p.lanes_log2 < 0 || (1 << p.lanes_log2) > THREADS) return false;
  if (p.chunks != 1 && p.chunks != 2 && p.chunks != 4) return false;
  return p.chunks * p.vec <= MAX_VALUES;
}

// column tiles of the plan's layout over a row of d
unsigned col_tiles(const Plan& p, int d) {
  const int64_t tile = static_cast<int64_t>(p.chunks << p.lanes_log2) * p.vec;
  return static_cast<unsigned>((d + tile - 1) / tile);
}

// f(Int<VEC>, Int<CH>) for the plan's instance
template <class F>
cudaError_t with_plan(const Plan& p, F f) {
  using gnnome::Int;
  if (p.vec == 1) {
    switch (p.chunks) {
      case 1: return f(Int<1>{}, Int<1>{});
      case 2: return f(Int<1>{}, Int<2>{});
      default: return f(Int<1>{}, Int<4>{});
    }
  }
  switch (p.chunks) {
    case 1: return f(Int<4>{}, Int<1>{});
    case 2: return f(Int<4>{}, Int<2>{});
    default: return f(Int<4>{}, Int<4>{});
  }
}

// blocks of THREADS a column tile that fill the card once for `kernel`
// over the tiles, no more than the rows need, at most `cap`
template <typename K>
cudaError_t row_blocks(K kernel, int device, int64_t n_rows, int lanes_log2, unsigned tiles,
                       int64_t cap, unsigned* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  const int64_t slots = THREADS >> lanes_log2;
  int64_t blocks = (n_rows + slots - 1) / slots;
  int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) / tiles;
  if (full < 1) full = 1;
  if (blocks > full) blocks = full;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  *grid = static_cast<unsigned>(blocks);
  return cudaSuccess;
}

template <typename T>
int moments(const T* x, const uint8_t* mask, float* partial, float* sums, int64_t n_rows,
            int d, Plan p, int aligned, int max_parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_ok(p, d) || n_rows < 0 || max_parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = col_tiles(p, d);
  unsigned grid = 0;
  err = with_plan(p, [&](auto vec, auto ch) -> cudaError_t {
    constexpr int VEC = decltype(vec)::value, CH = decltype(ch)::value;
    auto kernel = batch_norm_moments_kernel<T, VEC, CH>;
    cudaError_t e = row_blocks(kernel, device, n_rows, p.lanes_log2, tiles, max_parts, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(grid, tiles), THREADS, 0, s>>>(x, mask, partial, n_rows, d, p.lanes_log2,
                                                 aligned != 0);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sum_partials(partial, sums, static_cast<int>(grid), 1 + 2 * static_cast<int64_t>(d), s));
}

template <typename T>
int forward(const T* x, const float* sums, const T* scale, const T* bias, const T* residual,
            T* out, int64_t n_rows, int d, float eps, Plan p, int aligned, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_ok(p, d) || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = col_tiles(p, d);
  err = with_plan(p, [&](auto vec, auto ch) -> cudaError_t {
    constexpr int VEC = decltype(vec)::value, CH = decltype(ch)::value;
    auto kernel = batch_norm_relu_residual_kernel<T, VEC, CH>;
    unsigned grid = 0;
    cudaError_t e = row_blocks(kernel, device, n_rows, p.lanes_log2, tiles, int64_t{1} << 20,
                               &grid);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(grid, tiles), THREADS, 0, s>>>(x, sums, scale, bias, residual, out, n_rows,
                                                 d, eps, p.lanes_log2, aligned != 0);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

template <typename T>
int backward_sums(const T* x, const T* g, const float* sums, const T* scale, const T* bias,
                  float* partial, float* d_affine, int64_t n_rows, int d, float eps, Plan p,
                  int aligned, int max_parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_ok(p, d) || n_rows < 0 || max_parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = col_tiles(p, d);
  unsigned grid = 0;
  err = with_plan(p, [&](auto vec, auto ch) -> cudaError_t {
    constexpr int VEC = decltype(vec)::value, CH = decltype(ch)::value;
    auto kernel = batch_norm_relu_residual_bwd_sums_kernel<T, VEC, CH>;
    cudaError_t e = row_blocks(kernel, device, n_rows, p.lanes_log2, tiles, max_parts, &grid);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(grid, tiles), THREADS, 0, s>>>(x, g, sums, scale, bias, partial, n_rows, d,
                                                 eps, p.lanes_log2, aligned != 0);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      sum_partials(partial, d_affine, static_cast<int>(grid), 2 * static_cast<int64_t>(d), s));
}

template <typename T>
int backward(const T* x, const T* g, const uint8_t* mask, const float* sums, const T* scale,
             const T* bias, const float* total, T* dx, int64_t n_rows, int d, float eps,
             Plan p, int aligned, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_ok(p, d) || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = col_tiles(p, d);
  err = with_plan(p, [&](auto vec, auto ch) -> cudaError_t {
    constexpr int VEC = decltype(vec)::value, CH = decltype(ch)::value;
    auto kernel = batch_norm_relu_residual_bwd_kernel<T, VEC, CH>;
    unsigned grid = 0;
    cudaError_t e = row_blocks(kernel, device, n_rows, p.lanes_log2, tiles, int64_t{1} << 20,
                               &grid);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(grid, tiles), THREADS, 0, s>>>(x, g, mask, sums, scale, bias, total, dx,
                                                 n_rows, d, eps, p.lanes_log2, aligned != 0);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

}  // namespace

// sums = [count | sum x | sum x^2] (f32 [1 + 2d]) over the rows whose mask
// byte is set; the plan (vec, lanes_log2, chunks) of ops/norm.py
// batch_norm_plan; aligned: x's base is 16-byte aligned; partial: f32
// scratch [max_parts, 1 + 2d], one row a block.
GNNOME_API int gnnome_batch_norm_moments_f32(const float* x, const uint8_t* mask,
                                             float* partial, float* sums, int64_t n_rows,
                                             int d, int vec, int lanes_log2, int chunks,
                                             int aligned, int max_parts, int device,
                                             void* stream) {
  return moments(x, mask, partial, sums, n_rows, d, Plan{vec, lanes_log2, chunks}, aligned,
                 max_parts, device, stream);
}

// x bf16, summed in f32
GNNOME_API int gnnome_batch_norm_moments_bf16(const gnnome::bf16* x, const uint8_t* mask,
                                              float* partial, float* sums, int64_t n_rows,
                                              int d, int vec, int lanes_log2, int chunks,
                                              int aligned, int max_parts, int device,
                                              void* stream) {
  return moments(x, mask, partial, sums, n_rows, d, Plan{vec, lanes_log2, chunks}, aligned,
                 max_parts, device, stream);
}

// out = relu(BN(x) * scale + bias) + residual over every row, the statistics
// from sums; aligned: every [R, d] and [d] base is 16-byte aligned
GNNOME_API int gnnome_batch_norm_relu_residual_f32(
    const float* x, const float* sums, const float* scale, const float* bias,
    const float* residual, float* out, int64_t n_rows, int d, float eps, int vec,
    int lanes_log2, int chunks, int aligned, int device, void* stream) {
  return forward(x, sums, scale, bias, residual, out, n_rows, d, eps,
                 Plan{vec, lanes_log2, chunks}, aligned, device, stream);
}

// every [R, d] and [d] tensor bf16, sums f32; computed in f32, the
// BatchNorm's output rounded to bf16 before the ReLU and the sum with the
// residual rounded as it is stored
GNNOME_API int gnnome_batch_norm_relu_residual_bf16(
    const gnnome::bf16* x, const float* sums, const gnnome::bf16* scale,
    const gnnome::bf16* bias, const gnnome::bf16* residual, gnnome::bf16* out,
    int64_t n_rows, int d, float eps, int vec, int lanes_log2, int chunks, int aligned,
    int device, void* stream) {
  return forward(x, sums, scale, bias, residual, out, n_rows, d, eps,
                 Plan{vec, lanes_log2, chunks}, aligned, device, stream);
}

// d_affine = [d_scale | d_bias] (f32 [2, d]) over every row from x, the
// cotangent g and the forward's sums; partial: f32 scratch [max_parts, 2d]
GNNOME_API int gnnome_batch_norm_relu_residual_bwd_sums_f32(
    const float* x, const float* g, const float* sums, const float* scale, const float* bias,
    float* partial, float* d_affine, int64_t n_rows, int d, float eps, int vec,
    int lanes_log2, int chunks, int aligned, int max_parts, int device, void* stream) {
  return backward_sums(x, g, sums, scale, bias, partial, d_affine, n_rows, d, eps,
                       Plan{vec, lanes_log2, chunks}, aligned, max_parts, device, stream);
}

// x, g, scale, bias bf16; the mask from the bf16-rounded BatchNorm output,
// as the forward takes it; sums, partial, d_affine f32
GNNOME_API int gnnome_batch_norm_relu_residual_bwd_sums_bf16(
    const gnnome::bf16* x, const gnnome::bf16* g, const float* sums, const gnnome::bf16* scale,
    const gnnome::bf16* bias, float* partial, float* d_affine, int64_t n_rows, int d,
    float eps, int vec, int lanes_log2, int chunks, int aligned, int max_parts, int device,
    void* stream) {
  return backward_sums(x, g, sums, scale, bias, partial, d_affine, n_rows, d, eps,
                       Plan{vec, lanes_log2, chunks}, aligned, max_parts, device, stream);
}

// dx over every row from x, g, the row mask, the forward's sums and the
// column sums total = [sum gy * xh | sum gy] (all-reduced where sharded)
GNNOME_API int gnnome_batch_norm_relu_residual_bwd_f32(
    const float* x, const float* g, const uint8_t* mask, const float* sums,
    const float* scale, const float* bias, const float* total, float* dx, int64_t n_rows,
    int d, float eps, int vec, int lanes_log2, int chunks, int aligned, int device,
    void* stream) {
  return backward(x, g, mask, sums, scale, bias, total, dx, n_rows, d, eps,
                  Plan{vec, lanes_log2, chunks}, aligned, device, stream);
}

// x, g, scale, bias, dx bf16; dx rounded once
GNNOME_API int gnnome_batch_norm_relu_residual_bwd_bf16(
    const gnnome::bf16* x, const gnnome::bf16* g, const uint8_t* mask, const float* sums,
    const gnnome::bf16* scale, const gnnome::bf16* bias, const float* total,
    gnnome::bf16* dx, int64_t n_rows, int d, float eps, int vec, int lanes_log2, int chunks,
    int aligned, int device, void* stream) {
  return backward(x, g, mask, sums, scale, bias, total, dx, n_rows, d, eps,
                  Plan{vec, lanes_log2, chunks}, aligned, device, stream);
}
