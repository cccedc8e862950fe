// LayerNorm -> ReLU -> residual over the rows of an [R, D] tensor,
//   out = relu(LN(x) * scale + bias) + residual,
// forward and backward: the LayerNorm GatedGCN's edge norm ([E, D]) and
// node norm ([N, D]) with the ReLU and the residual add around each
// (gnnome_tpu_torch/ops/norm.py layer_norm_relu_residual).
//
// Replaces no TPU kernel: the JAX package leaves masked_layer_norm
// (gnnome_tpu/ops/norm.py:58) and the ReLU and residual around it to XLA,
// which fuses them. Run op by op, as PyTorch runs the plain version, each of
// its eight steps is a pass over the whole tensor, and autograd replays the
// chain backward.
//
// Bound on the H100: bytes. At R = 1M rows, D = 256 f32 the forward reads x
// and the residual and writes out (3.07 GB, 0.92 ms at 3.35 TB/s); the
// backward reads x and the cotangent g and writes dx (0.92 ms); bf16 half
// that. A few flops an element.
//
// Design, for one read of each input and one write of each output:
// - A row to a group of 8, 16 or 32 lanes of one warp (the launch plan of
//   ops/norm.py layer_norm_plan, from D alone): each lane holds CH chunks of
//   VEC elements of the row in registers (16-byte accesses where a row is a
//   multiple of 16 bytes), chunk c of the row on lane c % lanes, at most 32
//   values a lane. The mean, then sum (x - mean)^2 from the registers: two
//   passes over registers, as the plain formula takes them (not Welford);
//   shuffles within the group, no shared memory. Then the affine, the ReLU
//   and the residual row, and one store.
// - The forward stores nothing but the output. The backward reads x and g
//   once and recomputes the statistics and the ReLU mask with the same
//   instructions (row_stats and affine below: explicit roundings, nothing
//   left to contraction), so its mask is the forward's bit for bit, and
//   writes dx = rstd * (gx - mean(gx) - xh * mean(gx * xh)) with
//   gx = g * [y > 0] * scale. The residual's gradient is g itself.
// - d_scale = sum g [y > 0] xh and d_bias = sum g [y > 0] over every row
//   (padded rows too, as autograd sums them): each lane sums its own
//   columns over its fixed set of rows in registers; the groups of a warp,
//   then the warps of a block meet in a fixed order and the block writes
//   one partial row; a second kernel adds the partials in a fixed order
//   (no float atomics, so a launch repeats bit for bit).
// - The layout (which lane holds which element) depends on D and the dtype
//   alone; misaligned bases take element loads of the same chunks, so the
//   sums, and the bits, do not depend on where a tensor lies.
// - Rows wider than 32 values a lane (D > 1024; D > 256 where a row is not a
//   multiple of 16 bytes) take a looped instance (CH = 0): a warp a row,
//   passes over the row in global memory (the L1 and L2 hold it), and the
//   backward's column sums in a shared-memory row of the warp's own.
// x, the residual and g are read once and far larger than the L2: they
// stream with ld.global.cs, and out and dx leave with st.global.cs.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
// the looped instance: 4 warps a block, each with a shared row of 2 * D
// column sums (D up to 7264 in 232,448 bytes)
constexpr int LOOP_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// The sum over an aligned group of `lanes` lanes, on every lane of it (an
// xor butterfly: each step adds the same two values on both lanes, so every
// lane ends with the same bits). Every lane of the warp takes part.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

using gnnome::affine;
using gnnome::kept;
using gnnome::load_chunk;
using gnnome::normalize;
using gnnome::store_chunk;

// The row's mean and 1 / sqrt(var + eps) from the lane's partial sums:
// sum x, then sum (x - mean)^2, over the lane's values in chunk order and
// then over the group. `add_sq` adds a lane's squares given the mean.
template <class SumSq>
__device__ __forceinline__ void finish_stats(float sum, SumSq add_sq, int lanes, int d,
                                             float eps, float* mean, float* rstd) {
  const float m = __fdiv_rn(group_sum(sum, lanes), static_cast<float>(d));
  const float var = __fdiv_rn(group_sum(add_sq(m), lanes), static_cast<float>(d));
  *mean = m;
  *rstd = rsqrtf(__fadd_rn(var, eps));
}

// ---------------------------------------------------------------------------
// the register instances: a row to a group of lanes, CH chunks of VEC a lane
// ---------------------------------------------------------------------------

struct Lanes {
  int lanes, sl, slot, slots;
  int64_t first, stride;  // the warp's first row and the step to its next
};

__device__ __forceinline__ Lanes row_lanes(int lanes_log2) {
  Lanes l;
  const int lane = threadIdx.x & 31;
  l.lanes = 1 << lanes_log2;
  l.sl = lane & (l.lanes - 1);
  l.slot = lane >> lanes_log2;
  l.slots = 32 >> lanes_log2;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  l.first = warp * l.slots;
  l.stride = n_warps * l.slots;
  return l;
}

template <int VEC, int CH>
__device__ __forceinline__ void row_stats(const float (&v)[CH][VEC], const bool (&in)[CH],
                                          int lanes, int d, float eps, float* mean,
                                          float* rstd) {
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) sum = __fadd_rn(sum, v[k][q]);
  }
  finish_stats(sum, [&](float m) {
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (!in[k]) continue;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float a = __fsub_rn(v[k][q], m);
        sq = __fmaf_rn(a, a, sq);
      }
    }
    return sq;
  }, lanes, d, eps, mean, rstd);
}

// scale and bias of the lane's columns, zero past the row
template <int VEC, int CH, typename T>
__device__ __forceinline__ void load_affine(const T* scale, const T* bias, const Lanes& l,
                                            int per_row, bool aligned, float (&s)[CH][VEC],
                                            float (&b)[CH][VEC], bool (&in)[CH]) {
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int c = l.sl + k * l.lanes;
    in[k] = c < per_row;
    if (in[k]) {
      load_chunk<VEC, false>(scale + c * VEC, aligned, s[k]);
      load_chunk<VEC, false>(bias + c * VEC, aligned, b[k]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) s[k][q] = b[k][q] = 0.0f;
    }
  }
}

template <int VEC, int CH, typename T>
__device__ __forceinline__ void load_row(const T* row, const Lanes& l, bool live,
                                         const bool (&in)[CH], bool aligned,
                                         float (&v)[CH][VEC]) {
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    if (live && in[k]) {
      load_chunk<VEC, true>(row + (l.sl + k * l.lanes) * VEC, aligned, v[k]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[k][q] = 0.0f;
    }
  }
}

template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) layer_norm_relu_residual_kernel(
    const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
    const T* __restrict__ residual, T* __restrict__ out, int64_t n_rows, int d, float eps,
    int lanes_log2, bool aligned) {
  const Lanes l = row_lanes(lanes_log2);
  const int per_row = d / VEC;
  float s[CH][VEC], b[CH][VEC];
  bool in[CH];
  load_affine<VEC, CH>(scale, bias, l, per_row, aligned, s, b, in);
  // every lane of the warp runs every step (the shuffles take all 32)
  for (int64_t base = l.first; base < n_rows; base += l.stride) {
    const int64_t row = base + l.slot;
    const bool live = row < n_rows;
    float v[CH][VEC], r[CH][VEC];
    load_row<VEC, CH>(x + row * d, l, live, in, aligned, v);
    load_row<VEC, CH>(residual + row * d, l, live, in, aligned, r);
    float mean, rstd;
    row_stats<VEC, CH>(v, in, l.lanes, d, eps, &mean, &rstd);
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (!in[k]) continue;
      float o[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float yb = affine<T>(normalize(v[k][q], mean, rstd), s[k][q], b[k][q]);
        o[q] = __fadd_rn(kept(yb) ? yb : 0.0f, r[k][q]);
      }
      store_chunk<VEC>(out + row * d + (l.sl + k * l.lanes) * VEC, aligned, o);
    }
  }
}

// The block's column sums [d_scale | d_bias] from each lane's: over the
// groups of a warp (xor over the slot bits), then over the warps in order
// through shared memory, into the block's partial row.
template <int VEC, int CH>
__device__ __forceinline__ void block_partial(float (&as)[CH][VEC], float (&ab)[CH][VEC],
                                              const Lanes& l, const bool (&in)[CH], int d,
                                              float* red, float* partial) {
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      for (int o = l.lanes; o < 32; o <<= 1) {
        as[k][q] = __fadd_rn(as[k][q], __shfl_xor_sync(FULL, as[k][q], o));
        ab[k][q] = __fadd_rn(ab[k][q], __shfl_xor_sync(FULL, ab[k][q], o));
      }
    }
  }
  const int warp = threadIdx.x >> 5;
  if (l.slot == 0) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (!in[k]) continue;
      const int c = (l.sl + k * l.lanes) * VEC;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        red[warp * 2 * d + c + q] = as[k][q];
        red[warp * 2 * d + d + c + q] = ab[k][q];
      }
    }
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int col = threadIdx.x; col < 2 * d; col += blockDim.x) {
    float t = 0.0f;
    for (int w = 0; w < warps; ++w) t = __fadd_rn(t, red[w * 2 * d + col]);
    partial[(int64_t)blockIdx.x * 2 * d + col] = t;
  }
}

template <typename T, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) layer_norm_relu_residual_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ scale,
    const T* __restrict__ bias, T* __restrict__ dx, float* __restrict__ partial,
    int64_t n_rows, int d, float eps, int lanes_log2, bool aligned) {
  extern __shared__ float red[];  // [warps][2 * d]
  const Lanes l = row_lanes(lanes_log2);
  const int per_row = d / VEC;
  float s[CH][VEC], b[CH][VEC], as[CH][VEC], ab[CH][VEC];
  bool in[CH];
  load_affine<VEC, CH>(scale, bias, l, per_row, aligned, s, b, in);
#pragma unroll
  for (int k = 0; k < CH; ++k) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) as[k][q] = ab[k][q] = 0.0f;
  }
  const float inv_d = 1.0f / static_cast<float>(d);
  for (int64_t base = l.first; base < n_rows; base += l.stride) {
    const int64_t row = base + l.slot;
    const bool live = row < n_rows;
    float v[CH][VEC], gg[CH][VEC];
    load_row<VEC, CH>(x + row * d, l, live, in, aligned, v);
    load_row<VEC, CH>(g + row * d, l, live, in, aligned, gg);
    float mean, rstd;
    row_stats<VEC, CH>(v, in, l.lanes, d, eps, &mean, &rstd);
    // v becomes xh and gg becomes gx = g [y > 0] scale
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xh = normalize(v[k][q], mean, rstd);
        const float gy = kept(affine<T>(xh, s[k][q], b[k][q])) ? gg[k][q] : 0.0f;
        as[k][q] = __fmaf_rn(gy, xh, as[k][q]);
        ab[k][q] = __fadd_rn(ab[k][q], gy);
        const float gx = __fmul_rn(gy, s[k][q]);
        s1 = __fadd_rn(s1, gx);
        s2 = __fmaf_rn(gx, xh, s2);
        v[k][q] = xh;
        gg[k][q] = gx;
      }
    }
    const float m1 = __fmul_rn(group_sum(s1, l.lanes), inv_d);
    const float m2 = __fmul_rn(group_sum(s2, l.lanes), inv_d);
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (!in[k]) continue;
      float o[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        o[q] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(gg[k][q], m1), __fmul_rn(v[k][q], m2)));
      store_chunk<VEC>(dx + row * d + (l.sl + k * l.lanes) * VEC, aligned, o);
    }
  }
  block_partial<VEC, CH>(as, ab, l, in, d, red, partial);
}

// ---------------------------------------------------------------------------
// the looped instances (CH = 0): a warp a row, passes over global memory
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__device__ __forceinline__ void looped_stats(const T* xr, int per_row, int d, float eps,
                                             bool aligned, float* mean, float* rstd) {
  const int lane = threadIdx.x & 31;
  float sum = 0.0f;
  for (int c = lane; c < per_row; c += 32) {
    float v[VEC];
    load_chunk<VEC, false>(xr + c * VEC, aligned, v);
#pragma unroll
    for (int q = 0; q < VEC; ++q) sum = __fadd_rn(sum, v[q]);
  }
  finish_stats(sum, [&](float m) {
    float sq = 0.0f;
    for (int c = lane; c < per_row; c += 32) {
      float v[VEC];
      load_chunk<VEC, false>(xr + c * VEC, aligned, v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float a = __fsub_rn(v[q], m);
        sq = __fmaf_rn(a, a, sq);
      }
    }
    return sq;
  }, 32, d, eps, mean, rstd);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(LOOP_THREADS) layer_norm_relu_residual_looped_kernel(
    const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
    const T* __restrict__ residual, T* __restrict__ out, int64_t n_rows, int d, float eps,
    bool aligned) {
  const int lane = threadIdx.x & 31;
  const int per_row = d / VEC;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t row = warp; row < n_rows; row += n_warps) {
    const T* xr = x + row * d;
    float mean, rstd;
    looped_stats<T, VEC>(xr, per_row, d, eps, aligned, &mean, &rstd);
    for (int c = lane; c < per_row; c += 32) {
      float v[VEC], s[VEC], b[VEC], r[VEC], o[VEC];
      load_chunk<VEC, false>(xr + c * VEC, aligned, v);
      load_chunk<VEC, false>(scale + c * VEC, aligned, s);
      load_chunk<VEC, false>(bias + c * VEC, aligned, b);
      load_chunk<VEC, true>(residual + row * d + c * VEC, aligned, r);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float yb = affine<T>(normalize(v[q], mean, rstd), s[q], b[q]);
        o[q] = __fadd_rn(kept(yb) ? yb : 0.0f, r[q]);
      }
      store_chunk<VEC>(out + row * d + c * VEC, aligned, o);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(LOOP_THREADS) layer_norm_relu_residual_bwd_looped_kernel(
    const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ scale,
    const T* __restrict__ bias, T* __restrict__ dx, float* __restrict__ partial,
    int64_t n_rows, int d, float eps, bool aligned) {
  extern __shared__ float red[];  // [warps][2 * d]: the warp's column sums
  const int lane = threadIdx.x & 31;
  const int per_row = d / VEC;
  float* acc = red + (threadIdx.x >> 5) * 2 * d;
  for (int col = lane; col < 2 * d; col += 32) acc[col] = 0.0f;
  __syncwarp();  // a column is zeroed and then summed by different lanes
  const float inv_d = 1.0f / static_cast<float>(d);
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t row = warp; row < n_rows; row += n_warps) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float mean, rstd;
    looped_stats<T, VEC>(xr, per_row, d, eps, aligned, &mean, &rstd);
    // the row's sums of gx and gx * xh, and the lane's own column sums
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < per_row; c += 32) {
      float v[VEC], gg[VEC], s[VEC], b[VEC];
      load_chunk<VEC, false>(xr + c * VEC, aligned, v);
      load_chunk<VEC, false>(gr + c * VEC, aligned, gg);
      load_chunk<VEC, false>(scale + c * VEC, aligned, s);
      load_chunk<VEC, false>(bias + c * VEC, aligned, b);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xh = normalize(v[q], mean, rstd);
        const float gy = kept(affine<T>(xh, s[q], b[q])) ? gg[q] : 0.0f;
        acc[c * VEC + q] = __fmaf_rn(gy, xh, acc[c * VEC + q]);
        acc[d + c * VEC + q] = __fadd_rn(acc[d + c * VEC + q], gy);
        const float gx = __fmul_rn(gy, s[q]);
        s1 = __fadd_rn(s1, gx);
        s2 = __fmaf_rn(gx, xh, s2);
      }
    }
    const float m1 = __fmul_rn(group_sum(s1, 32), inv_d);
    const float m2 = __fmul_rn(group_sum(s2, 32), inv_d);
    for (int c = lane; c < per_row; c += 32) {
      float v[VEC], gg[VEC], s[VEC], b[VEC], o[VEC];
      load_chunk<VEC, false>(xr + c * VEC, aligned, v);
      load_chunk<VEC, false>(gr + c * VEC, aligned, gg);
      load_chunk<VEC, false>(scale + c * VEC, aligned, s);
      load_chunk<VEC, false>(bias + c * VEC, aligned, b);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xh = normalize(v[q], mean, rstd);
        const float gy = kept(affine<T>(xh, s[q], b[q])) ? gg[q] : 0.0f;
        o[q] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(__fmul_rn(gy, s[q]), m1),
                                         __fmul_rn(xh, m2)));
      }
      store_chunk<VEC>(dx + row * d + c * VEC, aligned, o);
    }
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int col = threadIdx.x; col < 2 * d; col += blockDim.x) {
    float t = 0.0f;
    for (int w = 0; w < warps; ++w) t = __fadd_rn(t, red[w * 2 * d + col]);
    partial[(int64_t)blockIdx.x * 2 * d + col] = t;
  }
}

__global__ void __launch_bounds__(256) ln_affine_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ d_affine, int n_parts, int d) {
  gnnome::reduce_partials(partial, d_affine, n_parts, 2 * static_cast<int64_t>(d));
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Plan {
  int vec, lanes_log2, chunks;
};

// The plan the caller computed (ops/norm.py layer_norm_plan), checked: VEC
// elements a chunk (1, or 16 bytes where d allows), a group of 8-32 lanes
// whose CH chunks cover the row, at most 32 values a lane; CH = 0 loops.
template <typename T>
bool plan_ok(const Plan& p, int d) {
  if (d < 1) return false;
  if (p.vec != 1 && !(p.vec == gnnome::VEC16<T> && d % p.vec == 0)) return false;
  if (p.chunks == 0) return 2 * static_cast<int64_t>(d) * 4 * (LOOP_THREADS / 32) <= 232448;
  if (p.lanes_log2 < 3 || p.lanes_log2 > 5) return false;
  if (p.chunks != 1 && p.chunks != 2 && p.chunks != 4 && p.chunks != 8) return false;
  return p.chunks * p.vec <= 32 && (p.chunks << p.lanes_log2) * p.vec >= d;
}

// f(Int<VEC>, Int<CH>) for the plan's instance (CH = 0: the looped one)
template <typename T, class F>
cudaError_t with_plan(const Plan& p, F f) {
  constexpr int V = gnnome::VEC16<T>;
  using gnnome::Int;
  if (p.vec == 1) {
    switch (p.chunks) {
      case 0: return f(Int<1>{}, Int<0>{});
      case 1: return f(Int<1>{}, Int<1>{});
      case 2: return f(Int<1>{}, Int<2>{});
      case 4: return f(Int<1>{}, Int<4>{});
      default: return f(Int<1>{}, Int<8>{});
    }
  }
  switch (p.chunks) {
    case 0: return f(Int<V>{}, Int<0>{});
    case 1: return f(Int<V>{}, Int<1>{});
    case 2: return f(Int<V>{}, Int<2>{});
    case 4: return f(Int<V>{}, Int<4>{});
    default:
      if constexpr (V * 8 <= 32) return f(Int<V>{}, Int<8>{});
      return cudaErrorInvalidValue;
  }
}

// blocks of `threads` that fill the card once for `kernel`, no more than
// the rows need, at most `cap`
template <typename K>
cudaError_t full_grid(K kernel, int threads, size_t smem, int device, int64_t n_rows,
                      int64_t rows_per_block, int64_t cap, unsigned* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const int64_t full = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > full) blocks = full;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  *grid = static_cast<unsigned>(blocks);
  return cudaSuccess;
}

template <typename T>
int forward(const T* x, const T* scale, const T* bias, const T* residual, T* out,
            int64_t n_rows, int d, float eps, Plan p, int aligned, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_ok<T>(p, d) || n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
  err = with_plan<T>(p, [&](auto vec, auto ch) -> cudaError_t {
    constexpr int VEC = decltype(vec)::value, CH = decltype(ch)::value;
    unsigned grid = 0;
    if constexpr (CH == 0) {
      auto kernel = layer_norm_relu_residual_looped_kernel<T, VEC>;
      cudaError_t e = full_grid(kernel, LOOP_THREADS, 0, device, n_rows, LOOP_THREADS / 32,
                                int64_t{1} << 20, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, LOOP_THREADS, 0, s>>>(x, scale, bias, residual, out, n_rows, d, eps, al);
    } else {
      auto kernel = layer_norm_relu_residual_kernel<T, VEC, CH>;
      const int64_t rows_per_block = (THREADS / 32) * (32 >> p.lanes_log2);
      cudaError_t e = full_grid(kernel, THREADS, 0, device, n_rows, rows_per_block,
                                int64_t{1} << 20, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, THREADS, 0, s>>>(x, scale, bias, residual, out, n_rows, d, eps,
                                      p.lanes_log2, al);
    }
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

template <typename T>
int backward(const T* x, const T* g, const T* scale, const T* bias, T* dx, float* partial,
             float* d_affine, int64_t n_rows, int d, float eps, Plan p, int aligned,
             int max_parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!plan_ok<T>(p, d) || n_rows < 0 || max_parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
  unsigned grid = 0;
  err = with_plan<T>(p, [&](auto vec, auto ch) -> cudaError_t {
    constexpr int VEC = decltype(vec)::value, CH = decltype(ch)::value;
    if constexpr (CH == 0) {
      auto kernel = layer_norm_relu_residual_bwd_looped_kernel<T, VEC>;
      const size_t smem = sizeof(float) * 2 * d * (LOOP_THREADS / 32);
      cudaError_t e = gnnome::allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      e = full_grid(kernel, LOOP_THREADS, smem, device, n_rows, LOOP_THREADS / 32, max_parts,
                    &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, LOOP_THREADS, smem, s>>>(x, g, scale, bias, dx, partial, n_rows, d, eps,
                                              al);
    } else {
      auto kernel = layer_norm_relu_residual_bwd_kernel<T, VEC, CH>;
      const size_t smem = sizeof(float) * 2 * d * (THREADS / 32);
      cudaError_t e = gnnome::allow_smem(kernel, smem);
      if (e != cudaSuccess) return e;
      const int64_t rows_per_block = (THREADS / 32) * (32 >> p.lanes_log2);
      e = full_grid(kernel, THREADS, smem, device, n_rows, rows_per_block, max_parts, &grid);
      if (e != cudaSuccess) return e;
      kernel<<<grid, THREADS, smem, s>>>(x, g, scale, bias, dx, partial, n_rows, d, eps,
                                         p.lanes_log2, al);
    }
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_affine_reduce_kernel<<<(2 * d + 31) / 32, 256, 0, s>>>(partial, d_affine,
                                                           static_cast<int>(grid), d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = relu(LN(x) * scale + bias) + residual over rows of d; the plan
// (vec, lanes_log2, chunks) of ops/norm.py layer_norm_plan; aligned: every
// base is 16-byte aligned (the plan's 16-byte chunks may load as one).
GNNOME_API int gnnome_layer_norm_relu_residual_f32(
    const float* x, const float* scale, const float* bias, const float* residual, float* out,
    int64_t n_rows, int d, float eps, int vec, int lanes_log2, int chunks, int aligned,
    int device, void* stream) {
  return forward(x, scale, bias, residual, out, n_rows, d, eps, Plan{vec, lanes_log2, chunks},
                 aligned, device, stream);
}

// every tensor bf16; computed in f32, the LayerNorm's output rounded to bf16
// before the ReLU and the sum with the residual rounded as it is stored
GNNOME_API int gnnome_layer_norm_relu_residual_bf16(
    const gnnome::bf16* x, const gnnome::bf16* scale, const gnnome::bf16* bias,
    const gnnome::bf16* residual, gnnome::bf16* out, int64_t n_rows, int d, float eps,
    int vec, int lanes_log2, int chunks, int aligned, int device, void* stream) {
  return forward(x, scale, bias, residual, out, n_rows, d, eps, Plan{vec, lanes_log2, chunks},
                 aligned, device, stream);
}

// dx and d_affine = [d_scale | d_bias] (f32 [2, d]) from x and the
// cotangent g; partial: f32 scratch [max_parts, 2, d], one row a block.
GNNOME_API int gnnome_layer_norm_relu_residual_bwd_f32(
    const float* x, const float* g, const float* scale, const float* bias, float* dx,
    float* partial, float* d_affine, int64_t n_rows, int d, float eps, int vec,
    int lanes_log2, int chunks, int aligned, int max_parts, int device, void* stream) {
  return backward(x, g, scale, bias, dx, partial, d_affine, n_rows, d, eps,
                  Plan{vec, lanes_log2, chunks}, aligned, max_parts, device, stream);
}

// x, g, scale, bias, dx bf16; the mask from the bf16-rounded LayerNorm
// output, as the forward takes it; dx rounded once; partial, d_affine f32
GNNOME_API int gnnome_layer_norm_relu_residual_bwd_bf16(
    const gnnome::bf16* x, const gnnome::bf16* g, const gnnome::bf16* scale,
    const gnnome::bf16* bias, gnnome::bf16* dx, float* partial, float* d_affine,
    int64_t n_rows, int d, float eps, int vec, int lanes_log2, int chunks, int aligned,
    int max_parts, int device, void* stream) {
  return backward(x, g, scale, bias, dx, partial, d_affine, n_rows, d, eps,
                  Plan{vec, lanes_log2, chunks}, aligned, max_parts, device, stream);
}
