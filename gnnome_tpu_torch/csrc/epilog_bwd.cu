// Backward of the GatedGCN gate epilog with the forward aggregation
// (csrc/gate_epilog.cu). Per canonical edge k, with gc = g_sums[dst[k]]
// = [g1 || g2] (a zero row for padded edges) and vals = values[src[k]]
// (epilog_bwd) or the pregathered row vals[k] (epilog_bwd_pregathered):
//   pre     = gate_raw[k] * scale2 + bias2          (recomputed)
//   s       = sigmoid(e_new[k])
//   d_enew  = g_enew[k] + (g1 * vals + g2) * s * (1 - s)
//   d_pre   = d_enew * [pre > 0]
// it writes d_gate_raw = d_pre * scale2, d_e_in = d_enew, d_vals = g1 * s,
// and d_affine = [sum_k d_pre * gate_raw || sum_k d_pre] over all rows
// (padded rows included, as the JAX VJP sums them). For epilog_bwd, d_values
// is then the by_src segment sum of d_vals (csrc/segment_sum.cu); for the
// pregathered entry d_vals is the gradient of the pregathered rows (the
// gather's own backward sums them).
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:epilog_bwd_pallas (epilog_bwd; one
// call per GatedGCN layer, 16 per training step) and the XLA VJP of
// fused_gate_sigma_aggregate (gnnome_tpu/ops/segment.py:_fused_gate_bwd, the
// backward of fused_gate_sigma_aggregate_pallas; epilog_bwd_pregathered).
//
// Bound on the H100: bytes. At E = 1M, D = 256, N = 150k: gate_raw, e_new
// and g_enew read (3.07 GB), three [E, D] outputs written (3.07 GB), the
// g_sums (307 MB) and values (154 MB) tables, ids and offsets (5 MB):
// about 6.6 GB, 2.0 ms at 3.35 TB/s; with pregathered rows (1.02 GB) in
// place of the values table, about 7.5 GB, 2.2 ms. One exp per element.
//
// Design: one warp per destination row of by_dst (canonical order is
// dst-sorted, so a row's edges are contiguous), each lane 4 consecutive
// columns (16-byte accesses) per 128-column slice: the row's g_sums slice
// is loaded once and held in registers while the warp walks its edges, as
// the forward kernel does. The row's d_affine contribution is summed in
// registers and added to the warp's own column sums in shared memory, so
// no two threads ever add to one address. A fixed grid of blocks walks the
// rows in a fixed order; each block leaves one partial [2, D] row and a
// second kernel adds the partials in a fixed order: deterministic, no
// float atomics. Padded edges (past offsets[N]) belong to no row; they
// form one extra row with a zero g_sums, so the same loop writes their
// outputs and adds them to d_affine. `pre` is rounded as the forward kernel
// rounds it (gnnome::bn_affine), so the ReLU's mask is the forward's own.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// GATHER: the value row of edge k is values[src[k]], else vals[k]
template <int VEC, bool GATHER>
__device__ __forceinline__ void epilog_bwd_rows(
    const float* __restrict__ gate_raw, const float* __restrict__ e_new,
    const float* __restrict__ g_enew, const float* __restrict__ g_sums,
    const float* __restrict__ values, const float* __restrict__ affine,
    const int* __restrict__ offsets, const int* __restrict__ src,
    float* __restrict__ d_gate_raw, float* __restrict__ d_e_in,
    float* __restrict__ d_vals, float* __restrict__ partial, int64_t n_nodes,
    int64_t n_rows, int d) {
  extern __shared__ float red[];  // [WARPS][2][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = red + (int64_t)warp * 2 * d;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      mine[c + q] = 0.0f;
      mine[d + c + q] = 0.0f;
    }
  }
  const int64_t n_warps = (int64_t)gridDim.x * WARPS;
  // rows 0..n_nodes-1 are the destination nodes; row n_nodes is the tail
  // of padded edges [offsets[n_nodes], n_rows)
  for (int64_t v = (int64_t)blockIdx.x * WARPS + warp; v <= n_nodes; v += n_warps) {
    const bool tail = v == n_nodes;
    const int64_t beg = offsets[v];
    const int64_t end = tail ? n_rows : offsets[v + 1];
    if (beg >= end) continue;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float sc[VEC], bi[VEC], g1[VEC] = {}, g2[VEC] = {};
      gnnome::load_vec<VEC>(affine + c, sc);
      gnnome::load_vec<VEC>(affine + d + c, bi);
      if (!tail) {
        gnnome::load_vec<VEC>(g_sums + v * 2 * d + c, g1);
        gnnome::load_vec<VEC>(g_sums + v * 2 * d + d + c, g2);
      }
      float ds[VEC] = {}, db[VEC] = {};
      for (int64_t k = beg; k < end; ++k) {
        const int64_t so = (GATHER ? (int64_t)src[k] : k) * d;
        float gr[VEC], en[VEC], ge[VEC], val[VEC];
        float o_gr[VEC], o_en[VEC], o_v[VEC];
        gnnome::load_vec<VEC>(gate_raw + k * d + c, gr);
        gnnome::load_vec<VEC>(e_new + k * d + c, en);
        gnnome::load_vec<VEC>(g_enew + k * d + c, ge);
        gnnome::load_vec<VEC>(values + so + c, val);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float pre = gnnome::bn_affine(gr[q], sc[q], bi[q]);
          const float s = gnnome::sigmoid(en[q]);
          const float d_en = ge[q] + (g1[q] * val[q] + g2[q]) * (s * (1.0f - s));
          const float d_pre = pre > 0.0f ? d_en : 0.0f;
          o_gr[q] = d_pre * sc[q];
          o_en[q] = d_en;
          o_v[q] = g1[q] * s;
          ds[q] += d_pre * gr[q];
          db[q] += d_pre;
        }
        gnnome::store_vec<VEC>(d_gate_raw + k * d + c, o_gr);
        gnnome::store_vec<VEC>(d_e_in + k * d + c, o_en);
        gnnome::store_vec<VEC>(d_vals + k * d + c, o_v);
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        mine[c + q] += ds[q];
        mine[d + c + q] += db[q];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * d; i += THREADS) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += red[(int64_t)w * 2 * d + i];
    partial[(int64_t)blockIdx.x * 2 * d + i] = s;
  }
}

#define EPILOG_BWD_KERNEL(NAME, GATHER)                                                 \
  template <int VEC>                                                                   \
  __global__ void __launch_bounds__(THREADS) NAME(                                     \
      const float* __restrict__ gate_raw, const float* __restrict__ e_new,             \
      const float* __restrict__ g_enew, const float* __restrict__ g_sums,              \
      const float* __restrict__ values, const float* __restrict__ affine,              \
      const int* __restrict__ offsets, const int* __restrict__ src,                    \
      float* __restrict__ d_gate_raw, float* __restrict__ d_e_in,                      \
      float* __restrict__ d_vals, float* __restrict__ partial, int64_t n_nodes,        \
      int64_t n_rows, int d) {                                                         \
    epilog_bwd_rows<VEC, GATHER>(gate_raw, e_new, g_enew, g_sums, values, affine,      \
                                 offsets, src, d_gate_raw, d_e_in, d_vals, partial,    \
                                 n_nodes, n_rows, d);                                  \
  }

EPILOG_BWD_KERNEL(epilog_bwd_kernel, true)
EPILOG_BWD_KERNEL(epilog_bwd_pregathered_kernel, false)

__global__ void __launch_bounds__(256) affine_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ d_affine, int n_parts,
    int d) {
  gnnome::reduce_partials(partial, d_affine, n_parts, 2 * (int64_t)d);
}

template <int VEC>
int launch(const float* gate_raw, const float* e_new, const float* g_enew,
           const float* g_sums, const float* values, const float* affine,
           const int* offsets, const int* src, float* d_gate_raw, float* d_e_in,
           float* d_vals, float* partial, float* d_affine, int64_t n_nodes,
           int64_t n_rows, int d, int n_parts, cudaStream_t s) {
  const size_t smem = sizeof(float) * WARPS * 2 * d;
  cudaError_t err;
  if (src != nullptr) {
    err = gnnome::allow_smem(epilog_bwd_kernel<VEC>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    epilog_bwd_kernel<VEC><<<n_parts, THREADS, smem, s>>>(
        gate_raw, e_new, g_enew, g_sums, values, affine, offsets, src, d_gate_raw,
        d_e_in, d_vals, partial, n_nodes, n_rows, d);
  } else {
    err = gnnome::allow_smem(epilog_bwd_pregathered_kernel<VEC>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    epilog_bwd_pregathered_kernel<VEC><<<n_parts, THREADS, smem, s>>>(
        gate_raw, e_new, g_enew, g_sums, values, affine, offsets, src, d_gate_raw,
        d_e_in, d_vals, partial, n_nodes, n_rows, d);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  affine_reduce_kernel<<<(2 * d + 31) / 32, 256, 0, s>>>(partial, d_affine,
                                                          n_parts, d);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* gate_raw, const float* e_new, const float* g_enew,
             const float* g_sums, const float* values, const float* affine,
             const int* offsets, const int* src, float* d_gate_raw, float* d_e_in,
             float* d_vals, float* partial, float* d_affine, int64_t n_nodes,
             int64_t n_rows, int d, int n_parts, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<4>(gate_raw, e_new, g_enew, g_sums, values, affine, offsets,
                          src, d_gate_raw, d_e_in, d_vals, partial, d_affine,
                          n_nodes, n_rows, d, n_parts, s)
              : launch<1>(gate_raw, e_new, g_enew, g_sums, values, affine, offsets,
                          src, d_gate_raw, d_e_in, d_vals, partial, d_affine,
                          n_nodes, n_rows, d, n_parts, s);
}

}  // namespace

// partial: scratch f32 [n_parts, 2, d]; n_parts blocks walk the rows.
GNNOME_API int gnnome_epilog_bwd_f32(
    const float* gate_raw, const float* e_new, const float* g_enew,
    const float* g_sums, const float* values, const float* affine,
    const int* offsets, const int* src, float* d_gate_raw, float* d_e_in,
    float* d_vals, float* partial, float* d_affine, int64_t n_nodes,
    int64_t n_rows, int d, int n_parts, int vec4, int device, void* stream) {
  if (src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(gate_raw, e_new, g_enew, g_sums, values, affine, offsets, src,
                  d_gate_raw, d_e_in, d_vals, partial, d_affine, n_nodes, n_rows, d,
                  n_parts, vec4, device, stream);
}

// vals: [n_rows, d], one pregathered value row per canonical edge
GNNOME_API int gnnome_epilog_bwd_pregathered_f32(
    const float* gate_raw, const float* e_new, const float* g_enew,
    const float* g_sums, const float* vals, const float* affine,
    const int* offsets, float* d_gate_raw, float* d_e_in, float* d_vals,
    float* partial, float* d_affine, int64_t n_nodes, int64_t n_rows, int d,
    int n_parts, int vec4, int device, void* stream) {
  return dispatch(gate_raw, e_new, g_enew, g_sums, vals, affine, offsets, nullptr,
                  d_gate_raw, d_e_in, d_vals, partial, d_affine, n_nodes, n_rows, d,
                  n_parts, vec4, device, stream);
}
