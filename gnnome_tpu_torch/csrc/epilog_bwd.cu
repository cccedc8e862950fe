// Backward of the GatedGCN gate epilog with the forward aggregation
// (csrc/gate_epilog.cu). Per canonical edge k, with gc = g_sums[key[k]]
// = [g1 || g2] (a zero row where key[k] is PAD_SEGMENT: a padded edge) and
// vals = values[src[k]] (epilog_bwd) or the pregathered row vals[k]
// (epilog_bwd_pregathered):
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
// g_sums (307 MB) and values (154 MB) tables, key and src (8 MB): about
// 6.6 GB, 2.0 ms at 3.35 TB/s; with pregathered rows (1.02 GB) in place of
// the values table, about 7.5 GB, 2.2 ms; the bf16 entries move their
// [E, D] data and values in half the bytes, about 3.4 GB, 1.0 ms (gather)
// or 3.9 GB, 1.2 ms (pregathered). One exp per element.
//
// The bf16 pregathered entry (the VJP of fused_gate_sigma_aggregate_pallas
// under bf16) reads e_in where the others read e_new and recomputes the
// f32 e_new = relu(pre) + e_in, as _fused_gate_bwd does: its forward took
// sigma of the unrounded f32 e_new. In f32 the saved e_new is the same bits,
// so the f32 entries read it.
//
// Design: an edge-balanced walk, as the TPU kernel's fixed chunks of edges
// (gnnome::edge_walker, csrc/common.cuh). A walker (a lane group of one
// warp, 32 lanes at D = 256) takes every W-th tile of 4 canonical
// positions, so a ClusterGCN piece's padded tail and a hub row spread over
// as many walkers as their edges need, and the walkers that run at once
// gather value rows from one window of the table, which stays in the L2.
// A position's row is key[k]: the walker holds the g_sums slice of the
// current key in registers and loads the next one only where the key
// changes, in the same round of loads as that edge's rows; a PAD_SEGMENT
// key reads as a zero row, and its e_new and value rows are not loaded. Each lane owns
// CH chunks of 4 columns (16-byte accesses) of the whole row, so the ids
// are read once per edge (one id per lane, the next tile's in flight,
// handed out with shuffles), and issues the loads of R = 2 edges before
// the first one's stores. The three [E, D] outputs are written with
// streaming stores (st.global.cs), each written once and 40x the L2; the
// [E, D] inputs are read with streaming loads where the values are a table
// to keep in the L2, and with plain loads where they are pregathered rows.
// d_affine is summed in registers over the walker's tiles, then over the
// lane groups of a warp with shuffles and over the warps of a block in
// shared memory, each in a fixed order; each block leaves one partial
// [2, D] row and a second kernel adds the partials in a fixed order:
// deterministic (two calls agree bit for bit), no float atomics, no work
// counter. `pre` is rounded as the forward kernel rounds it
// (gnnome::bn_affine), so the ReLU's mask is the forward's own.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int64_t MIN_SPAN = 32;  // positions a walker takes at least
constexpr unsigned FULL = 0xffffffffu;
// edges in flight per walker (1, 2 and 4 tried; PERF.md section 6)
constexpr int R = 2;

// GATHER: the value row of edge k is values[src[k]] (a node table), else
// vals[k] (pregathered, read once). CH: chunks of VEC elements of a row per
// lane. T: the stored type of the [E, D] data, the values and the three
// outputs (float, or bf16 for the bf16 entry: g_sums is rounded to bf16 as
// it is loaded, as the JAX VJP casts the cotangent to the edge dtype, and
// the outputs are rounded as they are stored); g_sums, affine and d_affine
// are f32, and d_affine sums the unrounded f32 d_pre. RECOMPUTE (the bf16
// pregathered entry): `e_new` holds e_in, and sigma is taken of
// relu(pre) + e_in in f32.
template <typename T, int VEC, int CH, bool GATHER>
__device__ __forceinline__ void epilog_bwd_walk(
    const T* __restrict__ gate_raw, const T* __restrict__ e_new,
    const T* __restrict__ g_enew, const float* __restrict__ g_sums,
    const T* __restrict__ values, const float* __restrict__ affine,
    const int* __restrict__ key, const int* __restrict__ src,
    T* __restrict__ d_gate_raw, T* __restrict__ d_e_in,
    T* __restrict__ d_vals, float* __restrict__ partial, int64_t n_nodes,
    int64_t n_rows, int d, int lanes_log2) {
  constexpr bool CS = GATHER;  // streaming loads beside a table gather
  constexpr bool RECOMPUTE = !GATHER && gnnome::is_bf16<T>;
  extern __shared__ float red[];  // [WARPS][2][d]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const gnnome::Walker w = gnnome::edge_walker(lanes_log2);
  const int per_row = d / VEC;  // chunks in a row
  float* mine = red + (int64_t)warp * 2 * d;
  for (int i = lane; i < 2 * d; i += 32) mine[i] = 0.0f;
  __syncwarp();

  // one pass over the walker's tiles per CH * lanes chunks of the row (one
  // pass for rows of up to 128 chunks: D <= 512 in f32, 1024 in bf16);
  // `base` is alike on every lane of the warp
  for (int base = 0; base < per_row; base += w.lanes * CH) {
    bool has[CH];
    int col[CH];
    float sc[CH][VEC], bi[CH][VEC], ds[CH][VEC], db[CH][VEC];
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int c = base + w.sl + q * w.lanes;
      has[q] = c < per_row;
      col[q] = c * VEC;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        sc[q][v] = bi[q][v] = ds[q][v] = db[q][v] = 0.0f;
      }
      if (has[q]) {
        gnnome::load_vec<VEC>(affine + col[q], sc[q]);
        gnnome::load_vec<VEC>(affine + d + col[q], bi[q]);
      }
    }
    unsigned cur = ~0u;  // the key whose g_sums slice gc1, gc2 hold
    float gc1[CH][VEC] = {}, gc2[CH][VEC] = {};
    // the ids of a tile's positions, one position per lane; those of the
    // next tile are in flight while this one is walked
    unsigned nx_key = ~0u;
    int nx_src = 0;
    auto fetch = [&](int64_t t) {
      const int64_t jm = t + w.sl;
      const bool live = w.sl < w.tile && jm < n_rows;
      nx_key = live ? static_cast<unsigned>(key[jm]) : ~0u;
      nx_src = GATHER && live ? src[jm] : 0;
    };
    fetch(w.first);
    for (int64_t t0 = w.first; t0 < n_rows; t0 += w.stride) {
      const int n_t = static_cast<int>(n_rows - t0 < w.tile ? n_rows - t0 : w.tile);
      const unsigned my_key = nx_key;
      const int my_src = nx_src;
      fetch(t0 + w.stride);
      for (int i0 = 0; i0 < n_t; i0 += R) {  // alike on every lane of the group
        unsigned kr[R];
        int64_t vr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned k = gnnome::tile_take(w, my_key, (i0 + r) & (w.tile - 1));
          kr[r] = i0 + r < n_t ? k : ~0u;
          vr[r] = GATHER ? gnnome::tile_take(w, my_src, (i0 + r) & (w.tile - 1)) : 0;
        }
        float gr[R][CH][VEC], en[R][CH][VEC], ge[R][CH][VEC], val[R][CH][VEC];
        float g1[R][CH][VEC], g2[R][CH][VEC];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int64_t j = t0 + i0 + r;
          const bool live = i0 + r < n_t;
          // the g_sums slice of this edge's key: loaded only where the key
          // changes, and in the same round of loads as the edge's rows
          const unsigned prev = r == 0 ? cur : kr[r - 1];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              gr[r][q][v] = en[r][q][v] = ge[r][q][v] = val[r][q][v] = 0.0f;
              g1[r][q][v] = r == 0 ? gc1[q][v] : g1[r - 1][q][v];
              g2[r][q][v] = r == 0 ? gc2[q][v] : g2[r - 1][q][v];
            }
            if (!(live && has[q])) continue;
            const int64_t off = j * d + col[q];
            gnnome::load_stream<CS, VEC>(gate_raw + off, gr[r][q]);
            gnnome::load_stream<CS, VEC>(g_enew + off, ge[r][q]);
            // a padded edge's g1 and g2 are zero: d_enew = g_enew and
            // d_vals = 0 need neither its e_new row nor its value row
            if (kr[r] < n_nodes) {
              gnnome::load_stream<CS, VEC>(e_new + off, en[r][q]);
              if constexpr (GATHER) {
                gnnome::load_vec<VEC>(values + vr[r] * d + col[q], val[r][q]);
              } else {
                gnnome::load_stream<CS, VEC>(values + off, val[r][q]);
              }
            }
            if (kr[r] != prev) {
              if (kr[r] < n_nodes) {
                gnnome::load_vec<VEC>(g_sums + (int64_t)kr[r] * 2 * d + col[q], g1[r][q]);
                gnnome::load_vec<VEC>(g_sums + (int64_t)kr[r] * 2 * d + d + col[q], g2[r][q]);
#pragma unroll
                for (int v = 0; v < VEC; ++v) {
                  g1[r][q][v] = gnnome::round_to<T>(g1[r][q][v]);
                  g2[r][q][v] = gnnome::round_to<T>(g2[r][q][v]);
                }
              } else {
#pragma unroll
                for (int v = 0; v < VEC; ++v) g1[r][q][v] = g2[r][q][v] = 0.0f;
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (i0 + r >= n_t) break;
          const int64_t j = t0 + i0 + r;
          cur = kr[r];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              gc1[q][v] = g1[r][q][v];
              gc2[q][v] = g2[r][q][v];
            }
            if (!has[q]) continue;
            float o_gr[VEC], o_en[VEC], o_v[VEC];
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const float pre = gnnome::bn_affine(gr[r][q][v], sc[q][v], bi[q][v]);
              const float s = gnnome::sigmoid(
                  RECOMPUTE ? fmaxf(pre, 0.0f) + en[r][q][v] : en[r][q][v]);
              const float d_en = ge[r][q][v] + (g1[r][q][v] * val[r][q][v] + g2[r][q][v]) *
                                                   (s * (1.0f - s));
              const float d_pre = pre > 0.0f ? d_en : 0.0f;
              o_gr[v] = d_pre * sc[q][v];
              o_en[v] = d_en;
              o_v[v] = g1[r][q][v] * s;
              ds[q][v] += d_pre * gr[r][q][v];
              db[q][v] += d_pre;
            }
            const int64_t off = j * d + col[q];
            gnnome::store_vec_cs<VEC>(d_gate_raw + off, o_gr);
            gnnome::store_vec_cs<VEC>(d_e_in + off, o_en);
            gnnome::store_vec_cs<VEC>(d_vals + off, o_v);
          }
        }
      }
    }
    // the lane groups of the warp hold the same columns: add them in a
    // fixed butterfly (every lane gets the same bits), then the first group
    // adds them to the warp's row
#pragma unroll
    for (int q = 0; q < CH; ++q) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        for (int off = w.lanes; off < 32; off <<= 1) {
          ds[q][v] += __shfl_xor_sync(FULL, ds[q][v], off);
          db[q][v] += __shfl_xor_sync(FULL, db[q][v], off);
        }
      }
      if (lane < w.lanes && has[q]) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          mine[col[q] + v] += ds[q][v];
          mine[d + col[q] + v] += db[q][v];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * d; i += THREADS) {
    float s = 0.0f;
    for (int wp = 0; wp < WARPS; ++wp) s += red[(int64_t)wp * 2 * d + i];
    partial[(int64_t)blockIdx.x * 2 * d + i] = s;
  }
}

// one device kernel name per entry, so a profile tells them apart
#define EPILOG_BWD_KERNEL(NAME, GATHER)                                                 \
  template <typename T, int VEC, int CH>                                               \
  __global__ void __launch_bounds__(THREADS) NAME(                                     \
      const T* __restrict__ gate_raw, const T* __restrict__ e_new,                     \
      const T* __restrict__ g_enew, const float* __restrict__ g_sums,                  \
      const T* __restrict__ values, const float* __restrict__ affine,                  \
      const int* __restrict__ key, const int* __restrict__ src,                        \
      T* __restrict__ d_gate_raw, T* __restrict__ d_e_in,                              \
      T* __restrict__ d_vals, float* __restrict__ partial, int64_t n_nodes,            \
      int64_t n_rows, int d, int lanes_log2) {                                         \
    epilog_bwd_walk<T, VEC, CH, GATHER>(gate_raw, e_new, g_enew, g_sums, values,       \
                                        affine, key, src, d_gate_raw, d_e_in, d_vals,  \
                                        partial, n_nodes, n_rows, d, lanes_log2);      \
  }

EPILOG_BWD_KERNEL(epilog_bwd_kernel, true)
EPILOG_BWD_KERNEL(epilog_bwd_pregathered_kernel, false)

__global__ void __launch_bounds__(256) affine_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ d_affine, int n_parts,
    int d) {
  gnnome::reduce_partials(partial, d_affine, n_parts, 2 * (int64_t)d);
}

template <typename T, int VEC, int CH>
int launch(const T* gate_raw, const T* e_new, const T* g_enew,
           const float* g_sums, const T* values, const float* affine,
           const int* key, const int* src, T* d_gate_raw, T* d_e_in,
           T* d_vals, float* partial, float* d_affine, int64_t n_nodes,
           int64_t n_rows, int d, int max_parts, int lanes_log2, int device,
           cudaStream_t s) {
  const auto kernel = src != nullptr ? epilog_bwd_kernel<T, VEC, CH>
                                     : epilog_bwd_pregathered_kernel<T, VEC, CH>;
  const size_t smem = sizeof(float) * WARPS * 2 * d;
  cudaError_t err = gnnome::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  err = gnnome::walk_grid(kernel, THREADS, smem, device, n_rows,
                          WARPS * (32 >> lanes_log2), MIN_SPAN, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > static_cast<unsigned>(max_parts)) grid = static_cast<unsigned>(max_parts);
  kernel<<<grid, THREADS, smem, s>>>(gate_raw, e_new, g_enew, g_sums, values, affine,
                                     key, src, d_gate_raw, d_e_in, d_vals, partial,
                                     n_nodes, n_rows, d, lanes_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  affine_reduce_kernel<<<(2 * d + 31) / 32, 256, 0, s>>>(partial, d_affine,
                                                          static_cast<int>(grid), d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* gate_raw, const T* e_new, const T* g_enew,
             const float* g_sums, const T* values, const float* affine,
             const int* key, const int* src, T* d_gate_raw, T* d_e_in,
             T* d_vals, float* partial, float* d_affine, int64_t n_nodes,
             int64_t n_rows, int d, int max_parts, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_parts < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = gnnome::VEC16<T>;
  int lanes_log2 = 5, chunks = 1;
  gnnome::lane_layout(vec ? d / V : d, &lanes_log2, &chunks);
  const auto run = [&](auto v) {
    return gnnome::with_chunks(chunks, [&](auto ch) {
      return launch<T, decltype(v)::value, decltype(ch)::value>(
          gate_raw, e_new, g_enew, g_sums, values, affine, key, src, d_gate_raw, d_e_in,
          d_vals, partial, d_affine, n_nodes, n_rows, d, max_parts, lanes_log2, device, s);
    });
  };
  return vec ? run(gnnome::Int<V>{}) : run(gnnome::Int<1>{});
}

}  // namespace

// key: by_dst.key (canonical dst ids, PAD_SEGMENT on padded edges);
// partial: scratch f32 [max_parts, 2, d], one row per block of the walk;
// vec: 16-byte accesses (rows of a multiple of 16 bytes, aligned bases).
GNNOME_API int gnnome_epilog_bwd_f32(
    const float* gate_raw, const float* e_new, const float* g_enew,
    const float* g_sums, const float* values, const float* affine, const int* key,
    const int* src, float* d_gate_raw, float* d_e_in, float* d_vals, float* partial,
    float* d_affine, int64_t n_nodes, int64_t n_rows, int d, int max_parts, int vec,
    int device, void* stream) {
  if (src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(gate_raw, e_new, g_enew, g_sums, values, affine, key, src, d_gate_raw,
                  d_e_in, d_vals, partial, d_affine, n_nodes, n_rows, d, max_parts, vec,
                  device, stream);
}

// gate_raw, e_new, g_enew, values and the three [E, D] outputs bf16;
// g_sums, affine, partial and d_affine f32
GNNOME_API int gnnome_epilog_bwd_bf16(
    const gnnome::bf16* gate_raw, const gnnome::bf16* e_new, const gnnome::bf16* g_enew,
    const float* g_sums, const gnnome::bf16* values, const float* affine, const int* key,
    const int* src, gnnome::bf16* d_gate_raw, gnnome::bf16* d_e_in, gnnome::bf16* d_vals,
    float* partial, float* d_affine, int64_t n_nodes, int64_t n_rows, int d, int max_parts,
    int vec, int device, void* stream) {
  if (src == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(gate_raw, e_new, g_enew, g_sums, values, affine, key, src, d_gate_raw,
                  d_e_in, d_vals, partial, d_affine, n_nodes, n_rows, d, max_parts, vec,
                  device, stream);
}

// vals: [n_rows, d], one pregathered value row per canonical edge; e_new:
// the forward's output
GNNOME_API int gnnome_epilog_bwd_pregathered_f32(
    const float* gate_raw, const float* e_new, const float* g_enew,
    const float* g_sums, const float* vals, const float* affine, const int* key,
    float* d_gate_raw, float* d_e_in, float* d_vals, float* partial, float* d_affine,
    int64_t n_nodes, int64_t n_rows, int d, int max_parts, int vec, int device,
    void* stream) {
  return dispatch(gate_raw, e_new, g_enew, g_sums, vals, affine, key,
                  static_cast<const int*>(nullptr), d_gate_raw, d_e_in, d_vals, partial,
                  d_affine, n_nodes, n_rows, d, max_parts, vec, device, stream);
}

// the bf16 pregathered entry: e_in (not e_new; the f32 e_new is recomputed
// from it), gate_raw, g_enew, vals and the three outputs bf16; g_sums,
// affine, partial and d_affine f32
GNNOME_API int gnnome_epilog_bwd_pregathered_bf16(
    const gnnome::bf16* gate_raw, const gnnome::bf16* e_in, const gnnome::bf16* g_enew,
    const float* g_sums, const gnnome::bf16* vals, const float* affine, const int* key,
    gnnome::bf16* d_gate_raw, gnnome::bf16* d_e_in, gnnome::bf16* d_vals, float* partial,
    float* d_affine, int64_t n_nodes, int64_t n_rows, int d, int max_parts, int vec,
    int device, void* stream) {
  return dispatch(gate_raw, e_in, g_enew, g_sums, vals, affine, key,
                  static_cast<const int*>(nullptr), d_gate_raw, d_e_in, d_vals, partial,
                  d_affine, n_nodes, n_rows, d, max_parts, vec, device, stream);
}
