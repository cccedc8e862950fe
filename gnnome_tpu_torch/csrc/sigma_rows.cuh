// Row and edge walks shared by the σ-weighted aggregations and their backwards
// (csrc/reverse_sum.cu, csrc/sigma_aggregate.cu, csrc/rev_bwd.cu).
//
// A CSR row v owns the sorted positions j in offsets[v]:offsets[v+1]. The
// canonical edge at j is k = order[j] when ORDERED (the by_src layout), and
// j itself otherwise (by_dst: canonical order is dst-sorted). The value row
// of an edge is, by the ValueAt mode:
//   VAL_AT_EDGE    values[k]        a pregathered [E, D] table
//   VAL_BY_EDGE    values[ids[k]]   a node table, ids in canonical order
//   VAL_BY_SORTED  values[ids[j]]   a node table, ids in sorted order (opp_ids)
//
// T is the stored type of the [E, D] data and the node table: float, or
// bf16 for the bf16 entries (loads convert to f32, all arithmetic runs in
// f32, stores round to nearest, and the forward rounds its summands where
// the caller asks); the sums and g_sums are f32 arrays. The
// forward (sigma_sum_rows) gives one warp per row, each lane owning one
// 16-byte access of consecutive columns per slice (VEC = 4 f32 or 8 bf16)
// where the rows allow it; its sums are taken in f32 registers in CSR
// order: deterministic, no atomics. The backward (sigma_bwd_walk) is an edge-balanced walk over
// the sorted positions. Nothing assumes a row's edges or value rows lie near
// each other, so graphs with cross-locus edges take the same path.
#pragma once

#include "common.cuh"

namespace gnnome {

enum ValueAt { VAL_AT_EDGE = 0, VAL_BY_EDGE = 1, VAL_BY_SORTED = 2 };

// edges in flight per walker of sigma_bwd_walk (1, 2 and 4 tried;
// PERF.md section 6)
constexpr int SIGMA_BWD_R = 2;

template <bool ORDERED>
__device__ __forceinline__ int64_t edge_at(const int* __restrict__ order, int64_t j) {
  return ORDERED ? static_cast<int64_t>(order[j]) : j;
}

template <int VAL>
__device__ __forceinline__ int64_t value_row(const int* __restrict__ ids, int64_t k,
                                             int64_t j) {
  if constexpr (VAL == VAL_AT_EDGE) {
    return k;
  } else if constexpr (VAL == VAL_BY_EDGE) {
    return ids[k];
  } else {
    return ids[j];
  }
}

// sums[v] = [sum_j sigmoid(e[k]) * value(j) || sum_j sigmoid(e[k])]  (f32 [N, 2D])
// ROUND: each summand, sigmoid(e[k]) * value(j) and sigmoid(e[k]), is
// rounded to T before it joins the f32 sum, as the TPU's
// fused_sigma_aggregate_pallas feeds them to its MXU sum in the data dtype
// (a no-op for T = float).
template <typename T, int VEC, bool ORDERED, int VAL, bool ROUND = false>
__device__ __forceinline__ void sigma_sum_rows(
    const T* __restrict__ e, const T* __restrict__ values,
    const int* __restrict__ offsets, const int* __restrict__ order,
    const int* __restrict__ ids, float* __restrict__ sums, int64_t n_nodes, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t v = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       v < n_nodes; v += n_warps) {
    const int64_t beg = offsets[v];
    const int64_t end = offsets[v + 1];
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      float acc1[VEC] = {};
      float acc2[VEC] = {};
      for (int64_t j = beg; j < end; ++j) {
        const int64_t k = edge_at<ORDERED>(order, j);
        const int64_t r = value_row<VAL>(ids, k, j);
        float en[VEC], val[VEC];
        load_vec<VEC>(e + k * d + c, en);
        load_vec<VEC>(values + r * d + c, val);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float sg = sigmoid(en[q]);
          if constexpr (ROUND) {
            acc1[q] += round_to<T>(sg * val[q]);
            acc2[q] += round_to<T>(sg);
          } else {
            acc1[q] += sg * val[q];
            acc2[q] += sg;
          }
        }
      }
      store_vec<VEC>(sums + v * 2 * d + c, acc1);
      store_vec<VEC>(sums + v * 2 * d + d + c, acc2);
    }
  }
}

// The cotangents of sigma_sum_rows' inputs, given g_sums = [g1 || g2]
// ([N, 2D]): per edge, with s = sigmoid(e[k]) and val = value(j),
//   d_e = (g1 * val + g2) * s * (1 - s),   d_v = g1 * s,
// written at the canonical position k, or at the sorted position j when
// SORTED_OUT; zero on padded edges. For T = bf16, g_sums is rounded to bf16
// as it is loaded (the JAX VJP casts the cotangent to the edge dtype before
// it gathers it) and d_e, d_v are rounded as they are stored.
//
// An edge-balanced walk over the sorted positions j of [0, n_rows)
// (gnnome::edge_walker): every walker takes every W-th tile of 4 positions,
// so the padded tail and a hub row spread over as many walkers as their
// edges need. A position's row is seg[j] (the CSR's segment_ids); the walker
// holds the g_sums slice of the current row in registers and loads the next
// one only where the row changes, in the same round of loads as that edge's
// rows; a PAD_SEGMENT row writes zeros and loads nothing but its output
// position. Each lane owns CH chunks of VEC columns of the whole row, takes
// the ids from the lane that read them (the next tile's in flight), and
// issues the loads of SIGMA_BWD_R edges before the first one's stores; both
// outputs are written with streaming stores, e (and pregathered values)
// read with streaming loads beside a node-table gather and plain loads
// otherwise (gnnome::load_stream). No sums, so the walk needs no order;
// launch with lanes_log2 and CH from gnnome::lane_layout.
template <typename T, int VEC, int CH, bool ORDERED, int VAL, bool SORTED_OUT>
__device__ __forceinline__ void sigma_bwd_walk(
    const T* __restrict__ e, const float* __restrict__ g_sums,
    const T* __restrict__ values, const int* __restrict__ seg,
    const int* __restrict__ order, const int* __restrict__ ids,
    T* __restrict__ d_e, T* __restrict__ d_v, int64_t n_nodes,
    int64_t n_rows, int d, int lanes_log2) {
  constexpr int R = SIGMA_BWD_R;
  constexpr bool CS = VAL != VAL_AT_EDGE;  // streaming loads beside a table gather
  const Walker w = edge_walker(lanes_log2);
  const int per_row = d / VEC;
  const float zero[VEC] = {};
  for (int base = 0; base < per_row; base += w.lanes * CH) {
    bool has[CH];
    int col[CH];
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int c = base + w.sl + q * w.lanes;
      has[q] = c < per_row;
      col[q] = c * VEC;
    }
    unsigned cur = ~0u;  // the row whose g_sums slice gc1, gc2 hold
    float gc1[CH][VEC] = {}, gc2[CH][VEC] = {};
    // the ids of a tile's positions, one position per lane; those of the
    // next tile are in flight while this one is walked, but for a value id
    // read through order (rev_bwd's dst[order[j]]), loaded at the tile's start
    constexpr bool CHAINED = ORDERED && VAL == VAL_BY_EDGE;
    unsigned nx_u = ~0u;
    int nx_k = 0, nx_v = 0;
    auto fetch = [&](int64_t t) {
      const int64_t jm = t + w.sl;
      const bool live = w.sl < w.tile && jm < n_rows;
      nx_u = live ? static_cast<unsigned>(seg[jm]) : ~0u;
      nx_k = live ? static_cast<int>(edge_at<ORDERED>(order, jm)) : 0;
      nx_v = live && !CHAINED ? static_cast<int>(value_row<VAL>(ids, nx_k, jm)) : 0;
    };
    fetch(w.first);
    for (int64_t t0 = w.first; t0 < n_rows; t0 += w.stride) {
      const int n_t = static_cast<int>(n_rows - t0 < w.tile ? n_rows - t0 : w.tile);
      const unsigned my_u = nx_u;
      const int my_k = nx_k;
      const int my_v = CHAINED && my_u < n_nodes ? ids[my_k] : nx_v;
      fetch(t0 + w.stride);
      for (int i0 = 0; i0 < n_t; i0 += R) {  // alike on every lane of the group
        unsigned u[R];
        int64_t k[R], vr[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = (i0 + r) & (w.tile - 1);
          const unsigned t = tile_take(w, my_u, i);
          u[r] = i0 + r < n_t ? t : ~0u;
          k[r] = tile_take(w, my_k, i);
          vr[r] = tile_take(w, my_v, i);
        }
        float en[R][CH][VEC], val[R][CH][VEC], g1[R][CH][VEC], g2[R][CH][VEC];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // the g_sums slice of this edge's row: loaded only where the row
          // changes, and in the same round of loads as the edge's rows
          const unsigned prev = r == 0 ? cur : u[r - 1];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              en[r][q][v] = val[r][q][v] = 0.0f;
              g1[r][q][v] = r == 0 ? gc1[q][v] : g1[r - 1][q][v];
              g2[r][q][v] = r == 0 ? gc2[q][v] : g2[r - 1][q][v];
            }
            if (!(u[r] < n_nodes && has[q])) continue;
            load_stream<CS, VEC>(e + k[r] * d + col[q], en[r][q]);
            if constexpr (VAL == VAL_AT_EDGE) {
              load_stream<CS, VEC>(values + vr[r] * d + col[q], val[r][q]);
            } else {
              load_vec<VEC>(values + vr[r] * d + col[q], val[r][q]);
            }
            if (u[r] != prev) {
              load_vec<VEC>(g_sums + (int64_t)u[r] * 2 * d + col[q], g1[r][q]);
              load_vec<VEC>(g_sums + (int64_t)u[r] * 2 * d + d + col[q], g2[r][q]);
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                g1[r][q][v] = round_to<T>(g1[r][q][v]);
                g2[r][q][v] = round_to<T>(g2[r][q][v]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (i0 + r >= n_t) break;
          const int64_t j = t0 + i0 + r;
          const int64_t o = SORTED_OUT ? j : k[r];
          if (u[r] >= n_nodes) {  // a padded edge: zero cotangents
#pragma unroll
            for (int q = 0; q < CH; ++q) {
              if (!has[q]) continue;
              store_vec_cs<VEC>(d_e + o * d + col[q], zero);
              store_vec_cs<VEC>(d_v + o * d + col[q], zero);
            }
            continue;
          }
          cur = u[r];
#pragma unroll
          for (int q = 0; q < CH; ++q) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              gc1[q][v] = g1[r][q][v];
              gc2[q][v] = g2[r][q][v];
            }
            if (!has[q]) continue;
            float o_e[VEC], o_v[VEC];
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const float s = sigmoid(en[r][q][v]);
              o_e[v] = (g1[r][q][v] * val[r][q][v] + g2[r][q][v]) * (s * (1.0f - s));
              o_v[v] = g1[r][q][v] * s;
            }
            store_vec_cs<VEC>(d_e + o * d + col[q], o_e);
            store_vec_cs<VEC>(d_v + o * d + col[q], o_v);
          }
        }
      }
    }
  }
}

}  // namespace gnnome
