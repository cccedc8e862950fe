// Row walks shared by the σ-weighted aggregations and their backwards
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
// One warp per row, each lane owning 4 consecutive columns (16-byte
// accesses) per 128-column slice when VEC == 4. Sums are taken in f32
// registers in CSR order: deterministic, no atomics. Nothing assumes a
// row's edges or value rows lie near each other, so graphs with cross-locus
// edges take the same path.
#pragma once

#include "common.cuh"

namespace gnnome {

enum ValueAt { VAL_AT_EDGE = 0, VAL_BY_EDGE = 1, VAL_BY_SORTED = 2 };

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
template <int VEC, bool ORDERED, int VAL>
__device__ __forceinline__ void sigma_sum_rows(
    const float* __restrict__ e, const float* __restrict__ values,
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
          acc1[q] += sg * val[q];
          acc2[q] += sg;
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
// SORTED_OUT. Padded edges (sorted positions offsets[N]..n_rows-1) form one
// extra row whose outputs are zero. Launch with at least one warp; rows
// 0..N are walked (N + 1 of them).
template <int VEC, bool ORDERED, int VAL, bool SORTED_OUT>
__device__ __forceinline__ void sigma_bwd_rows(
    const float* __restrict__ e, const float* __restrict__ g_sums,
    const float* __restrict__ values, const int* __restrict__ offsets,
    const int* __restrict__ order, const int* __restrict__ ids,
    float* __restrict__ d_e, float* __restrict__ d_v, int64_t n_nodes,
    int64_t n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t u = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       u <= n_nodes; u += n_warps) {
    const bool tail = u == n_nodes;
    const int64_t beg = offsets[u];
    const int64_t end = tail ? n_rows : offsets[u + 1];
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      if (tail) {
        const float zero[VEC] = {};
        for (int64_t j = beg; j < end; ++j) {
          const int64_t o = SORTED_OUT ? j : edge_at<ORDERED>(order, j);
          store_vec<VEC>(d_e + o * d + c, zero);
          store_vec<VEC>(d_v + o * d + c, zero);
        }
        continue;
      }
      float g1[VEC], g2[VEC];
      load_vec<VEC>(g_sums + u * 2 * d + c, g1);
      load_vec<VEC>(g_sums + u * 2 * d + d + c, g2);
      for (int64_t j = beg; j < end; ++j) {
        const int64_t k = edge_at<ORDERED>(order, j);
        const int64_t r = value_row<VAL>(ids, k, j);
        const int64_t o = SORTED_OUT ? j : k;
        float en[VEC], val[VEC], o_e[VEC], o_v[VEC];
        load_vec<VEC>(e + k * d + c, en);
        load_vec<VEC>(values + r * d + c, val);
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float s = sigmoid(en[q]);
          o_e[q] = (g1[q] * val[q] + g2[q]) * (s * (1.0f - s));
          o_v[q] = g1[q] * s;
        }
        store_vec<VEC>(d_e + o * d + c, o_e);
        store_vec<VEC>(d_v + o * d + c, o_v);
      }
    }
  }
}

}  // namespace gnnome
