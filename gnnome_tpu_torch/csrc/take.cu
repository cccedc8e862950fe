// Row gather: out[i] = table[ids[i]], a zero row where ids[i] is outside
// [0, n_rows) (PAD_SEGMENT on padded edges).
//
// Replaces: gnnome_tpu/ops/banded.py:banded_take_pallas (reached through
// take_rows / gather_by_endpoint: the score head's two endpoint gathers at
// D = 64, the LayerNorm layer's endpoint gathers at D = 256 and the wide
// layer's paired rows at 2D = 512, gnnome_tpu/models/gated_gcn.py).
//
// Bound on the H100: bytes. At E = 1M ids and D = 512 f32 it writes 2.05 GB
// and reads 4 MB of ids and at most 307 MB of a 150k-row table: 0.70 ms at
// 3.35 TB/s (D = 256: 0.35 ms; D = 64: 0.09 ms); a bf16 table half that.
//
// Design, for a gather that is all memory traffic (bulk asynchronous copies
// of whole rows through shared memory were tried and were no faster):
// - Whole rows per lane group. A group of 8, 16 or 32 lanes (the power of
//   two nearest d / VEC, at most a warp) owns an output row; its number
//   comes from the warp index, so no thread divides an index per chunk. One
//   lane reads each id and the group takes it with __shfl_sync.
// - Several rows in flight. Each lane issues the 16-byte loads of 4 rows
//   (CH = 1, 2 or 4 chunks each) before any store, so it has up to 16
//   independent loads outstanding, where a chunk per thread had one.
// - Cache policy. The output is written once and is 40x the L2: it leaves
//   with streaming stores (st.global.cs) and does not evict the table,
//   whose rows neighbouring edges share (the local graph's src ids lie
//   within 22 of each other, dst is sorted); table loads stay cached.
// The entries copy f32 or bf16 rows bit for bit: VEC elements of 16 bytes
// (4 f32 or 8 bf16; rows of a multiple of 16 bytes, aligned bases), or one
// element at a time for any other width.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
// a grid-stride walk over at most this many blocks a SM: the best of 4-32
// on the H100 at D = 64, 256 and 512 (PERF.md section 6)
constexpr int BLOCKS_PER_SM = 32;
constexpr int ROWS = 4;  // rows a lane group has in flight
constexpr unsigned FULL = 0xffffffffu;

// The unit a lane copies: 16 bytes (VEC = 4 floats or 8 bf16) or one
// element. A gather moves bits, so a bf16 row is copied as raw chunks.
template <typename T, int VEC>
struct Chunk;
template <>
struct Chunk<float, 4> {
  using type = float4;
};
template <>
struct Chunk<float, 1> {
  using type = float;
};
template <>
struct Chunk<gnnome::bf16, 8> {
  using type = uint4;
};
template <>
struct Chunk<gnnome::bf16, 1> {
  using type = unsigned short;
};

// lanes_log2: log2 of the lanes that share a row (3, 4 or 5); a warp holds
// 32 >> lanes_log2 row slots and takes ROWS rows per slot at a time, CH
// chunks of each per lane.
template <typename E, int VEC, int CH>
__global__ void __launch_bounds__(THREADS) take_rows_kernel(
    const E* __restrict__ table, const int* __restrict__ ids,
    E* __restrict__ out, int n_ids, int n_rows, int d, int lanes_log2) {
  using T = typename Chunk<E, VEC>::type;
  const int per_row = d / VEC;  // chunks in a row
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int slot = lane >> lanes_log2;
  const int sl = lane & (lanes - 1);
  const int slots = 32 >> lanes_log2;
  const int rows_per_warp = slots * ROWS;  // <= 32: one id per lane
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * THREADS) >> 5;
  const T* __restrict__ tab = reinterpret_cast<const T*>(table);
  T* __restrict__ dst = reinterpret_cast<T*>(out);

  for (int base = warp * rows_per_warp; base < n_ids; base += n_warps * rows_per_warp) {
    const int q = base + lane;
    const int my_id = (lane < rows_per_warp && q < n_ids) ? ids[q] : -1;
    // row r of this lane's slot is base + r * slots + slot: the slots of a
    // warp write neighbouring rows
    int id[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) id[r] = __shfl_sync(FULL, my_id, r * slots + slot);
    for (int c0 = sl; c0 < per_row; c0 += lanes * CH) {
      T v[ROWS][CH];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool hit = static_cast<unsigned>(id[r]) < static_cast<unsigned>(n_rows);
        const T* row = tab + static_cast<int64_t>(hit ? id[r] : 0) * per_row;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const int c = c0 + k * lanes;
          v[r][k] = (hit && c < per_row) ? row[c] : T{};
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = base + r * slots + slot;
        if (i >= n_ids) break;
        T* row = dst + static_cast<int64_t>(i) * per_row;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const int c = c0 + k * lanes;
          if (c < per_row) __stcs(row + c, v[r][k]);
        }
      }
    }
  }
}

template <typename E, int VEC, int CH>
cudaError_t launch(const E* table, const int* ids, E* out, int n_ids,
                   int n_rows, int d, int lanes_log2, int device, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = (THREADS / 32) * (32 >> lanes_log2) * ROWS;
  const unsigned grid = gnnome::grid_for(n_ids, static_cast<int>(rows_per_block),
                                         static_cast<int64_t>(sms) * BLOCKS_PER_SM);
  take_rows_kernel<E, VEC, CH><<<grid, THREADS, 0, s>>>(table, ids, out, n_ids, n_rows,
                                                         d, lanes_log2);
  return cudaGetLastError();
}

template <typename E, int VEC>
cudaError_t dispatch(const E* table, const int* ids, E* out, int n_ids,
                     int n_rows, int d, int device, cudaStream_t s) {
  // 8 lanes at least, so a warp's rows in flight fit 32 ids
  int lanes_log2 = 5, chunks = 1;
  gnnome::lane_layout(d / VEC, &lanes_log2, &chunks);
  return gnnome::with_chunks(chunks, [&](auto ch) {
    return launch<E, VEC, decltype(ch)::value>(table, ids, out, n_ids, n_rows, d,
                                               lanes_log2, device, s);
  });
}

template <typename E>
int take(const E* table, const int* ids, E* out, int64_t n_ids, int64_t n_rows, int d,
         int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ids == 0 || d == 0) return 0;
  // 32-bit row and chunk numbers; the grid-stride step stays below 2^31
  if (n_ids > (int64_t{1} << 30) || n_rows > (int64_t{1} << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = vec ? dispatch<E, gnnome::VEC16<E>>(table, ids, out, static_cast<int>(n_ids),
                                            static_cast<int>(n_rows), d, device, s)
            : dispatch<E, 1>(table, ids, out, static_cast<int>(n_ids),
                             static_cast<int>(n_rows), d, device, s);
  return static_cast<int>(err);
}

}  // namespace

// vec: 16-byte chunks (rows of a multiple of 16 bytes, aligned bases)
GNNOME_API int gnnome_take_rows_f32(const float* table, const int* ids,
                                    float* out, int64_t n_ids, int64_t n_rows,
                                    int d, int vec, int device, void* stream) {
  return take(table, ids, out, n_ids, n_rows, d, vec, device, stream);
}

GNNOME_API int gnnome_take_rows_bf16(const gnnome::bf16* table, const int* ids,
                                     gnnome::bf16* out, int64_t n_ids, int64_t n_rows,
                                     int d, int vec, int device, void* stream) {
  return take(table, ids, out, n_ids, n_rows, d, vec, device, stream);
}
