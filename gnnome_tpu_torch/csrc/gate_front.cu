// GatedGCN gate front: per canonical edge k
//   gate[k] = (b1h[src[k]] + b2h[dst[k]]) + (e[k] . W3 + b3)
// plus the BatchNorm moments over real edges (k < n_real)
//   mom = [sum_k gate[k] || sum_k gate[k]^2]   (f32 [2, D]).
//
// Replaces: gnnome_tpu/ops/spmm_pallas.py:gate_front_pallas (one call per
// GatedGCN layer, 16 per forward of the shipped model).
//
// Bound on the H100: operations. At E = 1M, D = 256 the product e . W3 is
// 2*E*D*D = 131 GFLOP. This kernel runs it on the tensor cores as three
// TF32 products (below): 393 GFLOP at 495 TFLOP/s = 0.79 ms. (In f32 on the
// CUDA cores, 67 TFLOP/s, it would be 1.96 ms.) Bytes: e and gate 1.02 GB
// each, two 150k-row node tables 154 MB each, ids 8 MB: about 2.36 GB,
// 0.70 ms at 3.35 TB/s.
//
// Precision: the TPU kernel runs the product on the MXU at
// Precision.HIGHEST, a multi-pass bf16 split with f32 accuracy. The Hopper
// counterpart is the 3-pass split-TF32 product: x = x_hi + x_lo with
// x_hi = tf32(x) and x_lo = tf32(x - x_hi), both rounded to nearest
// (cvt.rna; truncated parts would represent x only to ~2^-21), and
//   e . W3 ~ (e_lo . W_hi + e_hi . W_lo) + e_hi . W_hi.
// The dropped e_lo . W_lo is below 2^-22 of each product. The tensor cores
// add into an f32 accumulator without rounding to nearest, so every
// accumulation step can lose up to an ulp of the running sum: the two
// small cross terms accumulate apart from the big one (32 steps into the
// big sum at D = 256, not 96) and join it once, in f32, at the end. That
// holds the kernel within 1e-5 of the f32 product (tests/test_torch_tf32split.py
// argues the tolerance on the CPU). One TF32 pass keeps ~3 decimal digits
// and is not used.
//
// Design:
// - A block owns 128-edge row tiles and all 256 output columns (gridDim.y
//   column blocks only for D > 256), in two passes of 128 columns (two
//   accumulators of 64 f32 a thread fit beside each other; one of 128 would
//   not). Each endpoint row is gathered once and the moments are whole
//   columns. One block per SM walks a fixed, blockIdx-strided set of tiles.
// - Two warpgroups, 64 rows each, run wgmma.m64n128k8 (sm_90a) with the
//   accumulators in registers. A comes from registers: each thread reads
//   its fragment of the e tile from shared memory (ldmatrix) and splits it
//   there. B is W3^T, K-major, split into hi/lo once per call by
//   w3_split_kernel into the core-matrix order a stage holds, so a stage's
//   B is two contiguous 8 KB copies.
// - A 4-stage ring of K slices (16 k: the e tile and both W3 parts),
//   filled two slices ahead by thread 0: a TMA load of the e tile (a 2-D
//   tensor map; rows past the end and columns past d arrive as zeros) and
//   two bulk copies of the W3 parts, all completing on the stage's
//   mbarrier, so loads overlap the products and the other threads issue
//   none. The ring runs on across passes and tiles. W3's parts are shared
//   by every block and stay in L2.
// - The epilogue of a pass runs in the shadow of the next pass's products:
//   the pass's e . W3 goes to shared memory, and while each later slice's
//   wgmmas run, every warp finishes a row of it: adds the gathered endpoint
//   rows (loaded one row ahead) and the bias, stores the gate row with
//   16-byte streaming stores, and adds real rows into column moments that
//   each lane keeps in registers for its 4 columns.
// - Moments leave the block as one partial row per block, summed by a
//   second kernel in a fixed order (gnnome::reduce_partials): deterministic,
//   no float atomics, padded rows written but never summed.
// What holds it above its bound (PERF.md section 6): all eight warps split,
// issue and finish epilogue rows between one block-wide barrier per slice,
// so instruction issue and the epilogue's gathers, not the tensor cores,
// set the pace. A producer warp beside the two warpgroups was slower: with
// a third warpgroup the compiler holds every thread to 168 registers.
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 128;      // edges per row tile: two warpgroups of 64
constexpr int BN = 256;      // output columns per block
constexpr int NP = 128;      // output columns per pass: one wgmma n128
constexpr int BK = 16;       // K per pipeline stage
constexpr int KSTEPS = BK / 8;  // wgmma k8 steps per stage
constexpr int STAGES = 4;    // ring depth; loads run STAGES - 2 slices ahead
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BM / WARPS;  // epilogue rows of a pass per warp
// e tile row stride (floats): ldmatrix rows on distinct banks. The TMA box
// is that wide too: it reads 4 columns past the slice, which go unused.
constexpr int A_LD = BK + 4;
constexpr int A_FLOATS = BM * A_LD;
constexpr int B_FLOATS = BK * NP;  // one W3 part of a stage: [BK / 4][NP][4]
constexpr int STAGE_FLOATS = A_FLOATS + 2 * B_FLOATS;
constexpr int C_LD = NP + 8;  // product tile row stride: its float2 stores without conflicts
// the ring, the product tile and the ring's barriers, after 128 bytes of
// slack to align the ring for TMA: 176,288
constexpr size_t SMEM_BYTES =
    128 + sizeof(float) * (STAGES * STAGE_FLOATS + BM * C_LD) + STAGES * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: what cvt.rna.tf32.f32 computes, in two integer operations (ptxas
// expands that cvt into a longer sequence on sm_90a). Add half of the 13
// dropped bits to the magnitude, then clear them; a finite x past the
// largest TF32 value becomes inf, as with cvt.rna.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one bulk copy (async proxy, as wgmma reads) of `bytes` contiguous bytes,
// completing on `bar`; the caller has announced the bytes on `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// the box of a 2-D tensor map at (column k0, row row0): rows past the end
// and columns past d arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int k0, int row0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0),
         "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or reuse of a register across an
// asynchronous wgmma (issue to wait).
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x) :: "memory"); }
__device__ __forceinline__ void pin(uint32_t& x) { asm volatile("" : "+r"(x) :: "memory"); }

// Shared-memory descriptor of a K-major B slice without swizzle: core
// matrices of 8 n-rows x 16 bytes (4 k), 128 contiguous bytes each; the
// next 4 k lie NP * 16 bytes on (leading byte offset), the next 8 n
// 128 bytes on (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((NP * 16) >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

#define GNNOME_D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B over one k8 step: A [64, 8] tf32 from registers (this
// thread's fragment), B [8, 128] tf32 from shared memory; scale_d = 0
// overwrites d. d[4j + 2h + c] is row 16 * (warp % 4) + lane / 4 + 8h,
// column 8j + 2 * (lane % 4) + c.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : GNNOME_D8(0), GNNOME_D8(8), GNNOME_D8(16), GNNOME_D8(24), GNNOME_D8(32),
        GNNOME_D8(40), GNNOME_D8(48), GNNOME_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

#undef GNNOME_D8

// W3 [d, d] -> W3^T split into hi/lo tf32 parts, zero-padded to n_ks * BK
// rows of k and 256-column blocks of two 128-column passes, in the order a
// stage holds them: [column block][pass][K slice][k / 4][n][k % 4].
__global__ void __launch_bounds__(256) w3_split_kernel(
    const float* __restrict__ w3, float* __restrict__ hi, float* __restrict__ lo, int d,
    int n_ks, int64_t total) {
  for (int64_t i = blockIdx.x * 256ll + threadIdx.x; i < total; i += gridDim.x * 256ll) {
    const int q = static_cast<int>(i & 3);
    const int n = static_cast<int>((i >> 2) % NP);
    const int64_t rest = i / (4 * NP);
    const int kc = static_cast<int>(rest % (BK / 4));
    const int64_t slice = rest / (BK / 4);
    const int k = static_cast<int>(slice % n_ks) * BK + kc * 4 + q;
    const int col = static_cast<int>(slice / n_ks) * NP + n;  // (block, pass) -> 128 columns
    const float v = (k < d && col < d) ? w3[static_cast<int64_t>(k) * d + col] : 0.0f;
    const uint32_t h = tf32_rna(v);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(tf32_rna(v - __uint_as_float(h)));
  }
}

// VEC = 4: rows of e, b1h, b2h and gate 16-byte aligned (d % 4 == 0), the
// e tile by TMA; VEC = 1: any d, the threads copy the e tile element by
// element, scalar epilogue accesses.
template <int VEC>
__global__ void __launch_bounds__(THREADS, 1) gate_front_kernel(
    const __grid_constant__ CUtensorMap e_map, const float* __restrict__ b1h,
    const float* __restrict__ b2h, const float* __restrict__ e,
    const float* __restrict__ w_hi, const float* __restrict__ w_lo,
    const float* __restrict__ b3, const int* __restrict__ src, const int* __restrict__ dst,
    float* __restrict__ gate, float* __restrict__ partial, int n_rows, int n_real, int d,
    int n_ks) {
  extern __shared__ unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                         ~static_cast<uintptr_t>(127));
  float* ctile = smem + STAGES * STAGE_FLOATS;  // a pass's e . W3 + b3: [BM][C_LD]
  uint64_t* full = reinterpret_cast<uint64_t*>(ctile + BM * C_LD);  // a stage has landed
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // rows 16 * warp .. + 15 of a tile in the products
  const int col0 = blockIdx.y * BN;
  const int n_half = (d - col0 + NP - 1) / NP < 2 ? (d - col0 + NP - 1) / NP : 2;
  const int n_tiles = (n_rows + BM - 1) / BM;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_pass = my_tiles * n_half;  // (tile, 128 columns), tile after tile
  const int total_it = n_pass * n_ks;    // K slices this block runs

  // The next slice to load into the ring: its number, K slice, pass (half)
  // and first tile row. Slices load in order, so a cursor replaces divisions.
  int ld_it = 0, ld_ks = 0, ld_half = 0, ld_row0 = blockIdx.x * BM;
  // that slice into its stage: thread 0 issues a TMA load of the e tile and
  // two bulk copies of the W3 parts, all completing on the stage's barrier
  // (VEC = 1: the threads copy the e tile themselves)
  auto load_slice = [&]() {
    const int row0 = ld_row0, ks = ld_ks, k0 = ld_ks * BK;
    const int it = ld_it;
    float* st = smem + (it % STAGES) * STAGE_FLOATS;
    if constexpr (VEC == 1) {
      for (int i = tid; i < BM * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        st[r * A_LD + kk] = row0 + r < n_rows && k0 + kk < d
                                ? e[static_cast<int64_t>(row0 + r) * d + k0 + kk] : 0.0f;
      }
    }
    if (tid == 0) {
      const int64_t b0 = (static_cast<int64_t>(blockIdx.y * 2 + ld_half) * n_ks + ks) * B_FLOATS;
      uint64_t* bar = &full[it % STAGES];
      mbar_expect(bar, ((VEC == 4 ? A_FLOATS : 0) + 2 * B_FLOATS) * sizeof(float));
      if constexpr (VEC == 4) tma_load_2d(st, &e_map, k0, row0, bar);
      bulk_copy(st + A_FLOATS, w_hi + b0, B_FLOATS * sizeof(float), bar);
      bulk_copy(st + A_FLOATS + B_FLOATS, w_lo + b0, B_FLOATS * sizeof(float), bar);
    }
    ++ld_it;
    if (++ld_ks == n_ks) {
      ld_ks = 0;
      if (++ld_half == n_half) {
        ld_half = 0;
        ld_row0 += gridDim.x * BM;
      }
    }
  };

  float acc[64];   // e_hi . W_hi
  float accs[64];  // the cross terms e_lo . W_hi + e_hi . W_lo
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = accs[i] = 0.0f;
  // A fragments, split: [buffer][k8 step][fragment register]. Two buffers,
  // so a slice's fragments are written while the previous slice's wgmmas,
  // which read the other buffer, may still run.
  uint32_t ahi[2][KSTEPS][4] = {}, alo[2][KSTEPS][4] = {};
  // ldmatrix.x4 addresses: matrices (rows 0-7 | 8-15) x (k 0-3 | 4-7) of
  // the warp's 16 rows give the tf32 A fragment a0..a3
  const int a_off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * A_LD + (lane >> 4) * 4;

  // The epilogue: this lane's 4 columns of each pass (half), their bias and
  // moments; the pending pass (its tile's first row, its half) whose product
  // sits in ctile, and this warp's next row k of it (tile row 16 * warp + k)
  // with its endpoint rows loaded ahead. A warp's rows are neighbours, so an
  // endpoint row already loaded for the row before (dst is sorted) is kept.
  float bias[2][4], mom[2][4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = col0 + h * NP + lane * 4 + q;
      bias[h][q] = c < d ? b3[c] : 0.0f;
      mom[h][q][0] = mom[h][q][1] = 0.0f;
    }
  }
  int ep_row0 = -1, ep_half = 0, ep_k = ROWS_PER_WARP;
  float x1[4], x2[4];
  int x1_id = -1, x2_id = -1;  // the endpoint rows x1, x2 hold
  // the endpoint ids of this warp's rows of a tile: lane k < 16 holds
  // src[16 * warp + k], lane 16 + k dst[16 * warp + k]; read when a pass
  // starts, used when its epilogue runs
  int ep_ids = 0, next_ids = 0;
  static_assert(ROWS_PER_WARP == 16, "one id per lane for the warp's rows");

  auto prefetch = [&]() {
    const int s_id = __shfl_sync(0xffffffffu, ep_ids, ep_k & 15);
    const int d_id = __shfl_sync(0xffffffffu, ep_ids, 16 + (ep_k & 15));
    const int row = ep_row0 + warp * ROWS_PER_WARP + ep_k;
    if (ep_k >= ROWS_PER_WARP || row >= n_rows) return;
    const int c = col0 + ep_half * NP + lane * 4;
    auto load = [&](const float* table, int id, int& held, float (&x)[4]) {
      if (id == held) return;
      held = id;
      const float* p = table + static_cast<int64_t>(id) * d + c;
      if constexpr (VEC == 4) {
        const float4 u = c < d ? __ldg(reinterpret_cast<const float4*>(p))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = c + q < d ? p[q] : 0.0f;
      }
    };
    load(b1h, s_id, x1_id, x1);
    load(b2h, d_id, x2_id, x2);
  };

  auto finish_rows = [&](int count) {
    for (int i = 0; i < count && ep_k < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + ep_k;
      const int row = ep_row0 + r;
      if (row < n_rows) {
        const int c = col0 + ep_half * NP + lane * 4;
        const float4 p = *reinterpret_cast<const float4*>(ctile + r * C_LD + lane * 4);
        const float pv[4] = {p.x, p.y, p.z, p.w};
        float gv[4];
        const bool real = row < n_real;
        auto fold = [&](const float (&b)[4], float (&m)[4][2]) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            gv[q] = (x1[q] + x2[q]) + (pv[q] + b[q]);
            if (real) {
              m[q][0] += gv[q];
              m[q][1] += gv[q] * gv[q];
            }
          }
        };
        if (ep_half == 0) {
          fold(bias[0], mom[0]);
        } else {
          fold(bias[1], mom[1]);
        }
        float* pg = gate + static_cast<int64_t>(row) * d + c;
        if constexpr (VEC == 4) {
          if (c < d) __stcs(reinterpret_cast<float4*>(pg), make_float4(gv[0], gv[1], gv[2], gv[3]));
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (c + q < d) __stcs(pg + q, gv[q]);
          }
        }
      }
      ++ep_k;
      prefetch();
    }
  };
  // rows of the pending pass each warp finishes per K slice of the next
  const int rows_per_step = (ROWS_PER_WARP + n_ks - 1) / n_ks;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < STAGES - 2; ++p) {
    if (p < total_it) load_slice();
  }

  auto step = [&](auto buf, int it, bool first) {
    constexpr int B = decltype(buf)::value;
    __syncthreads();  // slice it - 2's wgmmas are done in every warp
    if (ld_it < total_it) load_slice();  // slice it + 2, into it - 2's stage
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);  // slice it has landed
    const float* st = smem + (it % STAGES) * STAGE_FLOATS;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      uint32_t raw[4];
      ldmatrix_x4(raw, st + a_off + s * 8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = __uint_as_float(raw[q]);
        ahi[B][s][q] = tf32_rna(x);
        alo[B][s][q] = tf32_rna(x - __uint_as_float(ahi[B][s][q]));
      }
    }
    const float* sb = st + A_FLOATS;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const uint64_t dh = b_desc(sb + s * 8 * NP);  // k 8s..8s+7: k / 4 = 2s, 2s + 1
      const uint64_t dl = b_desc(sb + B_FLOATS + s * 8 * NP);
      const int keep = (first && s == 0) ? 0 : 1;
      wgmma_m64n128k8(accs, alo[B][s], dh, keep);
      wgmma_m64n128k8(accs, ahi[B][s], dl, 1);
      wgmma_m64n128k8(acc, ahi[B][s], dh, keep);
    }
    wgmma_commit();
    finish_rows(rows_per_step);  // the pending pass, while the products run
    wgmma_wait<1>();  // the other buffer's slice is done: its registers are free
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pin(ahi[1 - B][s][q]);
        pin(alo[1 - B][s][q]);
      }
    }
  };

  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 8j + 2t + c
  for (int pass = 0; pass < n_pass; ++pass) {
    {
      const int r =
          (blockIdx.x + (pass / n_half) * gridDim.x) * BM + warp * ROWS_PER_WARP + (lane & 15);
      next_ids = r < n_rows ? (lane < 16 ? src[r] : dst[r]) : 0;
    }
    for (int ks = 0; ks < n_ks; ks += 2) {  // n_ks is even
      step(std::integral_constant<int, 0>{}, pass * n_ks + ks, ks == 0);
      step(std::integral_constant<int, 1>{}, pass * n_ks + ks + 1, false);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      pin(acc[i]);
      pin(accs[i]);
    }
    finish_rows(ROWS_PER_WARP);  // none left when n_ks * rows_per_step covers them
    __syncthreads();  // every warp is done with the pending pass's ctile
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(ctile + (warp * 16 + g + 8 * h) * C_LD + 8 * j + 2 * t) =
            make_float2(accs[4 * j + 2 * h] + acc[4 * j + 2 * h],
                        accs[4 * j + 2 * h + 1] + acc[4 * j + 2 * h + 1]);
      }
    }
    ep_row0 = (blockIdx.x + (pass / n_half) * gridDim.x) * BM;
    ep_half = pass % n_half;
    ep_ids = next_ids;
    x1_id = x2_id = -1;
    ep_k = 0;
    prefetch();
    // the next slice's __syncthreads publishes ctile before any row of it is read
  }
  __syncthreads();
  finish_rows(ROWS_PER_WARP);  // the last pass

  // the warps' column moments meet in shared memory: red[warp][stat][BN]
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = h * NP + lane * 4 + q;
      red[(warp * 2) * BN + col] = mom[h][q][0];
      red[(warp * 2 + 1) * BN + col] = mom[h][q][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * BN; i += THREADS) {
    const int stat = i / BN, col = i % BN;
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += red[(w * 2 + stat) * BN + col];
    if (col0 + col < d) partial[(static_cast<int64_t>(blockIdx.x) * 2 + stat) * d + col0 + col] = s;
  }
}

// mom[2, d] = sum over the blocks' partial rows [n_parts, 2, d], in a fixed order
__global__ void __launch_bounds__(256) moments_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ mom, int n_parts, int d) {
  gnnome::reduce_partials(partial, mom, n_parts, 2 * static_cast<int64_t>(d));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2-D TMA descriptor of a row-major [n_rows, d] array of `elem`-byte
// elements: boxes of box_rows rows x box_cols columns, zeros outside.
cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          size_t elem, int64_t n_rows, int d, cuuint32_t box_cols,
                          cuuint32_t box_rows, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n_rows > 0 ? n_rows : 1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * elem};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int VEC>
cudaError_t launch_front(const float* b1h, const float* b2h, const float* e,
                         const float* w_hi, const float* w_lo, const float* b3,
                         const int* src, const int* dst, float* gate, float* partial,
                         int n_rows, int n_real, int d, int n_ks, int n_parts,
                         cudaStream_t s) {
  CUtensorMap map = {};
  // the e tile [BM][A_LD] f32, unswizzled
  cudaError_t err = VEC == 4 ? tensor_map_2d(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, e,
                                             sizeof(float), n_rows, d, A_LD, BM,
                                             CU_TENSOR_MAP_SWIZZLE_NONE)
                             : cudaSuccess;
  if (err != cudaSuccess) return err;
  err = gnnome::allow_smem(gate_front_kernel<VEC>, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_parts, (d + BN - 1) / BN);
  gate_front_kernel<VEC><<<grid, THREADS, SMEM_BYTES, s>>>(
      map, b1h, b2h, e, w_hi, w_lo, b3, src, dst, gate, partial, n_rows, n_real, d, n_ks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 entry (compute_dtype="bfloat16"): e, W3, b3, the node tables and
// the gate are bf16, the moments f32. It computes what the TPU kernel
// computes in bf16 (gnnome_tpu/ops/spmm_pallas.py:2619-2655):
//   proj = bf16(e . W3)            the product summed in f32, rounded once
//   pb   = bf16(proj + b3)         the bias added as bf16 arithmetic does
//   gate = bf16((pb + b1h[src]) + b2h[dst])   the endpoint rows in f32
//   mom  = [sum gate || sum gate^2] over real rows, of the ROUNDED gate, in f32.
// A product of two bf16 values is exact in f32, so one bf16 tensor-core
// product with an f32 accumulator computes e . W3 as JAX does, up to the
// order of the sums; no split is needed.
//
// Bound on the H100: bytes. At E = 1M, D = 256: e and gate 512 MB each, the
// two node tables 77 MB each, ids 8 MB: about 1.19 GB, 0.355 ms at
// 3.35 TB/s; e . W3 is 131 GFLOP, 0.13 ms at the dense bf16 rate.
//
// Two instances, picked by shape by the wrapper's launch plan
// (ops/gate_front.py gate_front_bf16_plan), never on a failure:
// - bfh::gate_front_bf16_tma_kernel where TMA can read e: d % 8 == 0
//   (16-byte rows) and 16-byte aligned bases, for every d whose W3 column
//   slice fits in shared memory (d <= 2944, at BN = 32);
// - bf::gate_front_bf16_kernel otherwise: element by element, any d.
//
// Moments leave either instance as one partial row per block, summed in a
// fixed order by moments_reduce_kernel: deterministic, no float atomics,
// padded rows written but never summed.
namespace bf {

using gnnome::bf16;

// The element-wise instance (its W3 slice K-tiled above d = 512): a
// block owns 128 output columns (gridDim.y blocks cover d) and walks 64-edge
// row tiles, blockIdx-strided. Its W3 slice is cut into K tiles: one tile
// of the whole padded depth for d <= 512, which stays in shared memory for
// the whole walk, else tiles of 256 rows, brought in again for every row
// tile. Per row tile and K tile the threads copy the matching columns of
// the e tile to shared memory, eight warps (4 row groups of 16 x 2 column
// halves of 64) run mma.sync on ldmatrix fragments into the same f32
// accumulators, in the same k order whatever the tiling; then the product
// is rounded to bf16 into shared memory, and each half-warp finishes a row:
// gathers the endpoint rows, adds, stores the gate row and adds real rows
// into the moments it keeps in registers. Two blocks share an SM.
constexpr int BM = 64;     // edges per row tile
constexpr int BN = 128;    // output columns per block
constexpr int WARPS = 8;   // 4 row groups of 16 rows x 2 column halves of 64
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;     // bf16 of padding per shared row: ldmatrix rows on distinct banks
constexpr int W_LD = BN + PAD;  // row stride of the W3 slice and of the product tile
constexpr int KT_WHOLE = 512;  // the deepest W3 slice kept in shared memory whole
constexpr int KT = 256;        // K rows of a W3 tile of a deeper slice

// K rows of the W3 slice: d padded to the MMA's k16
__host__ __device__ inline int k_pad(int d) { return (d + 15) / 16 * 16; }

// K rows of a W3 tile (and columns of an e tile): the whole slice where it
// fits (d <= 512: about 206 KB at d = 512), else KT (about 103 KB, two
// blocks an SM)
__host__ __device__ inline int k_tile(int d) {
  return k_pad(d) <= KT_WHOLE ? k_pad(d) : KT;
}

// the W3 tile [kt][W_LD], then the e tile [BM][kt + PAD], whose space the
// product tile [BM][W_LD] and the moments' reduction [WARPS][2][BN] f32 reuse
inline size_t smem_bytes(int d) {
  const int kt = k_tile(d);
  size_t tile = static_cast<size_t>(BM) * (kt + PAD) * sizeof(bf16);
  const size_t ctile = static_cast<size_t>(BM) * W_LD * sizeof(bf16);
  const size_t red = static_cast<size_t>(WARPS) * 2 * BN * sizeof(float);
  if (tile < ctile) tile = ctile;
  if (tile < red) tile = red;
  return static_cast<size_t>(kt) * W_LD * sizeof(bf16) + tile;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += A . B: A [16, 16] bf16 (row-major fragment), B [16, 8] bf16, f32 d
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 2) gate_front_bf16_kernel(
    const bf16* __restrict__ b1h, const bf16* __restrict__ b2h, const bf16* __restrict__ e,
    const bf16* __restrict__ w3, const bf16* __restrict__ b3, const int* __restrict__ src,
    const int* __restrict__ dst, bf16* __restrict__ gate, float* __restrict__ partial,
    int n_rows, int n_real, int d) {
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const int kp = k_pad(d);
  const int kt = k_tile(d);
  const bool whole = kt == kp;  // one K tile: the W3 slice loaded once
  const int e_ld = kt + PAD;
  bf16* ws = reinterpret_cast<bf16*>(smem_bf16);  // W3[kb : kb + kt, col0 : col0 + BN], [kt][W_LD]
  bf16* es = ws + kt * W_LD;                     // the e tile, then the product tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.y * BN;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // the W3 rows kb : kb + kt of the slice, zeros past d (rows k >= d,
  // columns >= d)
  const auto load_w3 = [&](int kb) {
    for (int i = tid; i < kt * (BN / 8); i += THREADS) {
      const int kr = i / (BN / 8), n8 = (i % (BN / 8)) * 8;
      const int k = kb + kr;
      bf16* p = ws + kr * W_LD + n8;
      const int col = col0 + n8;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        p[q] = k < d && col + q < d ? w3[static_cast<int64_t>(k) * d + col + q] : zero;
    }
  };
  if (whole) load_w3(0);

  // the epilogue: this lane's 8 columns of the block (a half-warp covers
  // them all), their bias, and the moments of real rows
  const int cl = (lane & 15) * 8;
  const int c = col0 + cl;
  float bias[8], m0[8], m1[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    bias[q] = c + q < d ? gnnome::to_f32(b3[c + q]) : 0.0f;
    m0[q] = m1[q] = 0.0f;
  }
  // ldmatrix addresses: A matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the
  // warp's 16 rows; B (transposed) matrices (k 0-7 | 8-15) x (n 0-7 | 8-15)
  const int wr = warp & 3, wc = warp >> 2;
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
  const bf16* a_base = es + (wr * 16 + lr) * e_ld + lc;
  const bf16* b_base = ws + lr * W_LD + wc * 64 + lc;
  const int g = lane >> 2, t = lane & 3;  // accumulator rows g, g + 8; columns 8j + 2t, + 1

  const int n_tiles = (n_rows + BM - 1) / BM;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * BM;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    // the K tiles in order, into the same accumulators: k0 runs 0, 16, ...,
    // kp - 16 whatever kt is
    for (int kb = 0; kb < kp; kb += kt) {
      // the W3 slice is in; the last tile's epilogue (or the last K tile's
      // products) are done with es and ws
      __syncthreads();
      if (!whole) load_w3(kb);
      for (int i = tid; i < BM * (kt / 8); i += THREADS) {
        const int r = i / (kt / 8), k8 = kb + (i % (kt / 8)) * 8;
        bf16* p = es + r * e_ld + (k8 - kb);
        const int row = row0 + r;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          p[q] = row < n_rows && k8 + q < d ? e[static_cast<int64_t>(row) * d + k8 + q] : zero;
      }
      __syncthreads();

      const int k_end = kp - kb < kt ? kp - kb : kt;
      for (int k0 = 0; k0 < k_end; k0 += 16) {
        uint32_t a[4];
        ldsm_x4(a, a_base + k0);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, b_base + k0 * W_LD + j * 8);
          mma_16816(acc[j], a, b[0], b[1]);
          mma_16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the e tile: the product tile takes its space
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = wc * 64 + j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(es + (wr * 16 + g) * W_LD + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(es + (wr * 16 + g + 8) * W_LD + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
    __syncthreads();

    // a half-warp per row: two rows per warp at a time
    for (int r = warp * 2 + (lane >> 4); r < BM; r += 2 * WARPS) {
      const int row = row0 + r;
      if (row >= n_rows) break;
      float p[8], x1[8], x2[8], gv[8];
      gnnome::load_vec<8>(es + r * W_LD + cl, p);
      const int64_t s_row = static_cast<int64_t>(src[row]) * d;
      const int64_t d_row = static_cast<int64_t>(dst[row]) * d;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        x1[q] = c + q < d ? gnnome::to_f32(b1h[s_row + c + q]) : 0.0f;
        x2[q] = c + q < d ? gnnome::to_f32(b2h[d_row + c + q]) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float pb = gnnome::round_to<bf16>(p[q] + bias[q]);
        gv[q] = gnnome::round_to<bf16>((pb + x1[q]) + x2[q]);
      }
      bf16* pg = gate + static_cast<int64_t>(row) * d + c;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (c + q < d) __stcs(pg + q, __float2bfloat16_rn(gv[q]));
      }
      if (row < n_real) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          m0[q] += gv[q];
          m1[q] += gv[q] * gv[q];
        }
      }
    }
  }

  // lanes l and l + 16 hold the same columns; then the warps' sums meet in
  // shared memory, red[warp][stat][BN], and leave as this block's partial row
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    m0[q] += __shfl_xor_sync(0xffffffffu, m0[q], 16);
    m1[q] += __shfl_xor_sync(0xffffffffu, m1[q], 16);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(es);
  if (lane < 16) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      red[(warp * 2) * BN + cl + q] = m0[q];
      red[(warp * 2 + 1) * BN + cl + q] = m1[q];
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * BN; i += THREADS) {
    const int stat = i / BN, col = i % BN;
    float sum = 0.0f;
    for (int w = 0; w < WARPS; ++w) sum += red[(w * 2 + stat) * BN + col];
    if (col0 + col < d) partial[(static_cast<int64_t>(blockIdx.x) * 2 + stat) * d + col0 + col] = sum;
  }
}

cudaError_t launch(const bf16* b1h, const bf16* b2h, const bf16* e, const bf16* w3,
                   const bf16* b3, const int* src, const int* dst, bf16* gate,
                   float* partial, int n_rows, int n_real, int d, int n_parts,
                   cudaStream_t s) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = gnnome::allow_smem(gate_front_bf16_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_parts, (d + BN - 1) / BN);
  gate_front_bf16_kernel<<<grid, THREADS, smem, s>>>(b1h, b2h, e, w3, b3, src, dst, gate,
                                                     partial, n_rows, n_real, d);
  return cudaGetLastError();
}

}  // namespace bf

// The TMA instance, designed for Hopper:
// - Persistent blocks, one an SM: gridDim.y column blocks of BN output
//   columns (BN from d: 256 up to d = 256, then 128, 64 or 32, the widest
//   whose W3 slice fits) times gridDim.x walkers; block (x, y) walks the
//   64-row tiles x, x + gridDim.x, ... The column blocks of a row tile run
//   at once and at the same pace, so e leaves device memory once and the
//   other column blocks find it in the L2.
// - The block's W3 column slice stays in shared memory for the whole walk:
//   loaded once, transposed 8 x 8 in registers into the K-major core-matrix
//   order of the wgmma B operand ([k / 8][BN][8], no swizzle).
// - Warpgroup 0 produces: one thread keeps TMA loads of e in flight, K
//   slices of [64 rows x 64] bf16 (128-byte rows, 128-byte swizzle; rows
//   past the end and columns past d arrive as zeros) into a ring of 4-8
//   stages on full / empty mbarriers; setmaxnreg gives its registers away.
// - Warpgroups 1 and 2 consume, tiles in turn (even and odd tiles of the
//   walk), so one's epilogue runs while the other's products run; an order
//   barrier each keeps their product loops in turn. For a tile: the
//   endpoint rows of its first rows are gathered into registers;
//   wgmma.m64nBNk16 (A: the ring's e slice by descriptor, swizzled as TMA
//   wrote it; B: the resident W3 slice) sums e . W3 in f32 registers, k16
//   step after k16 step in order, whatever BN, the ring or the grid (so
//   the gate's bits depend on neither); the product is rounded to bf16 into
//   a staging tile (stmatrix; 16-byte chunks swizzled by row); each warp
//   finishes its 16 rows, BN / 8 lanes a row with 8 columns each (the
//   endpoint rows of the first 4 steps load during the products, the rest
//   all at once after them): bias, endpoint rows, the gate stored with
//   16-byte streaming stores, the moments of real rows kept in registers.
// - The moments of the eight consumer warps meet in shared memory in a
//   fixed order and leave as the block's partial row.
// What holds it above its bound (PERF.md section 6): at d = 256 the
// epilogue's gathers and stores behind a ring of one tile; above d = 256
// the L2: every column block reads all of e from it.
namespace bfh {

using gnnome::bf16;

constexpr int TM = 64;                    // rows per tile: one wgmma m64
constexpr int KS = 64;                    // K per ring slice: one 128-byte swizzle row
constexpr int SLICE_BYTES = TM * KS * 2;  // 8 KB a stage
constexpr int THREADS = 384;              // warpgroup 0 loads, 1 and 2 compute
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// K slices of the product: d padded to whole slices (the W3 slice's rows
// past d are zeros, as TMA's e columns past d are)
__host__ __device__ inline int k_slices(int d) { return (d + KS - 1) / KS; }

// 1024 bytes of slack to align the ring for the 128-byte swizzle; the ring,
// the W3 slice [KS k_slices][BN], two staging tiles [TM][BN], the ring's
// full and empty barriers and the consumers' two order barriers
inline size_t smem_bytes(int d, int bn, int stages) {
  return 1024 + static_cast<size_t>(stages) * (SLICE_BYTES + 2 * sizeof(uint64_t)) +
         static_cast<size_t>(k_slices(d)) * KS * bn * sizeof(bf16) +
         2 * static_cast<size_t>(TM) * bn * sizeof(bf16) + 2 * sizeof(uint64_t);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// the two consumer warpgroups (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// A: a K-major [64 rows][64] bf16 slice as TMA wrote it with the 128-byte
// swizzle (a 1024-byte aligned stage): 8-row groups 1024 bytes apart
// (stride byte offset); a k16 step starts 32 bytes on in the row; the
// leading byte offset is unused for this layout
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// B: the W3 slice [k / 8][BN][8], K-major without swizzle: core matrices of
// 8 columns x 8 k, 128 contiguous bytes each; the next 8 k lie BN * 16
// bytes on (leading byte offset), the next 8 columns 128 bytes on (stride
// byte offset)
template <int BN>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(BN) << 16) |
         (uint64_t{128 >> 4} << 32);
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// the position of 16-byte chunk ch in staging row `row`: chunks swizzled
// by the row, so stmatrix's eight rows of one chunk fall on distinct banks
template <int BN>
__device__ __forceinline__ int chunk_at(int row, int ch) {
  constexpr int MASK = (BN / 8 < 8 ? BN / 8 : 8) - 1;
  return ch ^ (row & MASK);
}

#define GNNOME_D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A . B over one k16 step: A [64, 16] bf16 and B [16, N] bf16 from
// shared memory (descriptors), both K-major; scale_d = 0 overwrites d.
// d[4j + 2h + c] is row 16 * (warp % 4) + lane / 4 + 8h, column
// 8j + 2 * (lane % 4) + c.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : GNNOME_D8(0), GNNOME_D8(8)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : GNNOME_D8(0), GNNOME_D8(8), GNNOME_D8(16), GNNOME_D8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : GNNOME_D8(0), GNNOME_D8(8), GNNOME_D8(16), GNNOME_D8(24), GNNOME_D8(32),
          GNNOME_D8(40), GNNOME_D8(48), GNNOME_D8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : GNNOME_D8(0), GNNOME_D8(8), GNNOME_D8(16), GNNOME_D8(24), GNNOME_D8(32),
          GNNOME_D8(40), GNNOME_D8(48), GNNOME_D8(56), GNNOME_D8(64), GNNOME_D8(72),
          GNNOME_D8(80), GNNOME_D8(88), GNNOME_D8(96), GNNOME_D8(104), GNNOME_D8(112),
          GNNOME_D8(120)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef GNNOME_D8

template <int BN>
__global__ void __launch_bounds__(THREADS, 1) gate_front_bf16_tma_kernel(
    const __grid_constant__ CUtensorMap e_map, const bf16* __restrict__ b1h,
    const bf16* __restrict__ b2h, const bf16* __restrict__ w3, const bf16* __restrict__ b3,
    const int* __restrict__ src, const int* __restrict__ dst, bf16* __restrict__ gate,
    float* __restrict__ partial, int n_rows, int n_real, int d, int stages) {
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_tma) + 1023) & ~static_cast<uintptr_t>(1023));
  const int n_ks = k_slices(d);
  bf16* w3s = reinterpret_cast<bf16*>(ring + stages * SLICE_BYTES);
  bf16* stage_tiles = w3s + n_ks * KS * BN;  // [2][TM][BN], one per consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_tiles + 2 * TM * BN);
  uint64_t* empty = full + stages;
  uint64_t* order = empty + stages;
  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform to the compiler too (a shuffle of one lane's value), so the
  // branches below are not divergent paths for the wgmmas
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int col0 = blockIdx.y * BN;
  const int n_tiles = (n_rows + TM - 1) / TM;
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
                           ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                           : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx, then TMA's bytes
      mbar_init(&empty[s], 4);  // each warp of the warpgroup that read the stage
    }
    mbar_init(&order[0], 1);  // consumer 0 has all the K slices of a tile
    mbar_init(&order[1], 1);  // consumer 1 likewise
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The W3 slice W3[:, col0 : col0 + BN] (zeros past d) in B order: a
  // thread reads an 8 x 8 block, 8 rows k of 8 columns, and writes its
  // transpose, 8 columns of 8 k; a column's 8 k are 16 bytes.
  for (int i = tid; i < n_ks * (KS / 8) * (BN / 8); i += THREADS) {
    const int kc = i / (BN / 8), nc = i % (BN / 8);
    const int col = col0 + nc * 8;
    uint32_t in[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = kc * 8 + r;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (k < d && col < d)
        u = __ldg(reinterpret_cast<const uint4*>(w3 + static_cast<int64_t>(k) * d + col));
      in[r][0] = u.x; in[r][1] = u.y; in[r][2] = u.z; in[r][3] = u.w;
    }
    uint4* out = reinterpret_cast<uint4*>(w3s + (kc * BN + nc * 8) * 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // column j: the low or high halves of word j / 2
      const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
      out[j] = make_uint4(__byte_perm(in[0][j >> 1], in[1][j >> 1], sel),
                          __byte_perm(in[2][j >> 1], in[3][j >> 1], sel),
                          __byte_perm(in[4][j >> 1], in[5][j >> 1], sel),
                          __byte_perm(in[6][j >> 1], in[7][j >> 1], sel));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads it async
  __syncthreads();

  if (warp < 4) {
    // the producer: slice ks of the block's j-th tile goes to ring position
    // j * n_ks + ks, once the warpgroup that read that stage last is done
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (tid == 0) {
      int it = 0;
      for (int j = 0; j < my_tiles; ++j) {
        const int row0 = (static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x)) * TM;
        for (int ks = 0; ks < n_ks; ++ks, ++it) {
          const int s = it % stages;
          mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);  // the stage's last phase
          mbar_expect(&full[s], SLICE_BYTES);
          tma_load_2d(ring + s * SLICE_BYTES, &e_map, ks * KS, row0, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    constexpr int LPR = BN / 8;              // lanes of a tile row in the epilogue
    constexpr int RPI = 32 / LPR;            // rows a warp finishes at once
    constexpr int NIT = 16 / RPI;            // steps over the warp's 16 rows
    constexpr int PF = NIT < 4 ? NIT : 4;    // steps whose endpoint rows load during the products
    const int c = (warp >> 2) - 1;           // consumer 0 or 1: even or odd tiles of the walk
    const int cw = warp & 3;                 // tile rows 16 cw .. 16 cw + 15
    const int ch = lane % LPR, lr = lane / LPR;  // this lane's chunk, its row of a step
    const int cc = col0 + ch * 8;            // the chunk's first column
    const bool col_in = cc < d;
    bf16* stg = stage_tiles + c * TM * BN;
    const uint32_t ring_u32 = smem_u32(ring), w3_u32 = smem_u32(w3s);
    float bias[8], m0[8], m1[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      bias[q] = col_in ? gnnome::to_f32(b3[cc + q]) : 0.0f;
      m0[q] = m1[q] = 0.0f;
    }
    auto row0_of = [&](int j) {
      return (static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x)) * TM;
    };
    // the endpoint ids of this warp's 16 rows of tile j: lane k < 16 holds
    // src of row 16 cw + k, lane 16 + k its dst
    auto load_ids = [&](int j) {
      if (j >= my_tiles) return 0;
      const int r = row0_of(j) + cw * 16 + (lane & 15);
      return r < n_rows ? (lane < 16 ? src[r] : dst[r]) : 0;
    };
    float acc[BN / 2];
    uint4 x1[NIT], x2[NIT];
    int ids = load_ids(c);
    for (int j = c; j < my_tiles; j += 2) {
      const int row0 = row0_of(j);
      // the endpoint rows of step q (warp row q RPI + lr), zeros past the end
      auto gather = [&](int q, uint4& a, uint4& b) {
        const int rw = q * RPI + lr;
        const int s_id = __shfl_sync(0xffffffffu, ids, rw);
        const int d_id = __shfl_sync(0xffffffffu, ids, 16 + rw);
        a = b = make_uint4(0u, 0u, 0u, 0u);
        if (col_in && row0 + cw * 16 + rw < n_rows) {
          a = __ldg(reinterpret_cast<const uint4*>(b1h + static_cast<int64_t>(s_id) * d + cc));
          b = __ldg(reinterpret_cast<const uint4*>(b2h + static_cast<int64_t>(d_id) * d + cc));
        }
      };
#pragma unroll
      for (int q = 0; q < PF; ++q) gather(q, x1[q], x2[q]);  // in flight during the products

      // e . W3: the tile's K slices at ring positions j n_ks ..; a stage is
      // given back once the products that read it are done. The consumers
      // take turns: this one starts once the other has all the K slices of
      // the tile before (its order barrier), so no wait on a stage's full
      // barrier is more than one phase ahead of the loads, where its parity
      // would name a phase already passed.
      if (j > 0) mbar_wait(&order[1 - c], ((j - 1) >> 1) & 1);
      const int it0 = j * n_ks;
      auto slice = [&](int ks) {
        const int it = it0 + ks, s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
        wgmma_fence();
        const uint32_t a0 = ring_u32 + s * SLICE_BYTES;
        const uint32_t b0 = w3_u32 + ks * (KS / 8) * BN * 16;
#pragma unroll
        for (int q = 0; q < KS / 16; ++q)
          Wgmma<BN>::run(acc, a_desc(a0 + q * 32), b_desc<BN>(b0 + q * 2 * BN * 16),
                         (ks | q) != 0);
        wgmma_commit();
      };
      auto release = [&](int ks) {
        if (lane == 0) mbar_arrive(&empty[(it0 + ks) % stages]);
      };
      slice(0);
      for (int ks = 1; ks < n_ks; ++ks) {
        slice(ks);
        wgmma_wait<1>();  // slice ks - 1's products are done
        release(ks - 1);
      }
      if (warp % 4 == 0 && lane == 0) mbar_arrive(&order[c]);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
      release(n_ks - 1);
      const int next_ids = load_ids(j + 2);

      // this warp's 16 rows of the product, rounded to bf16, into its rows
      // of the staging tile: 8 x 8 blocks (rows + 0 / + 8, chunks jj, jj + 1)
      {
        const int m = lane >> 3;
        const int srow = cw * 16 + (m & 1) * 8 + (lane & 7);
        const uint32_t row_u32 = smem_u32(stg + srow * BN);
#pragma unroll
        for (int jj = 0; jj < BN / 8; jj += 2) {
          stmatrix_x4(row_u32 + chunk_at<BN>(srow, jj + (m >> 1)) * 16,
                      gnnome::pack2(acc[4 * jj], acc[4 * jj + 1]),
                      gnnome::pack2(acc[4 * jj + 2], acc[4 * jj + 3]),
                      gnnome::pack2(acc[4 * jj + 4], acc[4 * jj + 5]),
                      gnnome::pack2(acc[4 * jj + 6], acc[4 * jj + 7]));
        }
      }
      // the accumulators are free: the other steps' endpoint rows all load
      // at once
#pragma unroll
      for (int q = PF; q < NIT; ++q) gather(q, x1[q], x2[q]);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NIT; ++q) {
        const int rw = q * RPI + lr;
        const int row = row0 + cw * 16 + rw;
        const uint4 a = x1[q], b = x2[q];
        if (row < n_rows && col_in) {
          const int srow = cw * 16 + rw;
          float p[8], v1[8], v2[8], gv[8];
          gnnome::unpack8(
              *reinterpret_cast<const uint4*>(stg + srow * BN + chunk_at<BN>(srow, ch) * 8), p);
          gnnome::unpack8(a, v1);
          gnnome::unpack8(b, v2);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float pb = gnnome::round_to<bf16>(p[k] + bias[k]);
            gv[k] = gnnome::round_to<bf16>((pb + v1[k]) + v2[k]);
          }
          __stcs(reinterpret_cast<uint4*>(gate + static_cast<int64_t>(row) * d + cc),
                 gnnome::pack8(gv));
          if (row < n_real) {
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              m0[k] += gv[k];
              m1[k] += gv[k] * gv[k];
            }
          }
        }
      }
      __syncwarp();  // the next tile's stmatrix overwrites these rows
      ids = next_ids;
    }

    // the lanes of one chunk meet; then the eight consumer warps, in order,
    // in shared memory red[warp][stat][BN] (the staging tiles' space)
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        m0[k] += __shfl_xor_sync(0xffffffffu, m0[k], off);
        m1[k] += __shfl_xor_sync(0xffffffffu, m1[k], off);
      }
    }
    consumers_sync();  // every consumer warp is done with the staging tiles
    float* red = reinterpret_cast<float*>(stage_tiles);
    const int cwarp = warp - 4;
    if (lr == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        red[(cwarp * 2) * BN + ch * 8 + k] = m0[k];
        red[(cwarp * 2 + 1) * BN + ch * 8 + k] = m1[k];
      }
    }
    consumers_sync();
    for (int i = tid - 128; i < 2 * BN; i += 256) {
      const int stat = i / BN, col = i % BN;
      float sum = 0.0f;
      for (int w = 0; w < 8; ++w) sum += red[(w * 2 + stat) * BN + col];
      if (col0 + col < d)
        partial[(static_cast<int64_t>(blockIdx.x) * 2 + stat) * d + col0 + col] = sum;
    }
  }
}

// a launch of the BN instance: n_parts walkers of each of the (d / BN)
// column blocks
template <int BN>
cudaError_t launch(const CUtensorMap& map, const bf16* b1h, const bf16* b2h, const bf16* w3,
                   const bf16* b3, const int* src, const int* dst, bf16* gate,
                   float* partial, int n_rows, int n_real, int d, int n_parts, int stages,
                   size_t smem, cudaStream_t s) {
  cudaError_t err = gnnome::allow_smem(gate_front_bf16_tma_kernel<BN>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_parts, (d + BN - 1) / BN);
  gate_front_bf16_tma_kernel<BN><<<grid, THREADS, smem, s>>>(map, b1h, b2h, w3, b3, src, dst,
                                                             gate, partial, n_rows, n_real, d,
                                                             stages);
  return cudaGetLastError();
}

}  // namespace bfh

}  // namespace

// partial: scratch f32 [n_parts, 2, d]; n_parts blocks walk the 128-row
// tiles. w3_split: scratch f32 [2, ceil(d / 256), n_ks, 16, 256] with
// n_ks = 2 * ceil(d / 32) (the hi and lo parts). vec4: d % 4 == 0 and the
// row tensors' bases 16-byte aligned.
GNNOME_API int gnnome_gate_front_f32(
    const float* b1h, const float* b2h, const float* e, const float* w3,
    const float* b3, const int* src, const int* dst, float* gate,
    float* partial, float* mom, float* w3_split, int64_t n_rows, int64_t n_real, int d,
    int n_parts, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts < 1 || d < 1 || n_rows > (int64_t{1} << 31) - 2 * BM)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ks = 2 * ((d + 2 * BK - 1) / (2 * BK));
  const int64_t part = static_cast<int64_t>((d + BN - 1) / BN) * 2 * n_ks * B_FLOATS;
  float* w_hi = w3_split;
  float* w_lo = w3_split + part;
  w3_split_kernel<<<gnnome::grid_for(part, 256), 256, 0, s>>>(w3, w_hi, w_lo, d, n_ks, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = static_cast<int>(n_rows);
  const int real = static_cast<int>(n_real < n_rows ? n_real : n_rows);
  err = vec4 ? launch_front<4>(b1h, b2h, e, w_hi, w_lo, b3, src, dst, gate, partial, rows,
                               real, d, n_ks, n_parts, s)
             : launch_front<1>(b1h, b2h, e, w_hi, w_lo, b3, src, dst, gate, partial, rows,
                               real, d, n_ks, n_parts, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_reduce_kernel<<<(2 * d + 31) / 32, 256, 0, s>>>(partial, mom, n_parts, d);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 entry: b1h, b2h, e, w3, b3 and gate bf16; partial (scratch f32
// [n_parts, 2, d]) and mom f32. The launch plan comes from the wrapper
// (ops/gate_front.py gate_front_bf16_plan): bn > 0 runs the TMA instance with
// BN = bn and a ring of `stages` K slices (d % 8 == 0 and the row tensors'
// bases 16-byte aligned), bn = 0 the element-wise instance (any d). Either
// takes the shared memory of its own layout, and a plan past the card's
// 232,448 bytes a block is refused. n_parts blocks of each column block walk
// the 64-row tiles.
GNNOME_API int gnnome_gate_front_bf16(
    const gnnome::bf16* b1h, const gnnome::bf16* b2h, const gnnome::bf16* e,
    const gnnome::bf16* w3, const gnnome::bf16* b3, const int* src, const int* dst,
    gnnome::bf16* gate, float* partial, float* mom, int64_t n_rows, int64_t n_real, int d,
    int n_parts, int bn, int stages, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_parts < 1 || d < 1 || n_rows > (int64_t{1} << 31) - 2 * bf::BM ||
      (bn > 0 && (stages < 2 || d % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bn > 0 ? bfh::smem_bytes(d, bn, stages) : bf::smem_bytes(d);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(n_rows);
  const int real = static_cast<int>(n_real < n_rows ? n_real : n_rows);
  if (bn > 0) {
    // the e slices [64 rows][64] bf16, 128-byte swizzle, zeros outside
    CUtensorMap map = {};
    err = tensor_map_2d(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, e, sizeof(gnnome::bf16), n_rows,
                        d, bfh::KS, bfh::TM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
#define GNNOME_LAUNCH(N)                                                                   \
  bfh::launch<N>(map, b1h, b2h, w3, b3, src, dst, gate, partial, rows, real, d, n_parts, \
                 stages, smem, s)
    switch (bn) {
      case 32: err = GNNOME_LAUNCH(32); break;
      case 64: err = GNNOME_LAUNCH(64); break;
      case 128: err = GNNOME_LAUNCH(128); break;
      case 256: err = GNNOME_LAUNCH(256); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef GNNOME_LAUNCH
  } else {
    err = bf::launch(b1h, b2h, e, w3, b3, src, dst, gate, partial, rows, real, d, n_parts, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_reduce_kernel<<<(2 * d + 31) / 32, 256, 0, s>>>(partial, mom, n_parts, d);
  return static_cast<int>(cudaGetLastError());
}
