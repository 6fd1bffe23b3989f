// Grouped expert GEMM over rows sorted by expert, for Hopper (sm_90a),
// written by hand.
//
// Replaces the TPU kernel `grouped_gemm` (`_gemm_kernel`) of
// src/repro/kernels/moe_gemm.py: per-expert matmuls with f32 accumulation
// and the output in the input's dtype. One source serves both entry points
// of repro_torch/kernels/moe_gemm.py:
//   * segments: x (N, d) whose rows are grouped by expert (expert e's
//     counts[e] rows right after expert e-1's), counts (E,) int32 on the
//     device, w (E, d, f) -> out (N, f). The MoE FFN's dispatch calls it
//     three times per layer (gate, up, down).
//   * the reference's (E, C, d) x (E, d, f) -> (E, C, f): uniform segments
//     of C rows.
// Rows past sum(counts) are not written. d and f are multiples of 8
// (DeepSeek's 2048 and 1408), x, w and out 16-byte aligned. (The port's
// dense prefill linear has a kernel of its own, csrc/dense_gemm.cu.)
//
// The TPU kernel's grid was (E, C / bc, f / bf, d / bd) over a padded
// (E, C, d) layout with the contraction as its sequential axis. Here the
// segment sizes stay on the device: every block scans the E counts into
// shared memory (tiles per expert and rows before it) and walks a work
// list of (expert tile, column strip) items built from them, so no host
// sync is needed and experts no row chose cost nothing.
//
// What bounds it on the H100: at a prefill wave (16 x 512 tokens x 6
// choices = 49 152 rows, ~770 an expert) the tensor cores' bf16 rate
// (283.5 GFLOP: 0.29 ms); at decode (16 x 6 = 96 rows over 64 experts, 1-2
// an expert) the weight bytes over the memory rate (318 MB: 0.095 ms). The
// first design (WMMA mma.sync on 128 x 128 tiles, two cp.async stages, one
// block per tile) reached 16 % of the first bound and 35 % of the second:
// mma.sync runs at a fraction of the wgmma rate, two stages hide little
// latency, and at decode each block multiplied a whole 128-row tile of
// padding for one or two rows.
//
// The bf16 route now:
//   * wgmma.mma_async on the tensor cores, fed by TMA (cp.async.bulk.tensor)
//     into a ring of kStages shared-memory stages guarded by mbarriers
//     (full: the producer's expect_tx and the TMA bytes; empty: every
//     consumer thread's arrival). Each stage holds a 64-deep k-slice, 128
//     bytes wide, 128B-swizzled. One producer thread issues the loads; one
//     or two consumer warpgroups issue the wgmmas, keeping one k-slice's
//     group in flight while they release the stage before it.
//   * w (E, d, f) is read through a 3-D tensor map (f, d, E), so a k-slice
//     past d is zero-filled by TMA instead of reading the next expert's
//     weights; w's f is contiguous, so its tiles are MN-major in shared
//     memory and wgmma takes them through its transpose bit (no copy of the
//     weights). x is a 2-D map (d, N): rows past N are zero-filled.
//   * A persistent grid, one block an SM (the wrapper passes the SM count):
//     block i takes items i, i + grid, ...; the producer runs ahead into
//     the next item's loads while the consumers store the last one.
//   * Two tile shapes of one kernel template, chosen on the host from (N,
//     E) alone (kernels/moe_gemm.py: gemm_shape):
//       Wide (prefill): 128 rows x 128 columns an item, two consumer
//       warpgroups of m64n128k16 (rows 0-63 and 64-127).
//       Narrow, swap-AB (decode): out^T = w^T x^T. An item is 64 columns of
//       one expert's f (wgmma's M side, from the weight tile) by 16 of its
//       rows (a narrow N), one consumer warpgroup of m64n16k16: no tensor
//       work goes to padding rows, and the kernel becomes a stream of
//       weight bytes kept in flight by a deep ring.
//   * Partial tiles: rows past an expert's segment belong to the next
//     expert; they are loaded but never stored. Wide outputs leave through
//     shared memory: a warpgroup whose 64 rows all belong to the item
//     hands them to one TMA store and goes on to its next item while the
//     store runs; a partial one copies its valid rows out in masked
//     16-byte chunks (a TMA store would write the neighbour's rows).
//     Narrow outputs (a few hundred KB a decode step) leave straight from
//     registers under a row and column mask.
//   * No split-K and no atomics: each output is one accumulator summed in
//     k order, so two launches on the same inputs give the same bits.
//
// Measured on the H100 (PERF.md): at a prefill wave the load pipeline
// alone, with no wgmma and no store, takes about as long as the whole
// kernel: every 128 x 128 item streams its x and w k-slices out of the L2
// again (~5 GB a wave, ~10 TB/s). Wider items or TMA multicast across a
// cluster of blocks, which cut those bytes, are the next step.
// f32 runs on the CUDA cores on 64 x 64 tiles (4 x 8 outputs a thread),
// one block per (row tile + E spare, column strip), as before.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace gemm {

using namespace repro::hopper;

// ------------------------------------------------------------- f32 ----
// f32 runs on common.cuh's tile_f32, 64 x 64 tiles on the CUDA cores.

// Warp 0's inclusive scans of tiles and rows per expert, 32 experts at a
// time: tile_lo[e] = tiles before expert e, row_lo[e] = rows before it,
// tile_lo[E] and row_lo[E] the totals. Negative counts count as 0.
__device__ void scan_counts(const int* __restrict__ counts, int E, int bm,
                            int* tile_lo, int* row_lo) {
  const int lane = threadIdx.x % 32;
  int tiles_base = 0, rows_base = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int c = e < E ? max(0, __ldg(counts + e)) : 0;
    const int nt = (c + bm - 1) / bm;
    int st = nt, sr = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, st, off);
      const int r = __shfl_up_sync(0xffffffffu, sr, off);
      if (lane >= off) {
        st += a;
        sr += r;
      }
    }
    if (e < E) {
      tile_lo[e] = tiles_base + st - nt;
      row_lo[e] = rows_base + sr - c;
    }
    tiles_base += __shfl_sync(0xffffffffu, st, 31);
    rows_base += __shfl_sync(0xffffffffu, sr, 31);
  }
  if (lane == 0) {
    tile_lo[E] = tiles_base;
    row_lo[E] = rows_base;
  }
}

// Which rows tile t is: the expert whose tile range holds it (the last e
// with tile_lo[e] <= t, so experts with no tile are passed over), its first
// row and its row count, cut at N. Returns the row count (<= 0: nothing).
__device__ __forceinline__ int find_tile(const int* tile_lo,
                                         const int* row_lo, int E, int bm,
                                         int N, int t, int& e, int& row0) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tile_lo[mid] <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  e = lo;
  const int k = t - tile_lo[e];
  row0 = row_lo[e] + k * bm;
  const int rows = min(bm, row_lo[e + 1] - row0);
  return min(rows, N - row0);
}

__global__ void __launch_bounds__(kF32Threads)
grouped_gemm_f32(const float* __restrict__ x, const int* __restrict__ counts,
                 const float* __restrict__ w, float* __restrict__ out, int N,
                 int E, int d, int f) {
  extern __shared__ int s_scan[];  // tile_lo[E + 1], row_lo[E + 1]
  int* tile_lo = s_scan;
  int* row_lo = s_scan + E + 1;
  if (threadIdx.x < 32) scan_counts(counts, E, kF32BM, tile_lo, row_lo);
  __syncthreads();
  const int t = blockIdx.x;
  if (t >= tile_lo[E]) return;  // a spare tile of the grid
  int e, row0;
  const int rows = find_tile(tile_lo, row_lo, E, kF32BM, N, t, e, row0);
  if (rows <= 0) return;  // counts past N are cut at N
  tile_f32<false>(x + (long long)row0 * d, w + (long long)e * d * f,
                  out + (long long)row0 * f, rows, d, f, blockIdx.y * kF32BN);
}

// ------------------------------------------------------------ bf16 ----
using bf16 = __nv_bfloat16;
constexpr int kBK = 64;             // k-slice: 64 bf16 = 128 bytes

// Prefill: 128 rows x 128 columns an item, two consumer warpgroups, each
// m64n128k16 over 64 of the rows: A = the x tile (K-major), B = the w tile
// (MN-major, two 64-column TMA boxes side by side).
struct Wide {
  static constexpr int kRows = 128, kCols = 128, kConsumers = 2;
  static constexpr int kStages = 5;
  static constexpr int kXBytes = kRows * 128;  // x: 128 rows x 128 B
  static constexpr int kWBytes = (kCols / 64) * kBox;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kAcc = 64;  // m64n128: 64 f32 a thread

  __device__ static void mma(float (&acc)[kAcc], const unsigned char* st,
                             int cw) {
    const unsigned char* a = st + cw * 64 * 128;
    const unsigned char* b = st + kXBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n128<0, 1>(acc, smem_desc(a + kk * 32, 16, 1024),
                          smem_desc(b + kk * 16 * 128, kBox, 1024));
  }

  // Each consumer warpgroup stages its 64 x 128 bf16 outputs in shared
  // memory as two 64 x 64 boxes, 128B-swizzled as TMA lays them out (and
  // free of bank conflicts for the accumulator layout's writes).
  static constexpr int kStaging = kConsumers * 2 * kBox;

  // accumulator (row r, column c) -> out[row0 + r, n0 + c]. A warpgroup
  // whose 64 rows all belong to the item hands them to one TMA store and
  // goes on to its next item while the store runs; a partial one (rows
  // past the expert's segment are the next expert's) copies its valid
  // rows out in 16-byte chunks. Columns past f are clipped by the tensor
  // map or masked.
  __device__ static void store(const float (&acc)[kAcc], unsigned char* stg,
                               const CUtensorMap* tmo,
                               bf16* __restrict__ out, int row0, int rows,
                               int n0, int f, int cw, int ct) {
    const int warp = ct / 32, lane = ct % 32;
    stg += cw * 2 * kBox;
    if (ct == 0) bulk_wait_read();  // the last store has left the staging
    warpgroup_bar(1 + cw);
#pragma unroll
    for (int nb = 0; nb < kCols / 8; ++nb) {
      const int box = nb / 8, c16 = nb % 8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + lane / 4 + 8 * i;
        *reinterpret_cast<__nv_bfloat162*>(
            stg + box * kBox + r * 128 + ((c16 ^ (r & 7)) << 4) +
            (lane % 4) * 4) =
            __floats2bfloat162_rn(acc[nb * 4 + i * 2],
                                  acc[nb * 4 + i * 2 + 1]);
      }
    }
    fence_async_shared();
    warpgroup_bar(1 + cw);
    const int r0 = cw * 64;  // this warpgroup's first row of the item
    if (rows >= r0 + 64) {
      if (ct == 0) {
        for (int box = 0; box < 2 && n0 + box * 64 < f; ++box)
          tma_store_2d(tmo, stg + box * kBox, n0 + box * 64, row0 + r0);
        bulk_commit();
      }
      return;
    }
    for (int idx = ct; idx < 2 * 64 * 8; idx += 128) {
      const int box = idx / 512, r = (idx / 8) % 64, c16 = idx % 8;
      const int col = n0 + box * 64 + c16 * 8;
      if (r0 + r < rows && col < f)
        *reinterpret_cast<uint4*>(out + (long long)(row0 + r0 + r) * f +
                                  col) =
            *reinterpret_cast<const uint4*>(stg + box * kBox + r * 128 +
                                            ((c16 ^ (r & 7)) << 4));
    }
  }
};

// Decode, swap-AB: 64 columns x 16 rows an item, one consumer warpgroup of
// m64n16k16: A = the w tile (its 64 f columns as wgmma's M, MN-major), B =
// the x tile (its 16 rows as N, K-major).
struct Narrow {
  static constexpr int kRows = 16, kCols = 64, kConsumers = 1;
  static constexpr int kStages = 12;
  static constexpr int kXBytes = kRows * 128;
  static constexpr int kWBytes = kBox;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kAcc = 8;  // m64n16: 8 f32 a thread

  __device__ static void mma(float (&acc)[kAcc], const unsigned char* st,
                             int) {
    const unsigned char* a = st + kXBytes;
    const unsigned char* b = st;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_m64n16<1, 0>(acc, smem_desc(a + kk * 16 * 128, kBox, 1024),
                         smem_desc(b + kk * 32, 16, 1024));
  }

  static constexpr int kStaging = 0;

  // accumulator (column c of f, row r) -> out[row0 + r, n0 + c], straight
  // from registers (a decode step's outputs are a few hundred KB)
  __device__ static void store(const float (&acc)[kAcc], unsigned char*,
                               const CUtensorMap*, bf16* __restrict__ out,
                               int row0, int rows, int n0, int f, int,
                               int ct) {
    const int warp = ct / 32, lane = ct % 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = n0 + warp * 16 + lane / 4 + 8 * i;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = nb * 8 + (lane % 4) * 2 + j;
          if (r < rows && col < f)
            out[(long long)(row0 + r) * f + col] =
                __float2bfloat16(acc[nb * 4 + i * 2 + j]);
        }
    }
  }
};

template <class Cfg>
int smem_bytes(int E) {
  return 1024 + Cfg::kStages * Cfg::kStageBytes + Cfg::kStaging +
         2 * Cfg::kStages * 8 + 2 * (E + 1) * 4;
}

// Warpgroup 0 is the producer (one thread issues every TMA load); the
// warpgroups after it are the consumers. Both walk the same work list:
// item it = (tile it / strips, column strip it % strips).
template <class Cfg>
__global__ void __launch_bounds__((Cfg::kConsumers + 1) * 128, 1)
grouped_gemm_bf16(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmw,
                  const __grid_constant__ CUtensorMap tmo,
                  const int* __restrict__ counts, bf16* __restrict__ out,
                  int N, int E, int d, int f) {
  constexpr int S = Cfg::kStages, SB = Cfg::kStageBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* staging = smem + S * SB;  // the wide epilogue's
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + Cfg::kStaging);
  uint64_t* empty = full + S;
  int* tile_lo = reinterpret_cast<int*>(empty + S);
  int* row_lo = tile_lo + E + 1;

  const int tid = threadIdx.x;
  if (tid < 32) scan_counts(counts, E, Cfg::kRows, tile_lo, row_lo);
  if (tid == 32) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, Cfg::kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int strips = (f + Cfg::kCols - 1) / Cfg::kCols;
  const int items = tile_lo[E] * strips;
  const int nk = (d + kBK - 1) / kBK;
  const int wg = tid / 128;
  int stage = 0;
  uint32_t phase = 0;

  if (wg == 0) {
    if (tid != 0) return;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      int e, row0;
      if (find_tile(tile_lo, row_lo, E, Cfg::kRows, N, it / strips, e,
                    row0) <= 0)
        continue;
      const int n0 = (it % strips) * Cfg::kCols;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(empty + stage, phase ^ 1);  // the consumers freed it
        unsigned char* st = smem + stage * SB;
        mbar_expect_tx(full + stage, SB);
        tma_load_2d(st, &tmx, full + stage, kb * kBK, row0);
#pragma unroll
        for (int j = 0; j < Cfg::kCols / 64; ++j)
          tma_load_3d(st + Cfg::kXBytes + j * kBox, &tmw, full + stage,
                      n0 + j * 64, kb * kBK, e);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int cw = wg - 1;
  const int ct = tid % 128;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int e, row0;
    const int rows = find_tile(tile_lo, row_lo, E, Cfg::kRows, N,
                               it / strips, e, row0);
    if (rows <= 0) continue;
    const int n0 = (it % strips) * Cfg::kCols;
    float acc[Cfg::kAcc];
#pragma unroll
    for (int i = 0; i < Cfg::kAcc; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full + stage, phase);  // this k-slice has landed
      wgmma_fence();
      Cfg::mma(acc, smem + stage * SB, cw);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-slice's products are done
      if (prev >= 0) mbar_arrive(empty + prev);
      prev = stage;
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty + prev);
    Cfg::store(acc, staging, &tmo, out, row0, rows, n0, f, cw, ct);
  }
  if (Cfg::kStaging && ct == 0) bulk_wait();  // the last TMA stores
}

// ------------------------------------------------------------- host ----
// x as a 2-D (d, N) map of (64, rows) boxes; w as a 3-D (f, d, E) map of
// (64, 64, 1) boxes; both 128B-swizzled, out-of-range elements read as 0.
bool encode_maps(CUtensorMap* mx, CUtensorMap* mw, const void* x,
                 const void* w, int N, int E, int d, int f, int rows) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t wdim[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)E};
  const cuuint64_t wstride[2] = {(cuuint64_t)f * 2, (cuuint64_t)d * f * 2};
  const cuuint32_t wbox[3] = {64, 64, 1};
  CUresult rw = fn(mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(w), wdim, wstride, wbox, one,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rw == CUDA_SUCCESS &&
         encode_bf16_2d(mx, x, d, N, 64, rows,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

template <class Cfg>
cudaError_t launch_bf16(const void* x, const int* counts, const void* w,
                        void* out, int N, int E, int d, int f, int grid,
                        cudaStream_t stream) {
  CUtensorMap mx, mw, mo = {};
  if (!encode_maps(&mx, &mw, x, w, N, E, d, f, Cfg::kRows) ||
      (Cfg::kStaging &&  // the wide epilogue's TMA stores, clipped at f, N
       !encode_bf16_2d(&mo, out, f, N, 64, 64,
                       CU_TENSOR_MAP_L2_PROMOTION_NONE)))
    return cudaErrorInvalidValue;
  auto kernel = grouped_gemm_bf16<Cfg>;
  const int smem = smem_bytes<Cfg>(E);
  static int smem_allowed = 0;  // the largest limit set so far
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  kernel<<<grid, (Cfg::kConsumers + 1) * 128, smem, stream>>>(
      mx, mw, mo, counts, static_cast<bf16*>(out), N, E, d, f);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const int* counts, const void* w,
                       void* out, int N, int E, int d, int f,
                       cudaStream_t stream) {
  dim3 grid((N + kF32BM - 1) / kF32BM + E, (f + kF32BN - 1) / kF32BN);
  const int smem = 2 * (E + 1) * 4;
  grouped_gemm_f32<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(x), counts, static_cast<const float*>(w),
      static_cast<float*>(out), N, E, d, f);
  return cudaGetLastError();
}

constexpr int kMaxE = 4096;  // experts whose scan fits in shared memory

}  // namespace gemm
}  // namespace repro

// x (N, d) rows grouped by expert; counts (E,) int32; w (E, d, f); out
// (N, f); d and f multiples of 8, x, w and out 16-byte aligned. bf16:
// shape 0 = wide (prefill), 1 = narrow swap-AB (decode), on a persistent
// grid of `grid` blocks (the SM count); f32 ignores both. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int grouped_gemm_fwd(const void* x, const int* counts,
                                const void* w, void* out, int N, int E, int d,
                                int f, int dtype, int shape, int grid,
                                void* stream) {
  if (N == 0 || f == 0) return 0;
  if (E < 1 || E > repro::gemm::kMaxE || d < 1 || N < 0 || f < 0 ||
      d % 8 != 0 || f % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16) {
    if (grid < 1) return cudaErrorInvalidValue;
    if (shape == 0)
      return static_cast<int>(repro::gemm::launch_bf16<repro::gemm::Wide>(
          x, counts, w, out, N, E, d, f, grid, st));
    if (shape == 1)
      return static_cast<int>(repro::gemm::launch_bf16<repro::gemm::Narrow>(
          x, counts, w, out, N, E, d, f, grid, st));
    return cudaErrorInvalidValue;
  }
  if (dtype == REPRO_F32)
    return static_cast<int>(
        repro::gemm::launch_f32(x, counts, w, out, N, E, d, f, st));
  return cudaErrorInvalidValue;
}
