// The prefill linear, a dense GEMM for Hopper (sm_90a), written by hand.
//
// It replaces no TPU kernel: the reference leaves its projections, MLP
// GEMMs and unembedding to XLA (src/repro/models/layers.py:150). It exists
// for row invariance. A shared-prefix prefill computes a prompt's tail rows
// in a smaller wave than a cold prefill does, and its tokens must carry the
// cold wave's bits; cuBLAS picks a split-K from the shape (one at 128 rows
// of the MLP's down projection, none at 512), so one row got other bits in
// another wave size.
//
// Contract (kernels/dense_gemm.py: dense_gemm_cuda): x (M, K) times w (K, N),
// or w (N, K) read K-major in place (the tied unembedding's tok), -> out
// (M, N) in x's dtype, f32 accumulation; bf16 or f32; K and N multiples of
// 8; x, w and out 16-byte aligned (TMA's strides).
//
// The row-invariance contract, bf16. The plan is the caller's
// (kernels/dense_gemm.py: dense_gemm_plan, the one copy of it), passed in
// as integers: it reads K and N and nothing else, not M, not the SM count
// of the card (it is sized for an H100's 132 SMs, a constant). It fixes the
// wgmma accumulator (64 columns, m64n64k16; 128, m64n128k16, where 64 cannot
// cover the card) and a K split: S chunks of `chunk` 64-deep k-slices
// each, the last one short where the k-slices run out, and a ragged last
// k-slice zero-filled by TMA. Every output is
//   ((p_0 + p_1) + p_2) + ... + p_{S-1}
// in f32, p_s one fresh f32 accumulator over chunk s's k-slices in k order,
// rounded once to bf16. So a row's bits depend on that row, w and (K, N)
// alone. Where the sum is carried out depends on M and the card, which
// changes no bit; the caller picks it too (dense_gemm.py: across,
// block_cols):
//   * across blocks (few row tiles): a cluster of S blocks a tile, block s
//     running chunk s and leaving p_s in its shared memory; each block of
//     the cluster then folds a slice of the tile's rows, reading the S
//     partials through distributed shared memory in chunk order. No
//     workspace in device memory, no second pass, no float atomics;
//   * inside one block (many row tiles): the block adds each fresh chunk
//     accumulator into a second register accumulator in the same order,
//     which needs no bytes outside the block.
// A block of a 64-column plan takes 128 columns (m64n128k16 in place of
// m64n64k16) once the call's 128-column tiles fill the card. On the card
// the two instructions give an output the same bits on the same k-slices
// (each output is its own sum over k), which the row-bits sweeps check
// across that switch too; PTX does not promise it, so a new CUDA toolkit
// or driver is to be checked again (ROADMAP.md). f32 runs on the CUDA cores
// on common.cuh's 64 x 64 tiles, one fmaf chain an output over K in order,
// whatever M: row-invariant as it is, with one summation order.
//
// What bounds it on the H100: at a wave's rows the tensor cores' bf16 rate
// (SmolLM2's down projection at 8192 rows: 275 GFLOP, 0.28 ms); at a tail
// wave's 128 rows and for the unembedding at 16 rows the weight bytes over
// the memory rate (down: 36 MB, 0.011 ms; tok: 201 MB, 0.061 ms). What the
// design does about each of the things that held the grouped GEMM's
// one-group route back (PERF.md):
//   1. The card was not filled at small M (128 rows at N = 2048: 16 tiles
//      for 132 SMs). The 64-column accumulator doubles the tiles, and S is
//      chosen so that one row tile's blocks cover three quarters of the
//      card in clusters that fit it at once (S = 3 at 2048 -> 2048 and 8192
//      -> 2048: 96 blocks in 32 clusters, and an H100 holds 39 clusters of
//      3 such blocks at once). A K split fixed by (K, N) keeps a row's bits
//      free of M, which cuBLAS's shape-chosen split-K does not. At 512 rows
//      the 64-column tiles give 128 blocks where 128-column ones gave 64.
//   2. At large M the same operands came out of the L2 again and again: a
//      block takes 128 columns (one x tile feeds all of them), the tiles
//      are rastered in groups of 8 row tiles, so the blocks in flight
//      share w's column tiles and x's row tiles while they are in the L2,
//      and the producer warpgroup gives its registers to the consumers
//      (setmaxnreg), which hold the running total beside the fresh
//      accumulator. The L2 traffic still bounds the large-M route.
//   3. The grouped GEMM's machinery: no `counts` scan and no expert work
//      list; the tiles of one dense work list.
//   4. The host: every tensor map comes from a cache keyed by all that it
//      encodes (`cached_map`), so a weight's maps are encoded once, and the
//      wrapper passes the plan and route it keeps memoized: one C call, one
//      launch, no device query.
//
// The pipeline: warpgroup 0's one thread issues TMA loads
// (cp.async.bulk.tensor) into a ring of stages, each a 64-deep k-slice of
// x (128 rows) and w (the block's columns), 128B-swizzled, guarded by
// mbarriers; warpgroups 1 and 2 issue wgmma.mma_async over rows 0-63 and
// 64-127, keeping one k-slice's group in flight while they release the
// stage before it. w (K, N) is MN-major in shared memory and wgmma reads it
// through its transpose bit; w (N, K) is one box of the block's rows x 64
// deep laid out as the x tile is, read without it (the unembedding's 201
// MB tok in place). The inside route runs a persistent grid of one block
// an SM and stores through shared memory by TMA (rows past M and columns
// past N clipped by the map); the across route one block a (tile, chunk),
// S blocks a cluster.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace dense {

using namespace repro::hopper;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ tiles ----
constexpr int kBK = 64;      // k-slice: 64 bf16 = 128 bytes
constexpr int kRows = 128;   // a tile's rows: two consumer warpgroups of 64
constexpr int kGroup = 8;    // row tiles a raster group spans
constexpr int kMaxSplit = 16;  // chunks a cluster of blocks folds

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// k-slices [lo, hi) of chunk s of `chunk` k-slices, cut at nk
__device__ __forceinline__ void chunk_of(int s, int chunk, int nk, int& lo,
                                         int& hi) {
  lo = s * chunk;
  hi = min(lo + chunk, nk);
}

// tile t -> (row tile m, column tile n), rastered in groups of kGroup row
// tiles: consecutive tiles walk down a group's rows, then across columns
__device__ __forceinline__ void tile_of(int t, int mt, int nt, int& m,
                                        int& n) {
  const int per = kGroup * nt;
  const int first = (t / per) * kGroup;
  const int gm = min(kGroup, mt - first);
  const int r = t % per;
  m = first + r % gm;
  n = r / gm;
}

// ------------------------------------------------------------- bf16 ----
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;

// A block's tile: 128 rows x kCols (64 or 128) columns, each consumer
// warpgroup one m64n{kCols}k16 accumulator over 64 of the rows; w MN-major
// (kCols / 64 TMA boxes of 64 columns x 64 k side by side) or K-major (one
// box of kCols rows x 64 k, laid out as the x tile is).
template <int kCols_, bool kKMajorW_>
struct Cfg {
  static constexpr int kCols = kCols_;
  static constexpr bool kKMajorW = kKMajorW_;
  static constexpr int kAcc = kCols / 2;  // f32 a thread
  static constexpr int kXBytes = kRows * 128;
  static constexpr int kWBytes = kCols * 128;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kStages = 196608 / kStageBytes;  // 6 or 8
  static constexpr int kStaging = kConsumers * (kCols / 64) * kBox;
  static constexpr int kSmem =
      1024 + kStages * kStageBytes + kStaging + 2 * kStages * 8;
  // the across route's partial sums, f32 [kRows][kPart], over the ring
  static constexpr int kPart = kCols + 4;
  static_assert(kRows * kPart * 4 <= kStages * kStageBytes, "partials");

  __device__ static void mma(float (&acc)[kAcc], const unsigned char* st,
                             int cw) {
    const unsigned char* a = st + cw * 64 * 128;
    const unsigned char* b = st + kXBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
      const uint64_t db = kKMajorW ? smem_desc(b + kk * 32, 16, 1024)
                                   : smem_desc(b + kk * 16 * 128, kBox, 1024);
      if constexpr (kCols == 128)
        wgmma_m64n128<0, kKMajorW ? 0 : 1>(acc, da, db);
      else
        wgmma_m64n64<0, kKMajorW ? 0 : 1>(acc, da, db);
    }
  }
};

// This warpgroup's 64 x kCols outputs -> out[row0 + cw * 64 .., n0 ..] in
// bf16 through 64 x 64 boxes of shared memory, 128B-swizzled as TMA lays
// them out, and TMA stores clipped at M and N. The warpgroup goes on to its
// next item while the stores run.
template <class C>
__device__ __forceinline__ void store_bf16(const float (&acc)[C::kAcc],
                                           unsigned char* stg,
                                           const CUtensorMap* tmo, int row0,
                                           int n0, int N, int cw, int ct) {
  constexpr int kBoxes = C::kCols / 64;
  const int warp = ct / 32, lane = ct % 32;
  stg += cw * kBoxes * kBox;
  if (ct == 0) bulk_wait_read();  // the last stores have left the staging
  warpgroup_bar(1 + cw);
#pragma unroll
  for (int nb = 0; nb < C::kCols / 8; ++nb) {
    const int box = nb / 8, c16 = nb % 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + lane / 4 + 8 * i;
      *reinterpret_cast<__nv_bfloat162*>(
          stg + box * kBox + r * 128 + ((c16 ^ (r & 7)) << 4) +
          (lane % 4) * 4) =
          __floats2bfloat162_rn(acc[nb * 4 + i * 2], acc[nb * 4 + i * 2 + 1]);
    }
  }
  fence_async_shared();
  warpgroup_bar(1 + cw);
  if (ct == 0) {
    for (int box = 0; box < kBoxes && n0 + box * 64 < N; ++box)
      tma_store_2d(tmo, stg + box * kBox, n0 + box * 64, row0 + cw * 64);
    bulk_commit();
  }
}

__device__ __forceinline__ void setmaxnreg_dec40() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_inc232() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the shared-memory address `a` of this block at the same offset in block
// `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// The across route's fold, inside the tile's cluster of S blocks (block s
// computed p_s into its shared memory): block `rank` takes rows [rank *
// 128 / S, (rank + 1) * 128 / S) of the tile, reads each output's S
// partials from the S blocks in chunk order, ((p_0 + p_1) + ...) + p_{S-1},
// and stores it in bf16 (rows past M and columns past N masked). A thread
// takes 8 / S groups of four outputs a round (neighbouring threads on
// neighbouring groups), all their loads in flight before the adds.
template <class C, int S>
__device__ __forceinline__ void fold_cluster(const float* part, int rank,
                                             bf16* __restrict__ out, int row0,
                                             int n0, int M, int N, int ct) {
  constexpr int kQuads = C::kCols / 4, kG = S < 8 ? 8 / S : 1;
  constexpr int kT = kConsumers * 128;
  const int r0 = rank * kRows / S, r1 = (rank + 1) * kRows / S;
  const int total = (r1 - r0) * kQuads;
  const uint32_t base = smem_u32(part);
  for (int i0 = ct; i0 < total; i0 += kT * kG) {
    float4 v[kG][S];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int i = min(i0 + g * kT, total - 1);
      const int r = r0 + i / kQuads, c = (i % kQuads) * 4;
      const uint32_t a = base + (uint32_t)(r * C::kPart + c) * 4;
#pragma unroll
      for (int q = 0; q < S; ++q)  // this block's own p_rank from its own
        v[g][q] = q == rank ? *reinterpret_cast<const float4*>(
                                  part + r * C::kPart + c)
                            : ld_cluster(map_rank(a, q));
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int i = i0 + g * kT;
      const int r = r0 + i / kQuads, c = (i % kQuads) * 4;
      float4 t = v[g][0];
#pragma unroll
      for (int q = 1; q < S; ++q) {
        t.x = t.x + v[g][q].x;
        t.y = t.y + v[g][q].y;
        t.z = t.z + v[g][q].z;
        t.w = t.w + v[g][q].w;
      }
      if (i < total && row0 + r < M && n0 + c < N) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(t.x, t.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(t.z, t.w);
        uint2 o;
        o.x = *reinterpret_cast<const uint32_t*>(&lo);
        o.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(out + (long long)(row0 + r) * N + n0 + c) =
            o;
      }
    }
  }
}

template <class C, int S = 2>
__device__ __forceinline__ void fold_cluster(const float* part, int split,
                                             int rank, bf16* __restrict__ out,
                                             int row0, int n0, int M, int N,
                                             int ct) {
  if constexpr (S < kMaxSplit) {
    if (split != S)
      return fold_cluster<C, S + 1>(part, split, rank, out, row0, n0, M, N,
                                    ct);
  }
  fold_cluster<C, S>(part, rank, out, row0, n0, M, N, ct);
}

// Warpgroup 0 produces (its thread 0 issues every TMA load), warpgroups 1
// and 2 consume. Inside route: a persistent grid walks the tiles, each over
// all its k-slices, the consumers folding each chunk's fresh accumulator
// into the running total as the chunk ends; outputs leave by TMA stores.
// Across route: one (tile, chunk) a block, a cluster of S blocks a tile
// (block s of the cluster runs chunk s); each block's consumers put p_s in
// shared memory and the cluster folds the tile (fold_cluster).
template <class C, bool kAcross>
__global__ void __launch_bounds__(kThreads, 1)
dense_bf16(const __grid_constant__ CUtensorMap tmx,
           const __grid_constant__ CUtensorMap tmw,
           const __grid_constant__ CUtensorMap tmo, bf16* __restrict__ out,
           int M, int K, int N, int chunk, int S) {
  constexpr int kStages = C::kStages, kSB = C::kStageBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* staging = smem + kStages * kSB;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + C::kStaging);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int mt = cdiv(M, kRows), nt = cdiv(N, C::kCols), nk = cdiv(K, kBK);
  // across: this block's one item; inside: the tiles, strided by the grid
  const int first = kAcross ? (int)blockIdx.x / S : (int)blockIdx.x;
  const int items = kAcross ? first + 1 : mt * nt;
  const int step = kAcross ? 1 : (int)gridDim.x;
  const int rank = kAcross ? (int)cluster_rank() : 0;
  const int wg = tid / 128;
  int stage = 0;
  uint32_t phase = 0;

  if (wg == 0) {
    setmaxnreg_dec40();
    if (tid == 0) {
      for (int t = first; t < items; t += step) {
        int m, n, lo = 0, hi = nk;
        tile_of(t, mt, nt, m, n);
        if constexpr (kAcross) chunk_of(rank, chunk, nk, lo, hi);
        for (int kb = lo; kb < hi; ++kb) {
          mbar_wait(empty + stage, phase ^ 1);  // the consumers freed it
          unsigned char* st = smem + stage * kSB;
          mbar_expect_tx(full + stage, kSB);
          tma_load_2d(st, &tmx, full + stage, kb * kBK, m * kRows);
          if constexpr (C::kKMajorW) {
            tma_load_2d(st + C::kXBytes, &tmw, full + stage, kb * kBK,
                        n * C::kCols);
          } else {
#pragma unroll
            for (int j = 0; j < C::kCols / 64; ++j)
              tma_load_2d(st + C::kXBytes + j * kBox, &tmw, full + stage,
                          n * C::kCols + j * 64, kb * kBK);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    if constexpr (kAcross) {  // every thread of the cluster takes both
      cluster_sync();          // of the fold's barriers
      cluster_sync();
    }
    return;
  }

  setmaxnreg_inc232();
  const int cw = wg - 1;
  const int ct = tid % 128;
  for (int t = first; t < items; t += step) {
    int m, n;
    tile_of(t, mt, nt, m, n);
    const int s0 = kAcross ? rank : 0, s1 = kAcross ? rank + 1 : S;
    float tot[C::kAcc];
    for (int s = s0; s < s1; ++s) {
      int lo, hi;
      chunk_of(s, chunk, nk, lo, hi);
      float acc[C::kAcc];
#pragma unroll
      for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = lo; kb < hi; ++kb) {
        mbar_wait(full + stage, phase);  // this k-slice has landed
        wgmma_fence();
        C::mma(acc, smem + stage * kSB, cw);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-slice's products are done
        if (prev >= 0) mbar_arrive(empty + prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      mbar_arrive(empty + prev);
      // the fold: p_0, then + p_1, ..., in chunk order
      if (s == s0) {
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) tot[i] = acc[i];
      } else {
#pragma unroll
        for (int i = 0; i < C::kAcc; ++i) tot[i] = tot[i] + acc[i];
      }
    }
    if constexpr (!kAcross) {
      store_bf16<C>(tot, staging, &tmo, m * kRows, n * C::kCols, N, cw, ct);
    } else {
      // p_s -> this block's shared memory, over the ring: both consumer
      // warpgroups are past their last wgmma, and every load has landed
      asm volatile("bar.sync 3, 256;\n" ::: "memory");
      float* part = reinterpret_cast<float*>(smem);
      const int warp = ct / 32, lane = ct % 32;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = part +
                     (cw * 64 + warp * 16 + lane / 4 + 8 * i) * C::kPart +
                     (lane % 4) * 2;
#pragma unroll
        for (int nb = 0; nb < C::kCols / 8; ++nb)
          *reinterpret_cast<float2*>(row + nb * 8) =
              make_float2(tot[nb * 4 + i * 2], tot[nb * 4 + i * 2 + 1]);
      }
      cluster_sync();  // every block's p_s is in its shared memory
      fold_cluster<C>(part, S, rank, out, m * kRows, n * C::kCols, M, N,
                      tid - 128);
      cluster_sync();  // no block leaves while another reads its partials
    }
  }
  if (!kAcross && ct == 0) bulk_wait();  // the last TMA stores
}

// ------------------------------------------------------------- f32 ----
// out rows [blockIdx.x * 64, + 64), columns [blockIdx.y * 64, + 64) on
// common.cuh's tile_f32: w (K, N), or (N, K) with kKMajor.
template <bool kKMajor>
__global__ void __launch_bounds__(kF32Threads)
dense_f32(const float* __restrict__ x, const float* __restrict__ w,
          float* __restrict__ out, int M, int K, int N) {
  const int row0 = blockIdx.x * kF32BM;
  tile_f32<kKMajor>(x + (long long)row0 * K, w, out + (long long)row0 * N,
                    min(kF32BM, M - row0), K, N, blockIdx.y * kF32BN);
}

// ------------------------------------------------------------- host ----
// hopper.cuh's encode_bf16_2d through a cache. A map is a pure function of what it encodes
// (address, dims, strides, box, swizzle, L2 promotion), and the key holds
// all of them (the dtype, the swizzle and the stride of `inner` elements
// are fixed here), so a cached map is the map a new encode would give:
// right for whatever tensor lies at that address now, a weight restored
// after a demote included. A weight's maps are encoded once; an
// activation's whenever the allocator hands out a new address.
struct MapKey {
  uintptr_t p;
  int inner, outer, box_inner, box_outer, promo;
  bool operator==(const MapKey& o) const {
    return p == o.p && inner == o.inner && outer == o.outer &&
           box_inner == o.box_inner && box_outer == o.box_outer &&
           promo == o.promo;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<uintptr_t>()(k.p);
    for (int v : {k.inner, k.outer, k.box_inner, k.box_outer, k.promo})
      h = h * 0x9e3779b97f4a7c15ull + (size_t)v;
    return h;
  }
};
constexpr size_t kMaxCached = 16384;  // a few models' weights and waves

bool cached_map(CUtensorMap* map, const void* p, int inner, int outer,
                int box_inner, int box_outer, CUtensorMapL2promotion promo) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{reinterpret_cast<uintptr_t>(p), inner,     outer,
                   box_inner,                      box_outer, (int)promo};
  {
    std::lock_guard<std::mutex> lock(mu);
    auto hit = cache.find(key);
    if (hit != cache.end()) {
      std::memcpy(map, &hit->second, sizeof(CUtensorMap));
      return true;
    }
  }
  if (!encode_bf16_2d(map, p, inner, outer, box_inner, box_outer, promo))
    return false;
  std::lock_guard<std::mutex> lock(mu);
  if (cache.size() >= kMaxCached) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// Sets the kernel's dynamic shared-memory limit and lets it run in
// clusters of more than 8 blocks, once a device.
template <class C, bool kAcross>
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  auto kernel = dense_bf16<C, kAcross>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err == cudaSuccess && kAcross)  // clusters of up to kMaxSplit blocks
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// x (K, M) boxes of 64 x 128 rows; w (K, N): an (N, K) map of 64 x 64
// boxes, or w (N, K): a (K, N) map of 64 x cols; out (N, M) boxes of 64 x
// 64 for the inside route's TMA stores (the across route stores without).
template <class C, bool kAcross>
cudaError_t launch_bf16(const void* x, const void* w, void* out, int M,
                        int K, int N, int split, int chunk, int sms,
                        cudaStream_t stream) {
  constexpr auto kL2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  CUtensorMap mx, mw, mo = {};
  if (!cached_map(&mx, x, K, M, 64, kRows, kL2) ||
      !(C::kKMajorW ? cached_map(&mw, w, K, N, 64, C::kCols, kL2)
                    : cached_map(&mw, w, N, K, 64, 64, kL2)) ||
      (!kAcross && !cached_map(&mo, out, N, M, 64, 64,
                               CU_TENSOR_MAP_L2_PROMOTION_NONE)))
    return cudaErrorInvalidValue;
  cudaError_t err = prepare<C, kAcross>();
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)cdiv(M, kRows) * cdiv(N, C::kCols);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)(kAcross ? tiles * split
                                        : std::min<long long>(tiles, sms)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  if (kAcross) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, dense_bf16<C, kAcross>, mx, mw, mo,
                           static_cast<bf16*>(out), M, K, N, chunk, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The bf16 launch on a block of `cols` columns and the route `across`.
template <bool kKMajorW>
cudaError_t dispatch_bf16(const void* x, const void* w, void* out, int M,
                          int K, int N, int split, int chunk, int cols,
                          bool across, int sms, cudaStream_t stream) {
  if (cols == 128)
    return across ? launch_bf16<Cfg<128, kKMajorW>, true>(
                        x, w, out, M, K, N, split, chunk, sms, stream)
                  : launch_bf16<Cfg<128, kKMajorW>, false>(
                        x, w, out, M, K, N, split, chunk, sms, stream);
  return across ? launch_bf16<Cfg<64, kKMajorW>, true>(
                      x, w, out, M, K, N, split, chunk, sms, stream)
                : launch_bf16<Cfg<64, kKMajorW>, false>(
                      x, w, out, M, K, N, split, chunk, sms, stream);
}

cudaError_t launch_f32(const void* x, const void* w, void* out, int M, int K,
                       int N, bool kmajor, cudaStream_t stream) {
  dim3 grid(cdiv(M, kF32BM), cdiv(N, kF32BN));
  auto kernel = kmajor ? dense_f32<true> : dense_f32<false>;
  kernel<<<grid, kF32Threads, 0, stream>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w),
                                           static_cast<float*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace dense
}  // namespace repro

// x (M, K) x w (K, N), or w (N, K) with w_kmajor, -> out (M, N). bf16: the
// caller's plan of (K, N), `split` chunks of `chunk` k-slices (the last one
// short), on the caller's route for M rows: blocks of `cols` (64 or 128)
// columns, in clusters of `split` blocks a tile (`across`) or on a
// persistent grid of at most `sms` blocks; a plan whose chunks do not tile
// K's k-slices is refused. f32: the CUDA-core tiles (no split; the plan is
// not read). K and N multiples of 8, x, w and out 16-byte aligned. Returns
// the CUDA error code of the launch (0 = success).
extern "C" int dense_gemm_fwd(const void* x, const void* w, void* out, int M,
                              int K, int N, int dtype, int w_kmajor,
                              int split, int chunk, int cols, int across,
                              int sms, void* stream) {
  using namespace repro::dense;
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K < 1 || K % 8 != 0 || N % 8 != 0 || sms < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool km = w_kmajor != 0;
  if (dtype == REPRO_BF16) {
    const int nk = cdiv(K, kBK);
    if (split < 1 || split > kMaxSplit || chunk < 1 ||
        (long long)split * chunk < nk || (split - 1) * chunk >= nk ||
        (cols != 64 && cols != 128) || (across && split == 1))
      return cudaErrorInvalidValue;
    const bool a = across != 0;
    return static_cast<int>(
        km ? dispatch_bf16<true>(x, w, out, M, K, N, split, chunk, cols, a,
                                 sms, st)
           : dispatch_bf16<false>(x, w, out, M, K, N, split, chunk, cols, a,
                                  sms, st));
  }
  if (dtype == REPRO_F32)
    return static_cast<int>(launch_f32(x, w, out, M, K, N, km, st));
  return cudaErrorInvalidValue;
}

// The clusters of S blocks of the across route's kernel (64 columns, w
// MN-major) that the current card holds at once
// (cudaOccupancyMaxActiveClusters), into `*clusters`: what
// kernels/dense_gemm.py's CLUSTERS_AT_ONCE holds for an H100. Returns the
// CUDA error code.
extern "C" int dense_gemm_clusters_at_once(int S, int* clusters) {
  using namespace repro::dense;
  using C = Cfg<64, false>;
  if (S < 1 || S > kMaxSplit) return cudaErrorInvalidValue;
  cudaError_t err = prepare<C, true>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, dense_bf16<C, true>, &cfg));
}
