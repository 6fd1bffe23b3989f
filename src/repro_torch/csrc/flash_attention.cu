// Prefill flash attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `flash_attention_bhsd` (`_flash_kernel`) of
// src/repro/kernels/flash_attention.py. It computes the same function, with
// three extensions that put it on the serving path:
//   * per-row valid key counts `kv_len` (B,), so the engine's right-padded
//     prefill waves run here (the reference sends them to the XLA blockwise
//     path, models/attention.py:228);
//   * per-row query offsets `q_offset` (B,): query row i of batch row b sits
//     at position q_offset[b] + i, so the tail-only prefill of a prompt
//     whose prefix K/V is shared from the page pool runs here (the
//     reference's blockwise path with a (B,) q_offset, attention.py:289);
//   * GQA by head index: query head h reads KV head h / (H / Hkv), so the
//     narrow K/V are never repeated in memory.
//
// Layout: q (B, S, H, D), k and v (B, T, Hkv, D), out (B, S, H, D), all
// contiguous, in f32 or bf16; D is 16, 32, 64, 80 (H2O-Danube), 112
// (Zamba2's shared block), 128 or 160 (StableLM-12B). Causal,
// sliding-window or full attention; ragged S and T are masked here. Scores, softmax and the output accumulator are f32, with the
// reference's -1e30 sentinel and max(l, 1e-30): masked scores get a weight
// of exactly 0, so a row with no visible key comes out as zeros, never NaN.
//
// What bounds it on the H100: at the main-path shape (S = 512, D = 64,
// causal) the function needs ~128 FLOP per byte, under the card's ~295, so
// the least time is set by the bytes (q, k, v read once, out written once).
//
// The bf16 route (the serving path):
//   * Q.K^T and P.V run on wgmma (m64n64k16 for the scores, m64nNk16 for
//     P.V with N = D rounded up to 64: one n64 or n128 product, or at
//     D 160 an n128 and an n64 product over the three 64-column boxes of
//     V), f32 accumulate. The online softmax (m, l, the output
//     accumulator) stays in registers in f32; P is
//     rounded to bf16 and fed to the P.V wgmma from registers (the score
//     accumulator's layout is the A fragment's), so it never touches shared
//     memory.
//   * Q, K and V tiles come in by TMA: 4-D tensor maps over (D, H or Hkv, S
//     or T, B) with boxes of 64 columns x 64 rows, 128B-swizzled. Columns
//     past D (the last box at D = 80, 112 and 160, the one box at D < 64)
//     and rows past S or T are zero-filled by TMA, never read from the
//     next head or row.
//     K and V have rings of kStages stages each, guarded by mbarriers (full:
//     the producer's expect_tx and the TMA bytes; empty: every consumer
//     thread's arrival), so the next tile's K lands while this tile's V is
//     still read.
//   * A block is one consumer warpgroup owning 64 query rows of one head
//     and one producer warp (one thread issues every TMA load); grid
//     (ceil(S / 64), B * H), the causal blocks late in the sequence first;
//     two or three blocks an SM overlap one another's products and softmax.
//     At D 160 a stage of K and V is 48 KB, so the rings hold one stage
//     each (74 KB a block) to keep two blocks an SM, rather than two
//     stages and one block.
//     The output leaves through shared memory (the Q tile) by a TMA store
//     clipped at D and S.
//   * Fully masked key tiles are skipped: the loop starts at the sliding
//     window's first visible tile and stops at the block's causal limit
//     and at kv_len[b].
//
// Prefix-sharing parity. A tail prefilled at q_offset must get the same
// bits as the same rows of a cold whole-prompt prefill of the same K/V. So
// key tiles are anchored at position 0 with one fixed width (64), every
// launch issues the same instruction shapes in the same k order whatever S,
// the bucket or q_offset, a row's result depends on its own q row and the
// key tiles alone (never on which warp or block holds it), and a tile that
// is fully masked for a row is a bitwise no-op for it: m stays, corr is
// exactly 1 (taken as 1 when m does not move), p is exactly 0.
//
// The f32 route (the f32 checks) keeps the CUDA-core body below.

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::kNegInf;


// ----------------------------------------------------------- f32 -----
// The CUDA-core body: f32 FMA from shared memory, a 4 x 4 register tile a
// thread, one block per 64 query rows of one head.
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 score tile
constexpr int kSP = kBK + 1;   // padded row stride of the P tile

template <int D>
constexpr int smem_floats() {
  // Q tile + K tile (rows padded to D + 1), V tile, P tile (at D 160
  // about 140 KB: one block an SM)
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kSP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ kv_len,
                       const int* __restrict__ q_offset, T* __restrict__ out,
                       int S, int T_, int H, int Hkv, int causal, int window,
                       float scale) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBQ * DP;
  float* sv = sk + kBK * DP;
  float* sp = sv + kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // owns query rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // owns key columns tx + 16*c, out columns tx + 16*c
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  // causal tiles late in the sequence carry the most work: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;

  const int t_lim = kv_len != nullptr ? max(0, min(kv_len[b], T_)) : T_;
  const int qoff = q_offset != nullptr ? q_offset[b] : 0;
  int t_end = t_lim;
  if (causal) t_end = min(t_end, qoff + min(q0 + kBQ, S));
  int t_begin = 0;
  if (window > 0) t_begin = max(0, qoff + q0 - window + 1);
  t_begin = (t_begin / kBK) * kBK;

  const long long q_row_stride = (long long)H * D;
  const long long kv_row_stride = (long long)Hkv * D;
  const T* qb = q + ((long long)b * S) * q_row_stride + (long long)h * D;
  const T* kb = k + ((long long)b * T_) * kv_row_stride + (long long)kvh * D;
  const T* vb = v + ((long long)b * T_) * kv_row_stride + (long long)kvh * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    sq[r * DP + c] = row < S ? repro::to_float(qb[row * q_row_stride + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += kBK) {
    __syncthreads();  // the previous tile's P.V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int t = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < T_) {
        kx = repro::to_float(kb[t * kv_row_stride + c]);
        vx = repro::to_float(vb[t * kv_row_stride + c]);
      }
      sk[r * DP + c] = kx;
      sv[r * D + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kx[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sq[(ty * 4 + r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kx[c] = sk[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kx[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = qoff + q0 + ty * 4 + r;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = t0 + tx + 16 * c;
        bool ok = kpos < t_lim;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        vis[c] = ok;
        s[r][c] = ok ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      // the 16 threads sharing a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = vis[c] ? expf(s[r][c] - m_new) : 0.f;
        sp[(ty * 4 + r) * kSP + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vx[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sp[(ty * 4 + r) * kSP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vx[c] = sv[j * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(pv[r], vx[c], acc[r][c]);
    }
  }

  T* ob = out + ((long long)b * S) * q_row_stride + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[row * q_row_stride + tx + 16 * c] =
          repro::from_float<T>(acc[r][c] * inv);
  }
}


// ---------------------------------------------------------- bf16 -----
namespace tc {

using namespace repro::hopper;

constexpr int kRows = 64;       // query rows per block (one warpgroup)
constexpr int kKeys = 64;       // keys per tile
constexpr int kThreads = 128 + 32;  // the consumer warpgroup + a producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kBoxes = (D + 63) / 64;      // 64-column boxes a row
  static constexpr int kTile = kBoxes * kBox;       // 64 rows of Q, K or V
  static constexpr int kNV = kBoxes * 64;           // P.V's N
  static constexpr int kAcc = kNV / 2;              // P.V accumulator a thread
  static constexpr int kKSteps = (D + 15) / 16;     // Q.K^T's k16 steps
  // of K and of V each; at D 160 one, so that two blocks fit an SM
  static constexpr int kStages = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int kSmem =
      1024 + kTile + kStages * 2 * kTile + (4 * kStages + 1) * 8;
  static constexpr int kMinBlocks = 2;  // blocks an SM
};

// O (64 x N) += P (64 x 16, registers) . V (16 keys x N): v points at the
// 16 keys' rows of the tile's first 64-column box, the next box kBox on
template <int N>
__device__ __forceinline__ void pv_mma(float (&o)[N / 2],
                                       const uint32_t (&a)[4],
                                       const unsigned char* v);
template <>
__device__ __forceinline__ void pv_mma<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           const unsigned char* v) {
  wgmma_m64n64_rs<1>(o, a, smem_desc(v, kBox, 1024));
}
template <>
__device__ __forceinline__ void pv_mma<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            const unsigned char* v) {
  wgmma_m64n128_rs<1>(o, a, smem_desc(v, kBox, 1024));
}
// no n192 wgmma here: boxes 0-1 by one n128 product, box 2 by an n64 one;
// columns 8 j .. 8 j + 7 of the accumulator are o[4 j .. 4 j + 3] in both
template <>
__device__ __forceinline__ void pv_mma<192>(float (&o)[96],
                                            const uint32_t (&a)[4],
                                            const unsigned char* v) {
  wgmma_m64n128_rs<1>(*reinterpret_cast<float(*)[64]>(&o[0]), a,
                      smem_desc(v, kBox, 1024));
  wgmma_m64n64_rs<1>(*reinterpret_cast<float(*)[32]>(&o[64]), a,
                     smem_desc(v + 2 * kBox, kBox, 1024));
}

// keeps the compiler from moving the registers of a wgmma across its
// fence or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The visible key range [lo, hi) of the block whose first row is r0, lo a
// tile start; empty (lo == hi) when the block has no key to read.
__device__ __forceinline__ void key_range(int r0, int S, int t_lim, int qoff,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = hi = 0;
  int e = t_lim;
  if (causal) e = min(e, qoff + min(r0 + kRows, S));
  int b = 0;
  if (window > 0) b = max(0, qoff + r0 - window + 1);
  b = b / kKeys * kKeys;
  if (e > b) {
    lo = b;
    hi = e;
  }
}

// One warpgroup's softmax state over the key tiles it has seen: this
// thread's two rows (i = 0, 1: row and row + 8 of the block) and their
// columns 8 j + 2 (lane % 4) + c of every tile.
template <int D>
struct Softmax {
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns only, summed at the end

  // scores s of the tile at t0 (raw Q.K^T) -> P in bf16 as the A fragments
  // of P.V's four k16 steps; the output rows rescaled by corr. A key the
  // row cannot see gets a weight of exactly 0; a tile the row cannot see
  // at all leaves m, l and o as they were, bit for bit.
  __device__ __forceinline__ void tile(float (&s)[32], float (&o)[
      Cfg<D>::kAcc], uint32_t (&pa)[4][4], int t0, bool all, int qpos0,
      int col0, int t_lim, int causal, int window, float scale_log2) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = qpos0 + 8 * i;
      // the row's largest visible raw score (kNegInf: none), then scaled:
      // scaling is monotonic, so max-then-scale is scale-then-max
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j * 4 + i * 2 + c];
          if (!all) {
            const int kpos = t0 + 8 * j + col0 + c;
            bool vis = kpos < t_lim;
            if (causal) vis = vis && kpos <= qpos;
            if (window > 0) vis = vis && qpos - kpos < window;
            if (!vis) x = kNegInf;
          }
          mx = fmaxf(mx, x);
        }
      if (mx != kNegInf) mx *= scale_log2;
      // the four lanes of a row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = m_new == m[i] ? 1.f : ex2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // the same arithmetic for a visible key on both paths, so a row
          // gets the same bits whichever path its block takes
          float& x = s[j * 4 + i * 2 + c];
          const float p = ex2(fmaf(x, scale_log2, -m_new));
          x = all || x != kNegInf ? p : 0.f;
          sum += x;
        }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < Cfg<D>::kNV / 8; ++j) {
        o[j * 4 + i * 2] *= corr;
        o[j * 4 + i * 2 + 1] *= corr;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
flash_attention_bf16(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     const int* __restrict__ kv_len,
                     const int* __restrict__ q_offset, int S, int T_, int H,
                     int Hkv, int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int ST = C::kStages, TB = C::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem;           // the Q tile, then the output's
  unsigned char* sk = sq + TB;        // the K ring
  unsigned char* sv = sk + ST * TB;   // the V ring
  // K and V have rings of their own, so that the next tile's K can land
  // while this tile's V is still being read
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sv + ST * TB);
  uint64_t* empty_k = full_k + ST;
  uint64_t* full_v = empty_k + ST;
  uint64_t* empty_v = full_v + ST;
  uint64_t* qbar = empty_v + ST;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / Hkv);
  // causal blocks late in the sequence carry the most work: start them first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int t_lim = kv_len != nullptr ? max(0, min(kv_len[b], T_)) : T_;
  const int qoff = q_offset != nullptr ? q_offset[b] : 0;
  int lo, hi;
  key_range(r0, S, t_lim, qoff, causal, window, lo, hi);
  const int nt = (hi - lo + kKeys - 1) / kKeys;  // key tiles to read

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(empty_k + s, 128);
      mbar_init(full_v + s, 1);
      mbar_init(empty_v + s, 128);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp
    if (tid != 128) return;
    mbar_expect_tx(qbar, TB);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      tma_load_4d(sq + c * kBox, &tq, qbar, c * 64, h, r0, b);
    // K (j) goes ahead of V (j - 1): the consumer's Q.K^T (j) runs while
    // it still reads V (j - 1)
    for (int j = 0; j <= nt; ++j) {
      if (j < nt) {
        const int stage = j % ST;
        mbar_wait(empty_k + stage, ((j / ST) & 1) ^ 1);  // freed
        mbar_expect_tx(full_k + stage, TB);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load_4d(sk + stage * TB + c * kBox, &tk, full_k + stage,
                      c * 64, kvh, lo + j * kKeys, b);
      }
      if (j > 0) {
        const int jv = j - 1, stage = jv % ST;
        mbar_wait(empty_v + stage, ((jv / ST) & 1) ^ 1);
        mbar_expect_tx(full_v + stage, TB);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c)
          tma_load_4d(sv + stage * TB + c * kBox, &tv, full_v + stage,
                      c * 64, kvh, lo + jv * kKeys, b);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  // this thread's two rows (row, row + 8) of the block and their positions;
  // its score columns are 8 j + 2 (lane % 4) + c of a tile
  const int row = warp * 16 + lane / 4;
  const int qpos0 = qoff + r0 + row;
  const int col0 = 2 * (lane % 4);

  float o[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) o[i] = 0.f;
  Softmax<D> sm;
  uint32_t pa[4][4];

  float sc[32];
  mbar_wait(qbar, 0);
  for (int j = 0; j < nt; ++j) {
    const int stage = j % ST;
    const uint32_t parity = (j / ST) & 1;
    // S = Q.K^T of this tile
    const unsigned char* k_tile = sk + stage * TB;
    mbar_wait(full_k + stage, parity);  // this K tile has landed
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kKSteps; ++kk) {
      const int off = (kk / 4) * kBox + (kk % 4) * 32;
      wgmma_m64n64<0, 0>(sc, smem_desc(sq + off, 16, 1024),
                         smem_desc(k_tile + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(empty_k + stage);

    const int t0 = lo + j * kKeys;
    // every (row, key) of the tile visible to every row of the block
    const bool all = t0 + kKeys <= t_lim &&
                     (!causal || t0 + kKeys - 1 <= qoff + r0) &&
                     (window <= 0 || qoff + r0 + kRows - 1 - t0 < window);
    sm.tile(sc, o, pa, t0, all, qpos0, col0, t_lim, causal, window,
            scale_log2);

    // O += P.V of this tile
    const unsigned char* v_tile = sv + stage * TB;
    mbar_wait(full_v + stage, parity);  // this V tile has landed
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pv_mma<C::kNV>(o, pa[kk], v_tile + kk * 16 * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty_v + stage);
  }

  // the row sums over the four lanes of a row, then the output in bf16,
  // staged in the Q tile as TMA lays a box out (128B swizzle)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = sm.l[i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[i] = 1.f / fmaxf(x, 1e-30f);
  }
  warpgroup_bar(1);  // every wgmma of the warpgroup has read Q
#pragma unroll
  for (int j = 0; j < C::kNV / 8; ++j) {
    const int box = j / 8, c16 = j % 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      *reinterpret_cast<uint32_t*>(sq + box * kBox + r * 128 +
                                   ((c16 ^ (r & 7)) << 4) + (lane % 4) * 4) =
          pack_bf16(o[j * 4 + i * 2] * inv[i], o[j * 4 + i * 2 + 1] * inv[i]);
    }
  }
  fence_async_shared();
  warpgroup_bar(1);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c)
      tma_store_4d(&to, sq + c * kBox, c * 64, h, r0, b);
    bulk_commit();
    bulk_wait_read();  // the store has read the tile before the block ends
  }
}

// a 4-D (D, heads, rows, B) map of one (B, rows, heads, D) bf16 tensor, in
// boxes of 64 columns x 1 head x 64 rows, 128B-swizzled; out-of-range
// elements read as 0 and are not written by a store
bool encode_4d(CUtensorMap* map, const void* p, int B, int rows, int heads,
               int D) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const cuuint64_t dim[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                             (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                (cuuint64_t)rows * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kRows, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dim, stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, const int* q_offset, void* out, int B,
                   int S, int T_, int H, int Hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return cudaErrorMisalignedAddress;  // TMA wants 16-byte aligned bases
  CUtensorMap mq, mk, mv, mo;
  if (!encode_4d(&mq, q, B, S, H, D) || !encode_4d(&mk, k, B, T_, Hkv, D) ||
      !encode_4d(&mv, v, B, T_, Hkv, D) || !encode_4d(&mo, out, B, S, H, D))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_bf16<D>;
  constexpr int smem = Cfg<D>::kSmem;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mo, kv_len, q_offset,
                                           S, T_, H, Hkv, causal, window,
                                           scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* kv_len, const int* q_offset, void* out,
                       int B, int S, int T_, int H, int Hkv, int causal,
                       int window, float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_f32<float, D>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_len, q_offset,
      static_cast<float*>(out), S, T_, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

// head_dim is a template argument: 16, 32, 64, 80, 112, 128 or 160
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, const int* q_offset, void* out, int B,
                   int S, int T_, int H, int Hkv, int causal, int window,
                   float scale, int dtype, cudaStream_t st) {
  if (dtype == REPRO_BF16)
    return tc::launch<D>(q, k, v, kv_len, q_offset, out, B, S, T_, H, Hkv,
                         causal, window, scale, st);
  if (dtype == REPRO_F32)
    return launch_f32<D>(q, k, v, kv_len, q_offset, out, B, S, T_, H, Hkv,
                         causal, window, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, D); k, v (B, T, Hkv, D); kv_len (B,) int32 or null;
// q_offset (B,) int32 or null; out (B, S, H, D). Returns the CUDA error code
// of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* kv_len,
                                   const int* q_offset, void* out, int B,
                                   int S, int T, int H,
                                   int Hkv, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch<16>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv,
                       causal, window, scale, dtype, st);
      break;
    case 32:
      err = launch<32>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv,
                       causal, window, scale, dtype, st);
      break;
    case 64:
      err = launch<64>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv,
                       causal, window, scale, dtype, st);
      break;
    case 80:
      err = launch<80>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv,
                       causal, window, scale, dtype, st);
      break;
    case 112:
      err = launch<112>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv,
                        causal, window, scale, dtype, st);
      break;
    case 128:
      err = launch<128>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv,
                        causal, window, scale, dtype, st);
      break;
    case 160:
      err = launch<160>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv,
                        causal, window, scale, dtype, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
