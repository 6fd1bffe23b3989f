// Absorbed-matrix MLA decode over the paged latent pool, for Hopper
// (sm_90a), written by hand.
//
// Replaces the TPU kernel `paged_mla_decode` (`_paged_mla_kernel`) of
// src/repro/kernels/decode_attention.py. Same function: one query token per
// slot, already absorbed through w_uk, q_lat (B, H, R) and its rope part
// q_rope (B, H, Dr), against the compressed latents ckv_pages (NP+1, P, R)
// and the shared rope keys krope_pages (NP+1, P, Dr), read through a
// per-slot page table (B, npages) int32: key t of slot b is row
// pt[b, t / P] * P + t % P. Score (q_lat . c_kv + q_rope . k_rope) * scale,
// f32 online softmax (the reference's -1e30 sentinel, max(l, 1e-30)); the
// value is the latent itself, so the output (B, H, R) stays in latent space
// (the caller applies w_uv and wo), in q's dtype. Keys at or past
// lengths[b] are never read, so table columns j >= ceil(lengths[b] / P)
// (unreserved columns, which name the TRASH page NP) are never touched, and
// a slot of length 0 gets exact zeros. Any page size P; R <= 512 and Dr
// multiples of 8 and both pools 16-byte aligned (the wrapper refuses
// others), so every row moves in whole 16-byte chunks; the table may be a
// column slice of a wider one (rows `pt_stride` ints apart). f32 or bf16;
// 64-bit offsets; no atomics, so the same inputs give the same bits.
//
// What bounds it on the H100: one token reads each live latent row (R + Dr
// values) once and does 2 (R + Dr) + 2 R FLOPs per head per key, ~36
// FLOPs a byte at 16 heads, far below the ~295 at which the tensor cores
// would be the limit. So the least time is the live latent bytes over the
// memory rate: at DeepSeek-V2-Lite's decode (16 slots of 0-1 024 keys,
// 1 152 bytes a key) 8.28 MB, 0.0025 ms.
//
// The bf16 route (the engine's) is built around that bound:
//   * One block owns every head of a (slot, key range): the grid is
//     (B, ceil(H / 16), S), so at H = 16 each live latent row goes from HBM
//     to shared memory once, as the TPU kernel keeps the whole (H, R)
//     accumulator over its sequential page axis. H < 16 pads the query with
//     zero rows whose output is never written.
//   * Scores and P . V on tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate; M = the 16 heads). S = [q_lat | q_rope] . [c | k_r]^T:
//     warp w takes keys 8w..8w+7 of a 64-key tile over the whole depth
//     R + Dr (zero-filled to a multiple of 16), in two interleaved
//     accumulator chains; bf16 x bf16 products are exact in f32, so only
//     the order of the sum departs from the reference. Masked keys score
//     the -1e30 sentinel before the softmax (a zero-filled row would score
//     0). O (16 x R) += P (16 x 64) . C (64 x R) reads C's rows already in
//     shared memory through ldmatrix.trans; warp w owns 16-column strips
//     w, w + 8, ... of R with its (16 x 64) f32 accumulator in registers.
//     P stays f32-accurate: it is split into p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi) and both products are issued, which matches f32 P to
//     ~2^-16 relative at twice the P . V MMAs (negligible here).
//   * Asynchronous double-buffered page loads: while tile i is scored and
//     accumulated, tile i + 1's rows, resolved through the table, arrive by
//     cp.async (16-byte copies, any page size) in the other stage. Rows are
//     staged as bf16 (no f32 copy), R + Dr + 8 values apart, so the eight
//     rows an ldmatrix reads fall on distinct banks. Two stages of 64 keys
//     (2 x 73 KB at 512 + 64) and Q (18 KB) take one block an SM.
//   * Splits sized without a host sync (CUDA-graph safe): the wrapper cuts
//     the table's capacity into S ranges of whole tiles, for about two
//     blocks an SM over B x ceil(H / 16) x S. A block whose range starts at
//     or past its slot's length exits at once and writes nothing; the
//     combine kernel, one block per (slot, head), weighs only the live
//     ranges, in split order, by exp(m_s - max m) and divides by
//     max(l, 1e-30). Its first warp reads every range's (m, l) at once,
//     since loads that wait on one another would cost as much as the
//     partial kernel.
// The f32 route keeps the CUDA-core body of the first port (two heads a
// block, 32-key tiles staged as f32, a warp per (head, key) score), with
// the same splits and combine.

#include "common.cuh"

#include <cstdint>

namespace repro {
namespace mla {

constexpr int kMaxR = 512;                        // widest latent taken
constexpr int kMaxSplits = 64;                    // key ranges per slot
constexpr int kCombineThreads = 128;
constexpr int kMaxSmem = 232448;                  // a block's shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through the L2; `bytes` 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ldmatrix: four (or two) 8 x 8 b16 matrices, lane l giving the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col); not
// volatile, so the compiler may interleave independent products
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------ bf16: tensor cores ----
namespace tc {

constexpr int kBK = 64;                       // keys per tile
constexpr int kHG = 16;                       // heads per block (mma's M)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSS = kBK + 8;                  // score / P row stride
constexpr int kStrips = kMaxR / 16 / kWarps;  // 16-column strips a warp owns
static_assert(kThreads == 4 * kBK, "the loader gives each key 4 threads");
static_assert(kBK == 8 * kWarps, "the scores give each warp 8 keys");

// a staged row: R + Dr values zero-filled to a multiple of 16, plus 8
__host__ __device__ inline int row_stride(int R, int Dr) {
  return (R + Dr + 15) / 16 * 16 + 8;
}

inline int smem_bytes(int RS) {
  // two key stages and q (bf16), scores (f32), p_hi and p_lo (bf16), the
  // per-head correction of the current tile
  return 2 * (2 * kBK * RS + kHG * RS) + 4 * kHG * kSS + 2 * 2 * kHG * kSS +
         4 * kHG;
}

__global__ void __launch_bounds__(kThreads, 1)
partial(const __nv_bfloat16* __restrict__ q_lat,
        const __nv_bfloat16* __restrict__ q_rope,
        const __nv_bfloat16* __restrict__ ckv,
        const __nv_bfloat16* __restrict__ krope, const int* __restrict__ pt,
        long long pt_stride, int npages, int page,
        const int* __restrict__ lengths, float* __restrict__ part,
        float* __restrict__ part_ml, int H, int R, int Dr, float scale,
        int split_keys) {
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHG;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int n_all = max(0, min(lengths[b], npages * page));
  const int t_lo = split * split_keys;
  if (t_lo >= n_all) return;  // the combine reads live ranges only
  const int n = min(n_all, t_lo + split_keys);  // this block: [t_lo, n)

  const int RS = row_stride(R, Dr);
  const int KP = RS - 8;                        // the depth, in 16s
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sq = sk + 2 * kBK * RS;        // kHG x RS
  float* ss = reinterpret_cast<float*>(sq + kHG * RS);  // kHG x kSS
  __nv_bfloat16* sph = reinterpret_cast<__nv_bfloat16*>(ss + kHG * kSS);
  __nv_bfloat16* spl = sph + kHG * kSS;
  float* scorr = reinterpret_cast<float*>(spl + kHG * kSS);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int CR = R / 8;                         // 16-byte chunks of latent
  const int C = (R + Dr) / 8;                   // and of a whole row
  const int* ptb = pt + (long long)b * pt_stride;

  // the depth's zero fill [R + Dr, KP) (one chunk or none): cp.async never
  // writes it, and uninitialised shared memory may hold NaN patterns
  if (KP > R + Dr)
    for (int r = tid; r < 2 * kBK + kHG; r += kThreads)
      *reinterpret_cast<uint4*>(sk + r * RS + R + Dr) =
          make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < kHG * C; i += kThreads) {
    const int g = i / C, c = i % C;
    const int h = h0 + g;
    const void* src = q_lat;
    int bytes = 0;
    if (h < H) {
      const long long qh = (long long)b * H + h;
      src = c < CR ? q_lat + qh * R + 8 * c : q_rope + qh * Dr + 8 * (c - CR);
      bytes = 16;
    }
    cp_async16(sq + g * RS + 8 * c, src, bytes);
  }

  // four threads a key; keys at or past n are zero-filled, never read
  auto load_tile = [&](int t0, __nv_bfloat16* dst) {
    const int j = tid >> 2;
    const int t = t0 + j;
    const long long r =
        t < n ? (long long)__ldg(ptb + t / page) * page + t % page : -1;
    __nv_bfloat16* drow = dst + j * RS;
    for (int c = tid & 3; c < C; c += 4) {
      const void* src = ckv;
      int bytes = 0;
      if (r >= 0) {
        src = c < CR ? ckv + r * R + 8 * c : krope + r * Dr + 8 * (c - CR);
        bytes = 16;
      }
      cp_async16(drow + 8 * c, src, bytes);
    }
  };

  const int ntiles = (n - t_lo + kBK - 1) / kBK;
  load_tile(t_lo, sk);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3;       // mma fragment coordinates
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // A / trans-B row
  const int acol = (lane >> 4) * 8;
  const int srow = tid >> 4, ssub = tid & 15;   // the softmax's (row, lane)
  float m_run = kNegInf, l_run = 0.f;
  float acc[kStrips][2][4];
#pragma unroll
  for (int j = 0; j < kStrips; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][h][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_lo + it * kBK;
    const __nv_bfloat16* st = sk + (it & 1) * kBK * RS;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; every warp is past tile it - 1
    if (it + 1 < ntiles) {
      load_tile(t0 + kBK, sk + ((it + 1) & 1) * kBK * RS);
      cp_async_commit();
    }

    // scores: warp w, keys 8w..8w+7, the whole depth, even and odd k-steps
    // in two chains
    {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* brow =
          st + (8 * warp + (lane & 7)) * RS + (lane >> 3) * 8;
      const __nv_bfloat16* qrow = sq + arow * RS + acol;
      const int KS = KP / 16;
      int ks = 0;
      for (; ks + 1 < KS; ks += 2) {
        uint32_t bk[4], a0[4], a1[4];
        ldsm_x4(bk, brow + ks * 16);
        ldsm_x4(a0, qrow + ks * 16);
        ldsm_x4(a1, qrow + ks * 16 + 16);
        mma_bf16(c0, a0, bk[0], bk[1]);
        mma_bf16(c1, a1, bk[2], bk[3]);
      }
      if (ks < KS) {
        uint32_t bk[2], a0[4];
        ldsm_x2(bk, brow + ks * 16);
        ldsm_x4(a0, qrow + ks * 16);
        mma_bf16(c0, a0, bk[0], bk[1]);
      }
      const int key = 8 * warp + 2 * tq;
      const bool v0 = t0 + key < n, v1 = t0 + key + 1 < n;
      *reinterpret_cast<float2*>(ss + g * kSS + key) =
          make_float2(v0 ? (c0[0] + c1[0]) * scale : kNegInf,
                      v1 ? (c0[1] + c1[1]) * scale : kNegInf);
      *reinterpret_cast<float2*>(ss + (g + 8) * kSS + key) =
          make_float2(v0 ? (c0[2] + c1[2]) * scale : kNegInf,
                      v1 ? (c0[3] + c1[3]) * scale : kNegInf);
    }
    __syncthreads();

    // online softmax: 16 threads a head, 4 keys each; the butterfly leaves
    // the same max and sum in every thread of the head
    {
      float v[kBK / 16];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kBK / 16; ++i) {
        v[i] = ss[srow * kSS + ssub + 16 * i];
        mx = fmaxf(mx, v[i]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 16; ++i) {
        const int key = ssub + 16 * i;
        const float p = t0 + key < n ? expf(v[i] - m_new) : 0.f;
        const __nv_bfloat16 hi = __float2bfloat16(p);
        sph[srow * kSS + key] = hi;
        spl[srow * kSS + key] = __float2bfloat16(p - __bfloat162float(hi));
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (ssub == 0) scorr[srow] = corr;
    }
    __syncthreads();

    // O += (p_hi + p_lo) . C over this warp's column strips
    {
      const float cg = scorr[g], cg8 = scorr[g + 8];
#pragma unroll
      for (int j = 0; j < kStrips; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[j][h][0] *= cg;
          acc[j][h][1] *= cg;
          acc[j][h][2] *= cg8;
          acc[j][h][3] *= cg8;
        }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ah[4], al[4];
        ldsm_x4(ah, sph + arow * kSS + kk * 16 + acol);
        ldsm_x4(al, spl + arow * kSS + kk * 16 + acol);
        const __nv_bfloat16* vrow = st + (kk * 16 + arow) * RS + acol;
        // the p_hi products of every strip, then the p_lo ones: each
        // accumulator still takes hi before lo, and no product waits on
        // the one before it. A strip at R % 16 == 8 reads rope columns
        // into its second half, which is never written.
        uint32_t bv[kStrips][4];
#pragma unroll
        for (int j = 0; j < kStrips; ++j)
          if (16 * (warp + kWarps * j) < R)
            ldsm_x4_t(bv[j], vrow + 16 * (warp + kWarps * j));
#pragma unroll
        for (int j = 0; j < kStrips; ++j)
          if (16 * (warp + kWarps * j) < R) {
            mma_bf16(acc[j][0], ah, bv[j][0], bv[j][1]);
            mma_bf16(acc[j][1], ah, bv[j][2], bv[j][3]);
          }
#pragma unroll
        for (int j = 0; j < kStrips; ++j)
          if (16 * (warp + kWarps * j) < R) {
            mma_bf16(acc[j][0], al, bv[j][0], bv[j][1]);
            mma_bf16(acc[j][1], al, bv[j][2], bv[j][3]);
          }
      }
    }
  }

  // unnormalised partials: part (B, H, S, R), part_ml (B, H, S, 2)
#pragma unroll
  for (int j = 0; j < kStrips; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * (warp + kWarps * j) + 8 * h + 2 * tq;
      if (col >= R) continue;
      if (h0 + g < H)
        *reinterpret_cast<float2*>(
            part + (((long long)b * H + h0 + g) * S + split) * R + col) =
            make_float2(acc[j][h][0], acc[j][h][1]);
      if (h0 + g + 8 < H)
        *reinterpret_cast<float2*>(
            part + (((long long)b * H + h0 + g + 8) * S + split) * R + col) =
            make_float2(acc[j][h][2], acc[j][h][3]);
    }
  if (ssub == 0 && h0 + srow < H) {
    const long long o = (((long long)b * H + h0 + srow) * S + split) * 2;
    part_ml[o] = m_run;
    part_ml[o + 1] = l_run;
  }
}

}  // namespace tc

// ------------------------------------------------- f32: CUDA cores -------
namespace cc {

constexpr int kBK = 32;                           // keys per tile
constexpr int kThreads = 256;                     // eight warps
constexpr int kHG = 2;                            // query heads per block
constexpr int kAcc = kHG * kMaxR / kThreads;      // accumulators per thread
constexpr int kInFlight = 4;                      // 16-byte loads a thread

inline int smem_bytes(int RD) {
  // q (kHG x RD), latent + rope tile (kBK x RD), scores (kHG x kBK),
  // per-head m, l, corr
  return static_cast<int>(sizeof(float)) *
         (kHG * RD + kBK * RD + kHG * kBK + 3 * kHG);
}

__global__ void __launch_bounds__(kThreads)
partial(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
        const float* __restrict__ ckv, const float* __restrict__ krope,
        const int* __restrict__ pt, long long pt_stride, int npages, int page,
        const int* __restrict__ lengths, float* __restrict__ part,
        float* __restrict__ part_ml, int H, int R, int Dr, float scale,
        int split_keys) {
  const int RD = R + Dr;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                 // kHG x RD: [q_lat | q_rope] per head
  float* sk = sq + kHG * RD;        // kBK x RD: [c_kv | k_rope] per key
  float* ss = sk + kBK * RD;        // kHG x kBK scores, then weights
  float* sm = ss + kHG * kBK;       // kHG running max
  float* sl = sm + kHG;             // kHG running sum
  float* sc = sl + kHG;             // kHG correction of the current tile
  __shared__ long long srow[kBK];   // pool row of each tile key, -1 = none

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHG;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int n_all = max(0, min(lengths[b], npages * page));
  const int t_lo = split * split_keys;
  if (t_lo >= n_all) return;  // the combine reads live ranges only
  const int n = min(n_all, t_lo + split_keys);  // this block: [t_lo, n)

  for (int i = tid; i < kHG * RD; i += kThreads) {
    const int g = i / RD, c = i % RD;
    const int h = h0 + g;
    float v = 0.f;
    if (h < H) {
      const long long qh = (long long)b * H + h;
      v = c < R ? q_lat[qh * R + c] : q_rope[qh * Dr + (c - R)];
    }
    sq[i] = v;
  }
  if (tid < kHG) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  // staging in 16-byte chunks: CR latent and Dr / 4 rope chunks a row
  const int CR = R / 4;
  const int C = CR + Dr / 4;
  const int total = kBK * C;

  for (int t0 = t_lo; t0 < n; t0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    if (tid < kBK) {
      const int t = t0 + tid;
      srow[tid] = t < n ? (long long)pt[b * pt_stride + t / page] * page +
                              t % page
                        : -1;
    }
    __syncthreads();
    for (int i0 = tid; i0 < total; i0 += kThreads * kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total) {
          const int j = i / C, c = i % C;
          const long long r = srow[j];
          if (r >= 0)
            v[u] = c < CR ? __ldg(reinterpret_cast<const uint4*>(
                                ckv + r * R + c * 4))
                          : __ldg(reinterpret_cast<const uint4*>(
                                krope + r * Dr + (c - CR) * 4));
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads;
        if (i < total) {
          const int j = i / C, c = i % C;
          *reinterpret_cast<uint4*>(
              sk + j * RD + (c < CR ? c * 4 : R + (c - CR) * 4)) = v[u];
        }
      }
    }
    __syncthreads();

    // scores: a warp per (head, key) pair, its lanes splitting the width
    for (int pr = warp; pr < kHG * kBK; pr += kThreads / 32) {
      const int g = pr / kBK, j = pr % kBK;
      const float* qg = sq + g * RD;
      const float* kj = sk + j * RD;
      float s = 0.f;
      for (int c = lane; c < RD; c += 32) s = fmaf(qg[c], kj[c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) ss[pr] = (t0 + j < n) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head, one key per lane
    if (warp < kHG) {
      const int g = warp;
      const float s = ss[g * kBK + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = (t0 + lane < n) ? expf(s - m_new) : 0.f;
      ss[g * kBK + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // P . c_kv into this thread's (head, column) accumulators
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < kHG * R) {
        const int g = i / R, c = i % R;
        const float* pg = ss + g * kBK;
        float x = acc[a] * sc[g];
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) x = fmaf(pg[j], sk[j * RD + c], x);
        acc[a] = x;
      }
    }
  }
  __syncthreads();  // sm, sl are final

#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < kHG * R) {
      const int g = i / R, c = i % R;
      const int h = h0 + g;
      if (h < H) part[(((long long)b * H + h) * S + split) * R + c] = acc[a];
    }
  }
  if (tid < kHG && h0 + tid < H) {
    const long long o = (((long long)b * H + h0 + tid) * S + split) * 2;
    part_ml[o] = sm[tid];
    part_ml[o + 1] = sl[tid];
  }
}

}  // namespace cc

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// One block per (slot, head): out = sum_s w_s acc_s / max(sum_s w_s l_s,
// 1e-30), w_s = exp(m_s - max m), over the live ranges s < ceil(n /
// split_keys). The first warp reads every live (m, l) at once (two a
// lane) and reduces them in a fixed butterfly; each thread then sums four
// columns over the ranges in split order. A slot of length 0 has no live
// range: exact zeros.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine(const float* __restrict__ part, const float* __restrict__ part_ml,
        const int* __restrict__ lengths, int cap, int split_keys,
        T* __restrict__ out, int H, int R, int S) {
  static_assert(kMaxSplits == 64, "two ranges a lane of one warp");
  __shared__ float sw[kMaxSplits];
  __shared__ float sinv;
  const long long bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = max(0, min(lengths[bh / H], cap));
  const int live = (n + split_keys - 1) / split_keys;
  if (tid < 32) {
    const float* ml = part_ml + bh * S * 2;
    const int s1 = tid + 32;
    const float m0 = tid < live ? ml[2 * tid] : kNegInf;
    const float l0 = tid < live ? ml[2 * tid + 1] : 0.f;
    const float m1 = s1 < live ? ml[2 * s1] : kNegInf;
    const float l1 = s1 < live ? ml[2 * s1 + 1] : 0.f;
    float mx = fmaxf(m0, m1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w0 = tid < live ? expf(m0 - mx) : 0.f;
    const float w1 = s1 < live ? expf(m1 - mx) : 0.f;
    float l = w0 * l0 + w1 * l1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    sw[tid] = w0;
    sw[s1] = w1;
    if (tid == 0) sinv = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float4* p = reinterpret_cast<const float4*>(part + bh * S * R);
  const int R4 = R / 4;
  for (int c = tid; c < R4; c += kCombineThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < live; ++s) {
      const float4 x = p[(long long)s * R4 + c];
      const float w = sw[s];
      v.x = fmaf(w, x.x, v.x);
      v.y = fmaf(w, x.y, v.y);
      v.z = fmaf(w, x.z, v.z);
      v.w = fmaf(w, x.w, v.w);
    }
    const float k = sinv;
    store4(out + bh * R + 4 * c,
           make_float4(v.x * k, v.y * k, v.z * k, v.w * k));
  }
}

}  // namespace mla
}  // namespace repro

// The widest R + Dr (a multiple of 8) whose staged rows fit a block's
// shared memory in `dtype`, or -1 for a dtype the kernel does not take.
extern "C" int paged_mla_decode_max_width(int dtype) {
  namespace mla = repro::mla;
  auto smem = [dtype](int w) {
    return dtype == REPRO_BF16 ? mla::tc::smem_bytes(mla::tc::row_stride(w, 0))
                               : mla::cc::smem_bytes(w);
  };
  if (dtype != REPRO_BF16 && dtype != REPRO_F32) return -1;
  int w = 0;
  while (smem(w + 8) <= mla::kMaxSmem) w += 8;
  return w;
}

// q_lat (B, H, R); q_rope (B, H, Dr); ckv_pages (NP+1, P, R); krope_pages
// (NP+1, P, Dr); page_table (B, npages) int32 with rows pt_stride apart;
// lengths (B,) int32; part (B, H, splits, R) and part_ml (B, H, splits, 2)
// f32 workspaces; out (B, H, R). Split s covers keys [s * split_keys,
// (s + 1) * split_keys); split_keys is a multiple of 64. R and Dr are
// multiples of 8, R <= 512, both pools 16-byte aligned, and in bf16 a
// staged row (R + Dr, see tc::row_stride) must fit the shared memory
// (paged_mla_decode_max_width). The splits cover the table: splits *
// split_keys >= npages * page_size. Returns the CUDA error code of the
// launches (0 = success).
extern "C" int paged_mla_decode_fwd(const void* q_lat, const void* q_rope,
                                    const void* ckv_pages,
                                    const void* krope_pages,
                                    const int* page_table, long long pt_stride,
                                    int npages, int page_size,
                                    const int* lengths, void* part,
                                    void* part_ml, void* out, int B, int H,
                                    int R, int Dr, float scale, int splits,
                                    int split_keys, int dtype,
                                    void* stream) {
  namespace mla = repro::mla;
  if (B == 0 || H == 0) return 0;
  if (npages < 1 || page_size < 1 || pt_stride < npages || R < 1 ||
      R > mla::kMaxR || R % 8 != 0 || Dr < 0 || Dr % 8 != 0 ||
      splits < 1 || splits > mla::kMaxSplits || split_keys < 1 ||
      split_keys % mla::tc::kBK != 0 ||
      static_cast<long long>(splits) * split_keys <
          static_cast<long long>(npages) * page_size)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* pm = static_cast<float*>(part_ml);
  const int cap = npages * page_size;
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    const int smem = mla::tc::smem_bytes(mla::tc::row_stride(R, Dr));
    if (smem > mla::kMaxSmem) return cudaErrorInvalidValue;
    err = repro::allow_smem(mla::tc::partial, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B, (H + mla::tc::kHG - 1) / mla::tc::kHG, splits);
    mla::tc::partial<<<grid, mla::tc::kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q_lat),
        static_cast<const __nv_bfloat16*>(q_rope),
        static_cast<const __nv_bfloat16*>(ckv_pages),
        static_cast<const __nv_bfloat16*>(krope_pages), page_table,
        pt_stride, npages, page_size, lengths, pa, pm, H, R, Dr, scale,
        split_keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mla::combine<__nv_bfloat16><<<B * H, mla::kCombineThreads, 0, st>>>(
        pa, pm, lengths, cap, split_keys, static_cast<__nv_bfloat16*>(out),
        H, R, splits);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == REPRO_F32) {
    const int smem = mla::cc::smem_bytes(R + Dr);
    if (smem > mla::kMaxSmem) return cudaErrorInvalidValue;
    err = repro::allow_smem(mla::cc::partial, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(B, (H + mla::cc::kHG - 1) / mla::cc::kHG, splits);
    mla::cc::partial<<<grid, mla::cc::kThreads, smem, st>>>(
        static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
        static_cast<const float*>(ckv_pages),
        static_cast<const float*>(krope_pages), page_table, pt_stride,
        npages, page_size, lengths, pa, pm, H, R, Dr, scale, split_keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mla::combine<float><<<B * H, mla::kCombineThreads, 0, st>>>(
        pa, pm, lengths, cap, split_keys, static_cast<float*>(out), H, R,
        splits);
    return static_cast<int>(cudaGetLastError());
  }
  return cudaErrorInvalidValue;
}
