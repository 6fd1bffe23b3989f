// One-token GQA flash-decode, shared by the slot-cache and paged entry
// points (flash_decode.cu and paged_flash_decode.cu), for Hopper (sm_90a),
// written by hand.
//
// q (B, H, D) against K/V rows addressed by a `Rows` policy: key t of slot b
// is row `rows.row(b, t)` of a (rows, Hkv, D) K and V. The slot cache
// (B, Skv, Hkv, D) is the identity table (row b * Skv + t); the paged pool
// (NP+1, P, Hkv, D) reads the row through the slot's page table
// (row pt[b, t / P] * P + t % P), so any page size works and only table
// columns j < ceil(n / P) are ever read. Keys at or past the slot's length
// n are never read, and a slot with n == 0 gets exact zeros. f32 or bf16,
// D 16, 32, 64, 80 (H2O-Danube), 112 (Zamba2's shared block), 128 or 160
// (StableLM-12B), f32 softmax and accumulators (the reference's -1e30
// sentinel, max(l, 1e-30)); 64-bit offsets.
//
// What bounds it on the H100: one query token reads every live K/V byte
// once and does ~1 FLOP per byte, so the least time is the live cache bytes
// over the memory rate (the main shape's 68 MB: 20 us). The first design
// (one block per (slot, KV head) walking its keys in 64-key tiles staged
// through shared memory as f32 with scalar loads) reached 250 GB/s: little
// was in flight per SM, half the threads idled at G = 1, and the longest
// slot set the time alone.
//
// Split-KV (flash-decoding) with a combine pass:
//   * decode_partial's grid is (splits, Hkv, B). Split s covers keys
//     [s * kSplit, (s + 1) * kSplit): fixed key positions, the same for the
//     slot cache and the page table whatever their capacities, B or the SM
//     count, so both entry points sum every slot's keys in the same order
//     and give the same bits. A block whose split starts at or past the
//     slot's length returns at once. It writes its unnormalised f32
//     accumulators and its (m, l) per head to scratch the wrapper allocates.
//   * In a block, a lane group of kLanes lanes holds one K/V row: each lane
//     loads 16 bytes of it straight into registers (a D 64 bf16 row is 8
//     lanes, a D 80 row 10 of 16, a D 112 row 14 of 16; a row of more than
//     32 chunks, f32 at D 160, gives each lane kPer adjacent chunks, 2 x 16
//     bytes on 20 of 32 lanes), so a warp holds 32 / kLanes rows and
//     each lane keeps U rows of K and of V in flight before their first use;
//     no shared-memory staging. Scores come from shuffle reductions within
//     the lane group, every lane runs the online softmax of its group's
//     rows and accumulates P.V for its 16-byte slice of the head dim in
//     registers, so at G = 1 every thread is busy. For G > 1 a row read
//     once serves all G heads of the KV head.
//   * The lane groups of a warp, then the four warps, merge in a fixed
//     order; decode_combine weighs a slot's live splits by exp(m_s - max m)
//     in split order and divides by max(l, 1e-30). No atomics: the same
//     inputs give the same bits.
//   * On request (a non-null `lse`, the slot-cache entry point only)
//     decode_combine also writes each (slot, head)'s log-sum-exp of the
//     scaled scores, max m + log(sum l) in f32, -inf for a slot with no
//     live key: what a caller needs to merge this output with those of
//     other key ranges (a cache sharded on its sequence over ranks). The
//     output's arithmetic is the same with or without it.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int kSplit = 256;    // keys a split (kernels/decode_attention.py)
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;      // query heads per KV head
constexpr int kCombineThreads = 128;

// The slot cache (B, Skv, Hkv, D): key t of slot b is row b * Skv + t.
struct ContiguousRows {
  int skv;
  __host__ __device__ __forceinline__ int limit() const { return skv; }
  __device__ __forceinline__ long long row(int b, int t) const {
    return (long long)b * skv + t;
  }
};

// The paged pool (NP+1, P, Hkv, D) behind a (B, npages) page table whose
// rows are `pt_stride` ints apart: key t of slot b is row
// pt[b, t / P] * P + t % P.
struct PagedRows {
  const int* pt;
  long long pt_stride;
  int npages;
  int page;
  __host__ __device__ __forceinline__ int limit() const {
    return npages * page;
  }
  __device__ __forceinline__ long long row(int b, int t) const {
    return (long long)pt[b * pt_stride + t / page] * page + t % page;
  }
};

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

// How a row of D values of T spreads over the lanes of a warp: lane c of
// a row's group holds chunks c * kPer .. c * kPer + kPer - 1 (those below
// kChunks), kW values.
template <typename T, int D>
struct RowLayout {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // a chunk
  static constexpr int kChunks = D / kVec;  // 16-byte chunks a row
  static constexpr int kPer = (kChunks + 31) / 32;  // chunks a lane
  static constexpr int kW = kPer * kVec;            // values a lane
  static constexpr int kLanes =
      pow2_at_least((kChunks + kPer - 1) / kPer);   // lanes a row
  static constexpr int kRows = 32 / kLanes;  // rows a warp holds at once
  static_assert(D % kVec == 0 && kLanes <= 32, "unsupported head dim");
};

__device__ __forceinline__ void unpack(uint4 u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// The slot's live length as both kernels see it.
template <typename Rows>
__device__ __forceinline__ int live_length(const Rows& rows,
                                           const int* lengths,
                                           const unsigned char* active,
                                           int b) {
  int n = lengths[b];
  if (active != nullptr && !active[b]) n = 0;
  return max(0, min(n, rows.limit()));
}

// kG: the group size rounded up to 1, 4 or 16 (heads g >= G are skipped).
template <typename T, int D, int kG, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, Rows rows,
               const int* __restrict__ lengths,
               const unsigned char* __restrict__ active,
               float* __restrict__ part, float* __restrict__ part_ml, int H,
               int Hkv, int nsplit, float scale) {
  using L = RowLayout<T, D>;
  constexpr int V = L::kVec, NP = L::kPer, W = L::kW, LN = L::kLanes,
                RW = L::kRows;
  constexpr int U = kG <= 4 ? 4 : 2;  // rows in flight a lane group
  constexpr bool kQReg = kG * W <= 32;  // q in registers, else shared
  // q while the keys are read, then each warp's merged accumulators
  // (kG x D a warp); one buffer keeps the block under 48 KB at D 160
  __shared__ float sbuf[kWarps * kG * D];
  __shared__ float sml[kWarps][kG][2];
  float* sq = sbuf;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n = live_length(rows, lengths, active, b);
  const int t_lo = split * kSplit;
  if (t_lo >= n) return;
  const int t_hi = min(n, t_lo + kSplit);
  const int G = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LN;  // the row this lane's group holds
  const int c = lane % LN;    // its chunks c * NP .. of the row
  bool has[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) has[j] = c * NP + j < L::kChunks;

  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < kG * D; i += kThreads)
    sq[i] = i < G * D ? to_float(qb[i]) : 0.f;
  __syncthreads();
  float qr[kQReg ? kG : 1][W];
  if constexpr (kQReg) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < W; ++e)
        qr[g][e] = has[e / V] ? sq[g * D + c * W + e] : 0.f;
  }

  float m[kG], l[kG], acc[kG][W];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[g][e] = 0.f;
  }

  const long long rstride = (long long)Hkv * D;
  const T* kb = k + (long long)kvh * D + c * W;
  const T* vb = v + (long long)kvh * D + c * W;
  constexpr int kStep = kWarps * RW * U;  // keys a block iteration
  for (int t0 = t_lo + warp * RW * U; t0 < t_hi; t0 += kStep) {
    uint4 kr[U][NP], vr[U][NP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * RW + grp;
#pragma unroll
      for (int j = 0; j < NP; ++j)
        kr[u][j] = vr[u][j] = make_uint4(0u, 0u, 0u, 0u);
      if (t < t_hi) {
        const long long off = rows.row(b, t) * rstride;
#pragma unroll
        for (int j = 0; j < NP; ++j)
          if (has[j]) {
            kr[u][j] = __ldg(reinterpret_cast<const uint4*>(kb + off +
                                                            j * V));
            vr[u][j] = __ldg(reinterpret_cast<const uint4*>(vb + off +
                                                            j * V));
          }
      }
    }
    float s[U][kG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[W];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float x[V];
        unpack(kr[u][j], x);
#pragma unroll
        for (int i = 0; i < V; ++i) kx[j * V + i] = x[i];
      }
      const bool live = t0 + u * RW + grp < t_hi;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          float qv;
          if constexpr (kQReg)
            qv = qr[g][e];
          else
            qv = has[e / V] ? sq[g * D + c * W + e] : 0.f;
          dot = fmaf(qv, kx[e], dot);
        }
#pragma unroll
        for (int off = LN / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][g] = live ? dot * scale : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= G) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      float p[U];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = t0 + u * RW + grp < t_hi ? expf(s[u][g] - mx) : 0.f;
        sum += p[u];
      }
      l[g] = fmaf(l[g], corr, sum);
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          float vx[V];
          unpack(vr[u][j], vx);
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[g][j * V + i] = fmaf(p[u], vx[i], acc[g][j * V + i]);
        }
      }
    }
  }

  // merge the warp's lane groups (rows), then the four warps, in order
#pragma unroll
  for (int off = LN; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float a = expf(m[g] - mx), bo = expf(mo - mx);
      l[g] = fmaf(l[g], a, lo * bo);
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = fmaf(acc[g][e], a, ao * bo);
      }
    }
  }
  __syncthreads();  // every warp is done with q before sbuf takes sacc
  float* sacc = sbuf;  // [kWarps][kG][D]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (has[e / V]) sacc[(warp * kG + g) * D + c * W + e] = acc[g][e];
      if (c == 0) {
        sml[warp][g][0] = m[g];
        sml[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sml[w][g][0]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sml[w][g][0] - mx);
      lt = fmaf(sml[w][g][1], a, lt);
      at = fmaf(sacc[(w * kG + g) * D + dd], a, at);
    }
    const long long o = ((long long)b * H + (long long)kvh * G + g) * nsplit +
                        split;
    part[o * D + dd] = at;
    if (dd == 0) {
      part_ml[2 * o] = mx;
      part_ml[2 * o + 1] = lt;
    }
  }
}

// One thread per output value: out[b, h, d] = sum_s w_s acc_s[d] /
// max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max m), over the slot's live
// splits in order; a slot with no live key gets exact zeros. With `lse`
// the thread of d == 0 also writes lse[b, h] = max m + log(sum_s w_s l_s),
// -inf for a slot with no live key.
template <typename T, typename Rows>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine(const float* __restrict__ part,
               const float* __restrict__ part_ml, Rows rows,
               const int* __restrict__ lengths,
               const unsigned char* __restrict__ active, T* __restrict__ out,
               float* __restrict__ lse, int B, int H, int D, int nsplit) {
  const long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= (long long)B * H * D) return;
  const long long bh = i / D;
  const int dd = static_cast<int>(i % D);
  const int b = static_cast<int>(bh / H);
  const int n = live_length(rows, lengths, active, b);
  const int ns = (n + kSplit - 1) / kSplit;
  const float* ml = part_ml + bh * nsplit * 2;
  const float* p = part + bh * nsplit * D + dd;
  float mx = kNegInf;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float w = expf(ml[2 * s] - mx);
    lt = fmaf(w, ml[2 * s + 1], lt);
    at = fmaf(w, p[(long long)s * D], at);
  }
  out[i] = from_float<T>(at / fmaxf(lt, 1e-30f));
  if (lse != nullptr && dd == 0)
    lse[bh] = ns > 0 ? mx + logf(lt) : -__int_as_float(0x7f800000);
}

template <typename T, int D, int kG, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, Rows rows,
                   const int* lengths, const unsigned char* active,
                   float* part, float* part_ml, void* out, float* lse, int B,
                   int H, int Hkv, int nsplit, float scale,
                   cudaStream_t stream) {
  dim3 grid(nsplit, Hkv, B);
  decode_partial<T, D, kG, Rows><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), rows, lengths, active, part, part_ml, H, Hkv,
      nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)B * H * D;
  const int blocks =
      static_cast<int>((total + kCombineThreads - 1) / kCombineThreads);
  decode_combine<T, Rows><<<blocks, kCombineThreads, 0, stream>>>(
      part, part_ml, rows, lengths, active, static_cast<T*>(out), lse, B, H,
      D, nsplit);
  return cudaGetLastError();
}

template <typename T, int D, typename Rows>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     Rows rows, const int* lengths,
                     const unsigned char* active, float* part,
                     float* part_ml, void* out, float* lse, int B, int H,
                     int Hkv, int nsplit, float scale, cudaStream_t stream) {
  if (G == 1)
    return launch<T, D, 1, Rows>(q, k, v, rows, lengths, active, part,
                                 part_ml, out, lse, B, H, Hkv, nsplit, scale,
                                 stream);
  if (G <= 4)
    return launch<T, D, 4, Rows>(q, k, v, rows, lengths, active, part,
                                 part_ml, out, lse, B, H, Hkv, nsplit, scale,
                                 stream);
  return launch<T, D, kMaxG, Rows>(q, k, v, rows, lengths, active, part,
                                   part_ml, out, lse, B, H, Hkv, nsplit,
                                   scale, stream);
}

// Checks the head counts and the scratch's split count, then dispatches on
// dtype, head_dim (a template argument: 16, 32, 64, 80, 112, 128 or 160)
// and group.
// part is (B, H, nsplit, D) f32 and part_ml (B, H, nsplit, 2) f32, nsplit
// = ceil(rows.limit() / kSplit); lse is (B, H) f32 or null (not written).
// Returns the CUDA error code of the launches.
template <typename Rows>
int launch_any(const void* q, const void* k, const void* v, Rows rows,
               const int* lengths, const unsigned char* active, void* part,
               void* part_ml, void* out, void* lse, int B, int H, int Hkv,
               int D, int nsplit, float scale, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG || rows.limit() < 1 ||
      nsplit != (rows.limit() + kSplit - 1) / kSplit)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part);
  float* pm = static_cast<float*>(part_ml);
  float* ls = static_cast<float*>(lse);
  const int G = H / Hkv;
#define REPRO_DECODE_CASE(T, DD)                                           \
  case DD:                                                                 \
    return static_cast<int>(launch_g<T, DD, Rows>(G, q, k, v, rows,        \
                                                  lengths, active, pa, pm, \
                                                  out, ls, B, H, Hkv,      \
                                                  nsplit, scale, st));
  if (dtype == REPRO_BF16) {
    switch (D) {
      REPRO_DECODE_CASE(__nv_bfloat16, 16)
      REPRO_DECODE_CASE(__nv_bfloat16, 32)
      REPRO_DECODE_CASE(__nv_bfloat16, 64)
      REPRO_DECODE_CASE(__nv_bfloat16, 80)
      REPRO_DECODE_CASE(__nv_bfloat16, 112)
      REPRO_DECODE_CASE(__nv_bfloat16, 128)
      REPRO_DECODE_CASE(__nv_bfloat16, 160)
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (dtype == REPRO_F32) {
    switch (D) {
      REPRO_DECODE_CASE(float, 16)
      REPRO_DECODE_CASE(float, 32)
      REPRO_DECODE_CASE(float, 64)
      REPRO_DECODE_CASE(float, 80)
      REPRO_DECODE_CASE(float, 112)
      REPRO_DECODE_CASE(float, 128)
      REPRO_DECODE_CASE(float, 160)
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef REPRO_DECODE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro
