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
// D 16, 32, 64, 112 (Zamba2's shared block) or 128, f32 softmax and
// accumulator; 64-bit offsets.
//
// Grid (B, Hkv): one block per slot and KV head; the G = H / Hkv query
// heads that share the KV head are handled together, so each K/V row is
// read from device memory once for all of them. Inside the block a loop
// walks 64-key tiles up to the slot's length (the TPU kernels' sequential
// grid axis): the tile's row offsets are resolved once into shared memory,
// the tile is staged in shared memory as f32, scores for all (head, key)
// pairs are computed from it, one warp per head runs the online softmax
// (the reference's -1e30 sentinel, max(l, 1e-30)), and the threads then
// accumulate P.V for their (head, column) outputs in registers.
//
// What bounds it on the H100: one query token reads every live K/V byte
// once and does ~1 FLOP per byte, so the least time is the live cache bytes
// over the memory rate. What the design does about it: it reads only the
// live prefix of each slot, reads each K/V row once for all G heads, and
// loads rows whole and in order (a 64-wide bf16 row is one 128-byte line;
// a page of P rows is P such lines, contiguous). With B * Hkv = 512 blocks
// at the main-path shape the card is filled; split-KV (flash-decoding) for
// small batches and a cp.async / TMA double buffer are later work. PERF.md
// has its times.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // four warps
constexpr int kMaxG = 16;      // query heads per KV head handled by a block

// The slot cache (B, Skv, Hkv, D): key t of slot b is row b * Skv + t.
struct ContiguousRows {
  int skv;
  __device__ __forceinline__ int limit() const { return skv; }
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
  __device__ __forceinline__ int limit() const { return npages * page; }
  __device__ __forceinline__ long long row(int b, int t) const {
    return (long long)pt[b * pt_stride + t / page] * page + t % page;
  }
};

template <int D>
int smem_bytes(int G) {
  // q (G x D), scores (G x BK), K tile (BK x (D+1)), V tile (BK x D),
  // per-head m, l, corr
  return static_cast<int>(sizeof(float)) *
         (G * D + G * kBK + kBK * (D + 1) + kBK * D + 3 * G);
}

template <typename T, int D, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, Rows rows,
              const int* __restrict__ lengths,
              const unsigned char* __restrict__ active, T* __restrict__ out,
              int H, int Hkv, float scale) {
  constexpr int DP = D + 1;
  constexpr int kAcc = kMaxG * D / kThreads;  // accumulators per thread
  const int G = H / Hkv;
  extern __shared__ float smem[];
  float* sq = smem;                 // G x D
  float* ss = sq + G * D;           // G x BK
  float* sk = ss + G * kBK;         // BK x DP
  float* sv = sk + kBK * DP;        // BK x D
  float* sm = sv + kBK * D;         // G running max
  float* sl = sm + G;               // G running sum
  float* sc = sl + G;               // G correction of the current tile
  __shared__ long long srow[kBK];   // element offset of each tile row

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;

  int n = lengths[b];
  if (active != nullptr && !active[b]) n = 0;
  n = max(0, min(n, rows.limit()));

  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) sq[i] = to_float(qb[i]);
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  const long long row_stride = (long long)Hkv * D;
  const T* kb = k + (long long)kvh * D;
  const T* vb = v + (long long)kvh * D;

  for (int t0 = 0; t0 < n; t0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    if (tid < kBK) {
      const int t = t0 + tid;
      srow[tid] = t < n ? rows.row(b, t) * row_stride : -1;
    }
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const long long off = srow[r];
      float kx = 0.f, vx = 0.f;
      if (off >= 0) {
        kx = to_float(kb[off + c]);
        vx = to_float(vb[off + c]);
      }
      sk[r * DP + c] = kx;
      sv[r * D + c] = vx;
    }
    __syncthreads();

    // scores for every (head, key) pair of the tile
    for (int i = tid; i < G * kBK; i += kThreads) {
      const int g = i / kBK, j = i % kBK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sq[g * D + d], sk[j * DP + d], s);
      ss[i] = (t0 + j < n) ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head, two keys per lane
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s0 = ss[g * kBK + lane];
      const float s1 = ss[g * kBK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = (t0 + lane < n) ? expf(s0 - m_new) : 0.f;
      const float p1 = (t0 + lane + 32 < n) ? expf(s1 - m_new) : 0.f;
      ss[g * kBK + lane] = p0;
      ss[g * kBK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sc[g] = corr;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // P.V into this thread's (head, column) accumulators
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        float x = acc[a] * sc[g];
        const float* pg = ss + g * kBK;
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) x = fmaf(pg[j], sv[j * D + d], x);
        acc[a] = x;
      }
    }
  }
  __syncthreads();  // sl is final (also when the loop never ran)

  T* ob = out + ((long long)b * H + (long long)kvh * G) * D;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < G * D) {
      const int g = i / D;
      ob[i] = from_float<T>(acc[a] / fmaxf(sl[g], 1e-30f));
    }
  }
}

template <typename T, int D, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v, Rows rows,
                   const int* lengths, const unsigned char* active, void* out,
                   int B, int H, int Hkv, float scale, cudaStream_t stream) {
  const int smem = smem_bytes<D>(H / Hkv);
  auto kernel = decode_kernel<T, D, Rows>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), rows, lengths, active, static_cast<T*>(out),
      H, Hkv, scale);
  return cudaGetLastError();
}

// Checks the head counts, then dispatches on dtype and head_dim (a template
// argument: 16, 32, 64, 112 or 128). Returns the CUDA error code of the
// launch.
template <typename Rows>
int launch_any(const void* q, const void* k, const void* v, Rows rows,
               const int* lengths, const unsigned char* active, void* out,
               int B, int H, int Hkv, int D, float scale, int dtype,
               void* stream) {
  if (B == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_CASE(T, DD)                                            \
  case DD:                                                                  \
    return static_cast<int>(launch<T, DD, Rows>(q, k, v, rows, lengths,     \
                                                active, out, B, H, Hkv,     \
                                                scale, st));
  if (dtype == REPRO_BF16) {
    switch (D) {
      REPRO_DECODE_CASE(__nv_bfloat16, 16)
      REPRO_DECODE_CASE(__nv_bfloat16, 32)
      REPRO_DECODE_CASE(__nv_bfloat16, 64)
      REPRO_DECODE_CASE(__nv_bfloat16, 112)
      REPRO_DECODE_CASE(__nv_bfloat16, 128)
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (dtype == REPRO_F32) {
    switch (D) {
      REPRO_DECODE_CASE(float, 16)
      REPRO_DECODE_CASE(float, 32)
      REPRO_DECODE_CASE(float, 64)
      REPRO_DECODE_CASE(float, 112)
      REPRO_DECODE_CASE(float, 128)
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef REPRO_DECODE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro
