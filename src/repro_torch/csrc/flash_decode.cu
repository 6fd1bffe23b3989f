// One-token GQA flash-decode over the contiguous slot cache, for Hopper
// (sm_90a), written by hand.
//
// Replaces the TPU kernel `flash_decode` (`_decode_kernel`) of
// src/repro/kernels/decode_attention.py. Same function: q (B, H, D) against
// cache_k / cache_v (B, Skv, Hkv, D) with per-slot valid lengths (B,);
// keys at or past lengths[b] are never read, a slot with length 0 (or with
// active[b] == 0) gets exact zeros. Any Skv is accepted (the reference's
// "Skv <= 512 or a multiple of 512" guard is gone). f32 or bf16, D 16, 32,
// 64 or 128, f32 softmax and accumulator.
//
// Grid (B, Hkv): one block per slot and KV head; the G = H / Hkv query
// heads that share the KV head are handled together, so each K/V row is
// read from device memory once for all of them. Inside the block a loop
// walks 64-key tiles up to the slot's length (the TPU kernel's sequential
// grid axis): the tile is staged in shared memory as f32, scores for all
// (head, key) pairs are computed from it, one warp per head runs the online
// softmax (the reference's -1e30 sentinel, max(l, 1e-30)), and the threads
// then accumulate P.V for their (head, column) outputs in registers.
//
// What bounds it on the H100: one query token reads every live K/V byte
// once and does ~1 FLOP per byte, so the least time is the live cache
// bytes over the memory rate. What the design does about it: it reads only
// the live prefix of each slot, reads each K/V row once for all G heads,
// and loads rows whole and in order (a 64-wide bf16 row is one 128-byte
// line). With B * Hkv = 512 blocks at the main-path shape the card is
// filled; split-KV (flash-decoding) for small batches and a cp.async /
// TMA double buffer are later work. PERF.md has its times.

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // four warps
constexpr int kMaxG = 16;      // query heads per KV head handled by a block

template <int D>
int smem_bytes(int G) {
  // q (G x D), scores (G x BK), K tile (BK x (D+1)), V tile (BK x D),
  // per-head m, l, corr
  return static_cast<int>(sizeof(float)) *
         (G * D + G * kBK + kBK * (D + 1) + kBK * D + 3 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    const unsigned char* __restrict__ active,
                    T* __restrict__ out, int H, int Hkv, int Skv, float scale) {
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

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;

  int n = lengths[b];
  if (active != nullptr && !active[b]) n = 0;
  n = max(0, min(n, Skv));

  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) sq[i] = repro::to_float(qb[i]);
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.f;
  }

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  const long long row_stride = (long long)Hkv * D;
  const T* kb = k + (long long)b * Skv * row_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * Skv * row_stride + (long long)kvh * D;

  for (int t0 = 0; t0 < n; t0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int t = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < n) {
        kx = repro::to_float(kb[t * row_stride + c]);
        vx = repro::to_float(vb[t * row_stride + c]);
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
      ob[i] = repro::from_float<T>(acc[a] / fmaxf(sl[g], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const unsigned char* active, void* out,
                   int B, int H, int Hkv, int Skv, float scale,
                   cudaStream_t stream) {
  const int smem = smem_bytes<D>(H / Hkv);
  auto kernel = flash_decode_kernel<T, D>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, active, static_cast<T*>(out), H, Hkv,
      Skv, scale);
  return cudaGetLastError();
}

// head_dim is a template argument: 16, 32, 64 or 128
template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* lengths, const unsigned char* active,
                     void* out, int B, int H, int Hkv, int Skv, int D,
                     float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, active, out, B, H, Hkv, Skv,
                           scale, st);
    case 32:
      return launch<T, 32>(q, k, v, lengths, active, out, B, H, Hkv, Skv,
                           scale, st);
    case 64:
      return launch<T, 64>(q, k, v, lengths, active, out, B, H, Hkv, Skv,
                           scale, st);
    case 128:
      return launch<T, 128>(q, k, v, lengths, active, out, B, H, Hkv, Skv,
                            scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D); cache_k, cache_v (B, Skv, Hkv, D); lengths (B,) int32;
// active (B,) uint8 or null; out (B, H, D). Returns the CUDA error code of
// the launch (0 = success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const int* lengths,
                                const unsigned char* active, void* out, int B,
                                int H, int Hkv, int Skv, int D, float scale,
                                int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxG)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == REPRO_BF16)
    err = launch_d<__nv_bfloat16>(q, k, v, lengths, active, out, B, H, Hkv,
                                  Skv, D, scale, st);
  else if (dtype == REPRO_F32)
    err = launch_d<float>(q, k, v, lengths, active, out, B, H, Hkv, Skv, D,
                          scale, st);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(err);
}
