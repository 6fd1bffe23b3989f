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
// contiguous, in f32 or bf16; D is 16, 32, 64, 112 (Zamba2's shared block)
// or 128, any multiple of 16: each thread owns D / 16 output columns. Scores,
// softmax and the output accumulator are f32.
//
// Grid (ceil(S / 64), B * H): one block owns 64 query rows of one head and
// walks the KV tiles in a loop (the TPU kernel's sequential grid axis). The
// loop starts at the sliding window's first visible key and stops at the
// causal limit of the tile's last row and at kv_len[b], so fully masked
// tiles are never loaded. Key tiles are anchored at position 0 whatever the
// query offset, and a fully masked tile leaves a row's state unchanged bit
// for bit (m stays, corr == 1, p == 0): a tail prefilled with q_offset
// gets exactly the rows a whole-prompt prefill of the same K/V gets. The
// online softmax keeps (m, l, acc) in registers with the reference's -1e30
// sentinel and max(l, 1e-30); masked scores get a weight of exactly 0, so a
// row with no visible key comes out as zeros, never NaN. Ragged S and T are
// masked here, so neither needs to be a multiple of a tile.
//
// What bounds it on the H100: at the main-path shape (S = 512, D = 64,
// causal) the function needs ~128 FLOP per byte, under the card's ~295, so
// the least time is set by the bytes. This first version is bound by
// neither: it multiplies on the CUDA cores in f32 (plain FMA from shared
// memory, a 4 x 4 register tile per thread), far below the tensor cores'
// rate. What the design does about it: each thread reuses every shared
// value four times, the score and P.V products share one f32 row state per
// thread, and fully masked tiles are skipped. Tensor cores (mma.sync, then
// wgmma fed by TMA) are the next step; PERF.md has its times.

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 score tile
constexpr int kSP = kBK + 1;   // padded row stride of the P tile

template <int D>
constexpr int smem_floats() {
  // Q tile + K tile (rows padded to D + 1), V tile, P tile
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kSP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_len, const int* q_offset, void* out, int B,
                   int S, int T_, int H, int Hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, q_offset, static_cast<T*>(out), S, T_,
      H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

// head_dim is a template argument: 16, 32, 64, 112 or 128
template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int* kv_len, const int* q_offset, void* out,
                     int B, int S, int T_, int H, int Hkv, int D, int causal,
                     int window, float scale, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, kv_len, q_offset, out, B, S, T_, H, Hkv,
                           causal, window, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, kv_len, q_offset, out, B, S, T_, H, Hkv,
                           causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, kv_len, q_offset, out, B, S, T_, H, Hkv,
                           causal, window, scale, st);
    case 112:
      return launch<T, 112>(q, k, v, kv_len, q_offset, out, B, S, T_, H, Hkv,
                            causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, kv_len, q_offset, out, B, S, T_, H, Hkv,
                            causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (dtype == REPRO_BF16)
    err = launch_d<__nv_bfloat16>(q, k, v, kv_len, q_offset, out, B, S, T, H,
                                  Hkv, D, causal, window, scale, st);
  else if (dtype == REPRO_F32)
    err = launch_d<float>(q, k, v, kv_len, q_offset, out, B, S, T, H, Hkv, D,
                          causal, window, scale, st);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(err);
}
