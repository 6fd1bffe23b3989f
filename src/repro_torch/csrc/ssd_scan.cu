// Chunked SSD scan (the Mamba2 core) for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `ssd_scan_bhs` (`_ssd_kernel`) of
// src/repro/kernels/ssm_scan.py, behind `ops.ssm_scan`. Same function:
//   state_t = exp(log_a_t) * state_{t-1} + B_t v_t^T,   y_t = C_t . state_t
// from state_0 = 0, with an (N, P) f32 state per (row, head); it emits y and
// the final state, both f32.
//
// Layout: C and B (Bb, S, H, N), v (Bb, S, H, P), log_a (Bb, S, H), f32,
// each read through its own (row, step, head) strides with the last axis
// contiguous: the layout ops.ssm_scan receives, read in place (the reference
// copies every input into a (Bb*H, S, .) layout first). y (Bb, S, H, P) and
// the state (Bb, H, N, P) are contiguous. N is 8, 16, 32 or 64; P 16, 32 or
// 64.
//
// Grid (Bb * H): one block of 256 threads per (row, head). A loop inside the
// block walks the sequence in tiles of 64 steps; it replaces the TPU
// kernel's sequential chunk axis. The tile length is the kernel's own, not
// the caller's chunk: a 256 x 256 f32 score tile alone would outgrow a
// block's 227 KB of shared memory. Per tile:
//   1. C, B, v and log_a of the tile into shared memory; steps past S load
//      as zeros (no decay, no input), so a ragged end needs no other mask;
//   2. one warp takes lcum, the inclusive cumsum of log_a, by a warp scan;
//   3. scores[s][t] = (C_s . B_t) * exp(lcum_s - lcum_t) for t <= s, else 0;
//   4. y_s = sum_t scores[s][t] v_t + exp(lcum_s) * (C_s . state);
//   5. state = exp(total) * state + sum_t exp(total - lcum_t) B_t v_t^T.
// Each thread owns a part of the state and keeps it in registers from tile
// to tile; a copy in shared memory feeds the next tile's step 4. Every
// exponent is <= 0 when log_a <= 0 (Mamba2's -exp(A_log) * dt is), so the
// form is stable at any tile length, and the results equal the chunked and
// the sequential forms up to f32 rounding. Padded steps of a right-padded
// row (dt = 0: log_a = 0 and v = 0) add exact zeros, so such a row's final
// state is its last valid step's.
//
// What bounds it on the H100: the function reads C, B and v once and writes
// y once, 4 (2N + 2P + 1) bytes per (step, head), against ~4 N P FLOPs per
// (step, head) in the sequential form: 16 FLOPs a byte at N = P = 64, under
// the ~20 a byte where f32 CUDA-core arithmetic (67 TFLOP/s) meets the
// memory rate, so the least time is set by the bytes. This first version
// does about twice the sequential form's FLOPs (the chunked form's L x L
// intra-tile products) on the CUDA cores in f32, and is bound by them: each
// product runs as a 4 x 4 (4 x P/16) register tile per thread from shared
// memory, and the intra-tile sum stops at the causal edge. Tensor cores,
// cp.async / TMA staging and reading B and C once per group (Zamba2's 56
// heads share each) are later work; PERF.md has its times.

#include "common.cuh"

namespace {

constexpr int kL = 64;         // steps per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kLP = kL + 1;    // padded row stride of the score tile

// an input's base pointer and its (row, step, head) strides, in elements
struct In {
  const float* p;
  long long sb, ss, sh;
  __device__ __forceinline__ const float* at(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

template <int N, int P>
constexpr int smem_floats() {
  // C and B tiles (rows padded to N + 1), v tile, score tile, state,
  // lcum, exp(lcum), exp(total - lcum), total
  return 2 * kL * (N + 1) + kL * P + kL * kLP + N * P + 3 * kL + 1;
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(In cq, In bk, In vv, In la, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H) {
  constexpr int NP1 = N + 1;
  constexpr int PC = P / 16;          // y / state columns per thread
  constexpr int NR = (N + 15) / 16;   // state rows per thread
  extern __shared__ float smem[];
  float* sC = smem;                   // kL x NP1
  float* sB = sC + kL * NP1;          // kL x NP1
  float* sV = sB + kL * NP1;          // kL x P
  float* sS = sV + kL * P;            // kL x kLP
  float* sX = sS + kL * kLP;          // N x P: the state entering the tile
  float* sL = sX + N * P;             // kL: log_a, then lcum
  float* sE = sL + kL;                // kL: exp(lcum)
  float* sW = sE + kL;                // kL: exp(total - lcum)
  float* sT = sW + kL;                // total

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // score and y rows ty*4 .. ty*4+3; state rows ty + 16r
  const int tx = tid % 16;  // score columns tx + 16c; y and state columns tx + 16c
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float* cb = cq.at(b, h);
  const float* bb = bk.at(b, h);
  const float* vb = vv.at(b, h);
  const float* lb = la.at(b, h);
  const long long y_row = (long long)H * P;
  float* yb = y + (long long)b * S * y_row + (long long)h * P;

  float st[NR][PC];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int c = 0; c < PC; ++c) st[r][c] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kL) {
    __syncthreads();  // the previous tile's reads of every buffer are done
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int n = ty + 16 * r;
      if (n < N) {
#pragma unroll
        for (int c = 0; c < PC; ++c) sX[n * P + tx + 16 * c] = st[r][c];
      }
    }
    for (int i = tid; i < kL * N; i += kThreads) {
      const int r = i / N, c = i % N;
      const int t = t0 + r;
      float cx = 0.f, bx = 0.f;
      if (t < S) {
        cx = cb[t * cq.ss + c];
        bx = bb[t * bk.ss + c];
      }
      sC[r * NP1 + c] = cx;
      sB[r * NP1 + c] = bx;
    }
    for (int i = tid; i < kL * P; i += kThreads) {
      const int t = t0 + i / P;
      sV[i] = t < S ? vb[t * vv.ss + i % P] : 0.f;
    }
    if (tid < kL) sL[tid] = t0 + tid < S ? lb[(t0 + tid) * la.ss] : 0.f;
    __syncthreads();

    // inclusive cumsum of the tile's log_a: one warp, two steps a lane
    if (tid < 32) {
      const float a0 = sL[2 * tid], a1 = sL[2 * tid + 1];
      float x = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, x, off);
        if (tid >= off) x += u;
      }
      float prev = __shfl_up_sync(0xffffffffu, x, 1);
      if (tid == 0) prev = 0.f;
      const float total = __shfl_sync(0xffffffffu, x, 31);
      const float l0 = prev + a0;
      sL[2 * tid] = l0;
      sL[2 * tid + 1] = x;
      sE[2 * tid] = expf(l0);
      sE[2 * tid + 1] = expf(x);
      sW[2 * tid] = expf(total - l0);
      sW[2 * tid + 1] = expf(total - x);
      if (tid == 0) sT[0] = total;
    }
    __syncthreads();

    // decayed, causal scores of the tile
    {
      float sc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty * 4 + r) * NP1 + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * NP1 + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = tx + 16 * c;
          sS[s * kLP + t] = t <= s ? sc[r][c] * expf(sL[s] - sL[t]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y of the tile: the intra-tile sum up to the causal edge of the
    // thread's last row, plus the carried state's part
    {
      float acc[4][PC], inter[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = inter[r][c] = 0.f;
      const int t_hi = ty * 4 + 4;
#pragma unroll 4
      for (int t = 0; t < t_hi; ++t) {
        float sv[4], v[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) sv[r] = sS[(ty * 4 + r) * kLP + t];
#pragma unroll
        for (int c = 0; c < PC; ++c) v[c] = sV[t * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(sv[r], v[c], acc[r][c]);
      }
      if (t0 > 0) {  // the state entering the first tile is zero
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          float cv[4], x[PC];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = sC[(ty * 4 + r) * NP1 + n];
#pragma unroll
          for (int c = 0; c < PC; ++c) x[c] = sX[n * P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < PC; ++c)
              inter[r][c] = fmaf(cv[r], x[c], inter[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = ty * 4 + r;
        if (t0 + s >= S) continue;
        const float e = sE[s];
#pragma unroll
        for (int c = 0; c < PC; ++c)
          yb[(t0 + s) * y_row + tx + 16 * c] = fmaf(e, inter[r][c], acc[r][c]);
      }
    }

    // carry the state past the tile (reads sB, sV, sW and sT only, which
    // nothing writes until the next tile's first barrier)
    {
      const float decay = expf(sT[0]);
      float upd[NR][PC];
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) upd[r][c] = 0.f;
#pragma unroll 4
      for (int t = 0; t < kL; ++t) {
        const float w = sW[t];
        float bw[NR], v[PC];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int n = ty + 16 * r;
          bw[r] = n < N ? sB[t * NP1 + n] * w : 0.f;
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) v[c] = sV[t * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) upd[r][c] = fmaf(bw[r], v[c], upd[r][c]);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c)
          st[r][c] = fmaf(st[r][c], decay, upd[r][c]);
    }
  }

  float* so = state_out + (long long)blockIdx.x * N * P;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int n = ty + 16 * r;
    if (n < N) {
#pragma unroll
      for (int c = 0; c < PC; ++c) so[n * P + tx + 16 * c] = st[r][c];
    }
  }
}

template <int N, int P>
cudaError_t launch(In c, In b, In v, In l, float* y, float* state, int Bb,
                   int S, int H, cudaStream_t stream) {
  const int smem = smem_floats<N, P>() * static_cast<int>(sizeof(float));
  auto kernel = ssd_scan_kernel<N, P>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<Bb * H, kThreads, smem, stream>>>(c, b, v, l, y, state, S, H);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_p(In c, In b, In v, In l, float* y, float* state, int Bb,
                     int S, int H, int P, cudaStream_t st) {
  switch (P) {
    case 16: return launch<N, 16>(c, b, v, l, y, state, Bb, S, H, st);
    case 32: return launch<N, 32>(c, b, v, l, y, state, Bb, S, H, st);
    case 64: return launch<N, 64>(c, b, v, l, y, state, Bb, S, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C, B (Bb, S, H, N); v (Bb, S, H, P); log_a (Bb, S, H); all f32 with the
// last axis contiguous. strides: 12 element strides, (row, step, head) of C,
// B, v and log_a in that order. y (Bb, S, H, P) and state (Bb, H, N, P)
// contiguous f32. Returns the CUDA error code of the launch (0 = success).
extern "C" int ssd_scan_fwd(const float* C, const float* B, const float* v,
                            const float* log_a, const long long* strides,
                            float* y, float* state, int Bb, int S, int H,
                            int N, int P, void* stream) {
  if (Bb == 0 || H == 0) return 0;
  const In c{C, strides[0], strides[1], strides[2]};
  const In b{B, strides[3], strides[4], strides[5]};
  const In vv{v, strides[6], strides[7], strides[8]};
  const In l{log_a, strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 8: err = launch_p<8>(c, b, vv, l, y, state, Bb, S, H, P, st); break;
    case 16: err = launch_p<16>(c, b, vv, l, y, state, Bb, S, H, P, st); break;
    case 32: err = launch_p<32>(c, b, vv, l, y, state, Bb, S, H, P, st); break;
    case 64: err = launch_p<64>(c, b, vv, l, y, state, Bb, S, H, P, st); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
