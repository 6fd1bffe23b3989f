// Chunked SSD scan (the Mamba2 core) for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `ssd_scan_bhs` (`_ssd_kernel`) of
// src/repro/kernels/ssm_scan.py, behind `ops.ssm_scan`. Same function:
//   state_t = exp(log_a_t) * state_{t-1} + B_t v_t^T,   y_t = C_t . state_t
// from state_0 = 0, with an (N, P) f32 state per (row, head); it emits y and
// the final state, both f32.
//
// Layout: C and B (Bb, S, G, N) with H % G == 0, head h reading group
// h / (H / G) (the reference's jnp.repeat of B and C over the heads; G == H
// is the per-head form), v (Bb, S, H, P), log_a (Bb, S, H), f32, each read
// through its own (row, step, group or head) strides with the last axis
// contiguous and 16-byte aligned: the layout ops.ssm_scan receives, read in
// place. y (Bb, S, H, P) and the state (Bb, H, N, P) are contiguous. N is
// 8, 16, 32 or 64; P 16, 32 or 64.
//
// Grid (Bb * H), heads fastest: one block of four warps per (row, head), so
// the heads of one group run side by side and read the group's B and C
// tiles once from device memory and again from the L2. A loop inside the
// block walks the sequence in tiles of kL = 32 steps (the TPU kernel's
// sequential chunk axis; the tile length is the kernel's own, not the
// caller's chunk). Per tile:
//   1. C, B, v and log_a of the tile come in by cp.async, double-buffered:
//      the next tile's loads run under this tile's products. Steps past S
//      load as zeros (no decay, no input), so a ragged end needs no mask;
//   2. one warp takes lcum, the inclusive cumsum of log_a (a warp scan),
//      while the others multiply C . B^T;
//   3. scores[s][t] = (C_s . B_t) * exp(lcum_s - lcum_t) for t <= s, else 0;
//   4. y_s = exp(lcum_s) * (C_s . state) + sum_t scores[s][t] v_t;
//   5. state = exp(total) * state + sum_t (B_t exp(total - lcum_t)) v_t^T.
// The four products of 2-5 (C.B^T, scores.v, C.state, (B w)^T.v) run on the
// tensor cores (mma.sync m16n8k8) in 3xTF32: each f32 operand is split into
// a TF32 high part and a TF32 residual, and each product is three MMAs
// (lo.hi + hi.lo + hi.hi) with f32 accumulation, which keeps about f32's
// accuracy (one TF32 pass keeps ~3 decimal digits, too few for outputs of
// size 10-100 against a 2e-3 bound). The score products skip the 8 x 16
// blocks above the causal diagonal. Each warp owns part of the state in
// registers from tile to tile; a copy in shared memory feeds the next
// tile's C.state. Every exponent is <= 0 when log_a <= 0 (Mamba2's
// -exp(A_log) * dt is), so the form is stable at any tile length, and the
// results equal the chunked and sequential forms up to f32 rounding. Padded
// steps of a right-padded row (dt = 0: log_a = 0 and v = 0) add exact
// zeros, so such a row's final state is its last valid step's, bit for bit.
//
// What bounds it on the H100: the function reads v and log_a once per head
// and C and B once per group, and writes y and the final state once: ~4 (2P
// + 1) bytes per (step, head) at one group per 56 heads. It does ~4 N P
// FLOPs per (step, head) in the sequential form (16 a byte at N = P = 64),
// which the chunked form raises by its intra-tile products, and 3xTF32
// triples on the tensor cores (the TF32 peak, 495 TFLOP/s, is 7x the f32
// CUDA cores'). PERF.md has its times against both bounds.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kL = 32;         // steps per tile
constexpr int kThreads = 128;  // four warps
constexpr int kSS = kL + 8;    // score tile row stride (floats)

// an input's base pointer and its (row, step, group or head) strides, in
// elements
struct In {
  const float* p;
  long long sb, ss, sh;
  __device__ __forceinline__ const float* at(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

template <int N, int P>
struct Geo {
  // shared-memory row strides (floats), padded so that the fragment loads
  // below are free of bank conflicts
  static constexpr int NS = N + 4;   // C and B tiles
  static constexpr int PS = P + 4;   // v tile
  static constexpr int XS = P + 8;   // the state's copy
  static constexpr int kBuf = 2 * kL * NS + kL * PS + kL;  // C, B, v, log_a
  static constexpr int kFloats = 2 * kBuf + N * XS + kL * kSS + 3 * kL + 4;
  // m16n8 items: y is 2 x NB of them (32 steps x P), the state MB x NB
  static constexpr int MB = (N + 15) / 16;
  static constexpr int NB = P / 8;
  static constexpr int kYPer = 2 * NB / 4;             // a warp's y items
  static constexpr int kXItems = MB * NB;
  static constexpr int kXPer = (kXItems + 3) / 4;      // its state items
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through the L2; `bytes` 0 fills zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 3xTF32 operands: each f32 value as a TF32 high part and a TF32 residual
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// x = hi + lo exactly, hi the top 10 mantissa bits; the MMA reads lo's
// top bits as TF32 too, so x is carried to ~2^-20 of its size
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// m16n8k8 fragments (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g);
// C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <int N, int P>
__global__ void __launch_bounds__(kThreads, 3)
ssd_scan_kernel(In cq, In bk, In vv, In la, float* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int rep) {
  using G = Geo<N, P>;
  constexpr int NS = G::NS, PS = G::PS, XS = G::XS, NB = G::NB;
  extern __shared__ float smem[];
  float* buf = smem;                  // 2 x {C, B, v, log_a} of a tile
  float* sX = smem + 2 * G::kBuf;     // N x XS: the state entering the tile
  float* sS = sX + N * XS;            // kL x kSS: decayed causal scores
  float* sLc = sS + kL * kSS;         // kL: lcum
  float* sE = sLc + kL;               // kL: exp(lcum)
  float* sW = sE + kL;                // kL: exp(total - lcum)
  float* sT = sW + kL;                // total

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float* cb = cq.at(b, h / rep);
  const float* bb = bk.at(b, h / rep);
  const float* vb = vv.at(b, h);
  const float* lb = la.at(b, h);
  const long long y_row = (long long)H * P;
  float* yb = y + (long long)b * S * y_row + (long long)h * P;

  auto load_tile = [&](int t0, float* dst) {
    float* dC = dst;
    float* dB = dC + kL * NS;
    float* dV = dB + kL * NS;
    float* dL = dV + kL * PS;
    for (int i = tid; i < kL * N / 4; i += kThreads) {
      const int r = i / (N / 4), c = (i % (N / 4)) * 4;
      const bool ok = t0 + r < S;
      const long long t = ok ? t0 + r : 0;
      cp_async16(dC + r * NS + c, cb + t * cq.ss + c, ok ? 16 : 0);
      cp_async16(dB + r * NS + c, bb + t * bk.ss + c, ok ? 16 : 0);
    }
    for (int i = tid; i < kL * P / 4; i += kThreads) {
      const int r = i / (P / 4), c = (i % (P / 4)) * 4;
      const bool ok = t0 + r < S;
      cp_async16(dV + r * PS + c, vb + (ok ? t0 + r : 0) * vv.ss + c,
                 ok ? 16 : 0);
    }
    if (tid < kL) {
      const bool ok = t0 + tid < S;
      cp_async4(dL + tid, lb + (ok ? t0 + tid : 0) * la.ss, ok ? 4 : 0);
    }
  };

  // this warp's state items (m-block xm, n-blocks xn0 ..) and y items
  // (m-block ym, n-blocks yn0 ..); contiguous runs share their m-block
  const int xi0 = warp * G::kXPer;
  const int xm = xi0 / NB, xn0 = xi0 % NB;
  const int xcount = max(0, min(G::kXPer, G::kXItems - xi0));
  const int yi0 = warp * G::kYPer;
  const int ym = yi0 / NB, yn0 = yi0 % NB;

  float st[G::kXPer][4];
#pragma unroll
  for (int j = 0; j < G::kXPer; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[j][c] = 0.f;

  load_tile(0, buf);
  cp_async_commit();
  if (kL < S) load_tile(kL, buf + G::kBuf);
  cp_async_commit();

  for (int t0 = 0, it = 0; t0 < S; t0 += kL, ++it) {
    const float* sC = buf + (it & 1) * G::kBuf;
    const float* sB = sC + kL * NS;
    const float* sV = sB + kL * NS;
    const float* sLa = sV + kL * PS;
    cp_async_wait<1>();  // this tile has landed (the next may be in flight)
    __syncthreads();

    // C . B^T: score items (m-block warp / 2, n-blocks 2 (warp % 2) + 0, 1);
    // warp 1's pair lies above the causal diagonal, so it takes the scan
    float cbt[2][2][4] = {};  // [item][k-step parity]: two short chains
    const int sm = warp / 2, sn0 = 2 * (warp % 2);
    if (warp == 1) {
      const float a = sLa[lane];
      float x = a;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += u;
      }
      const float total = __shfl_sync(0xffffffffu, x, 31);
      sLc[lane] = x;
      sE[lane] = expf(x);
      sW[lane] = expf(total - x);
      if (lane == 0) sT[0] = total;
    } else {
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) {
        const float* c0 = sC + (16 * sm + g) * NS + 8 * kk + t4;
        const FragA a = frag_a(c0[0], c0[8 * NS], c0[4], c0[8 * NS + 4]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* b0 = sB + (8 * (sn0 + j) + g) * NS + 8 * kk + t4;
          mma3(cbt[j][kk & 1], a, frag_b(b0[0], b0[4]));
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) cbt[j][0][c] += cbt[j][1][c];
    }
    __syncthreads();

    // decay and the causal mask, into the score tile
    if (warp != 1) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int s = 16 * sm + g + 8 * i;
          const int t = 8 * (sn0 + j) + 2 * t4;
          const float ls = sLc[s];
          float2 v;
          v.x = t <= s ? cbt[j][0][2 * i] * expf(ls - sLc[t]) : 0.f;
          v.y = t + 1 <= s ? cbt[j][0][2 * i + 1] * expf(ls - sLc[t + 1])
                           : 0.f;
          *reinterpret_cast<float2*>(sS + s * kSS + t) = v;
        }
    }
    __syncthreads();

    // y = exp(lcum) * (C . state) + scores . v, for this warp's y items;
    // the two products accumulate apart (C . state in two chains of
    // alternate k-steps), so their MMAs overlap
    {
      float ci[G::kYPer][2][4] = {}, sv[G::kYPer][4] = {};
      if (t0 > 0) {  // the state entering the first tile is zero
#pragma unroll
        for (int kk = 0; kk < N / 8; ++kk) {
          const float* c0 = sC + (16 * ym + g) * NS + 8 * kk + t4;
          const FragA a = frag_a(c0[0], c0[8 * NS], c0[4], c0[8 * NS + 4]);
#pragma unroll
          for (int j = 0; j < G::kYPer; ++j) {
            const float* x0 = sX + (8 * kk + t4) * XS + 8 * (yn0 + j) + g;
            mma3(ci[j][kk & 1], a, frag_b(x0[0], x0[4 * XS]));
          }
        }
      }
      // scores . v over the steps up to this m-block's causal edge; the
      // k index runs over steps 2t and 2t + 1 (the same order in A and B)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (8 * kk > 16 * ym + 15) break;
        const float2 s0 = *reinterpret_cast<const float2*>(
            sS + (16 * ym + g) * kSS + 8 * kk + 2 * t4);
        const float2 s1 = *reinterpret_cast<const float2*>(
            sS + (16 * ym + g + 8) * kSS + 8 * kk + 2 * t4);
        const FragA a = frag_a(s0.x, s1.x, s0.y, s1.y);
#pragma unroll
        for (int j = 0; j < G::kYPer; ++j) {
          const float* v0 = sV + (8 * kk + 2 * t4) * PS + 8 * (yn0 + j) + g;
          mma3(sv[j], a, frag_b(v0[0], v0[PS]));
        }
      }
      const float e[2] = {sE[16 * ym + g], sE[16 * ym + g + 8]};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int s = t0 + 16 * ym + g + 8 * i;
        if (s >= S) continue;
#pragma unroll
        for (int j = 0; j < G::kYPer; ++j) {
          const int c = 2 * i;
          *reinterpret_cast<float2*>(yb + s * y_row + 8 * (yn0 + j) +
                                     2 * t4) =
              make_float2(
                  fmaf(e[i], ci[j][0][c] + ci[j][1][c], sv[j][c]),
                  fmaf(e[i], ci[j][0][c + 1] + ci[j][1][c + 1],
                       sv[j][c + 1]));
        }
      }
    }

    // state = exp(total) * state + (B w)^T . v, w = exp(total - lcum); the
    // k index runs over steps 2t and 2t + 1
    {
      const float decay = expf(sT[0]);
#pragma unroll
      for (int j = 0; j < G::kXPer; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[j][c] *= decay;
      const int n0 = 16 * xm + g;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int s = 8 * kk + 2 * t4;
        const float w0 = sW[s], w1 = sW[s + 1];
        const float* r0 = sB + s * NS;
        const float* r1 = r0 + NS;
        const bool lo_ok = n0 < N, hi_ok = n0 + 8 < N;
        const FragA a = frag_a(lo_ok ? r0[n0] * w0 : 0.f,
                               hi_ok ? r0[n0 + 8] * w0 : 0.f,
                               lo_ok ? r1[n0] * w1 : 0.f,
                               hi_ok ? r1[n0 + 8] * w1 : 0.f);
#pragma unroll
        for (int j = 0; j < G::kXPer; ++j) {
          if (j >= xcount) break;
          const float* v0 = sV + s * PS + 8 * (xn0 + j) + g;
          mma3(st[j], a, frag_b(v0[0], v0[PS]));
        }
      }
    }
    __syncthreads();  // every read of this buffer and of the state copy

    // the state copy for the next tile's C . state, then the loads of the
    // tile after next into the buffer this tile has finished with
#pragma unroll
    for (int j = 0; j < G::kXPer; ++j) {
      if (j >= xcount) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = 16 * xm + g + 8 * i;
        if (n < N)
          *reinterpret_cast<float2*>(sX + n * XS + 8 * (xn0 + j) + 2 * t4) =
              make_float2(st[j][2 * i], st[j][2 * i + 1]);
      }
    }
    if (t0 + 2 * kL < S) load_tile(t0 + 2 * kL, buf + (it & 1) * G::kBuf);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* so = state_out + (long long)blockIdx.x * N * P;
#pragma unroll
  for (int j = 0; j < G::kXPer; ++j) {
    if (j >= xcount) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = 16 * xm + g + 8 * i;
      if (n < N)
        *reinterpret_cast<float2*>(so + n * P + 8 * (xn0 + j) + 2 * t4) =
            make_float2(st[j][2 * i], st[j][2 * i + 1]);
    }
  }
}

template <int N, int P>
cudaError_t launch(In c, In b, In v, In l, float* y, float* state, int Bb,
                   int S, int H, int rep, cudaStream_t stream) {
  const int smem = Geo<N, P>::kFloats * static_cast<int>(sizeof(float));
  auto kernel = ssd_scan_kernel<N, P>;
  static bool set = false;
  if (!set) {
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    // as much of the SM's 228 KB as shared memory as the blocks can use
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return err;
    set = true;
  }
  kernel<<<Bb * H, kThreads, smem, stream>>>(c, b, v, l, y, state, S, H, rep);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_p(In c, In b, In v, In l, float* y, float* state, int Bb,
                     int S, int H, int rep, int P, cudaStream_t st) {
  switch (P) {
    case 16: return launch<N, 16>(c, b, v, l, y, state, Bb, S, H, rep, st);
    case 32: return launch<N, 32>(c, b, v, l, y, state, Bb, S, H, rep, st);
    case 64: return launch<N, 64>(c, b, v, l, y, state, Bb, S, H, rep, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C, B (Bb, S, G, N); v (Bb, S, H, P); log_a (Bb, S, H); all f32 with the
// last axis contiguous, C, B and v 16-byte aligned (base and strides).
// strides: 12 element strides, (row, step, group or head) of C, B, v and
// log_a in that order. y (Bb, S, H, P) and state (Bb, H, N, P) contiguous
// f32. Returns the CUDA error code of the launch (0 = success).
extern "C" int ssd_scan_fwd(const float* C, const float* B, const float* v,
                            const float* log_a, const long long* strides,
                            float* y, float* state, int Bb, int S, int H,
                            int G, int N, int P, void* stream) {
  if (Bb == 0 || H == 0) return 0;
  if (G < 1 || H % G != 0) return cudaErrorInvalidValue;
  const In c{C, strides[0], strides[1], strides[2]};
  const In b{B, strides[3], strides[4], strides[5]};
  const In vv{v, strides[6], strides[7], strides[8]};
  const In l{log_a, strides[9], strides[10], strides[11]};
  const int rep = H / G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 8: err = launch_p<8>(c, b, vv, l, y, state, Bb, S, H, rep, P, st); break;
    case 16: err = launch_p<16>(c, b, vv, l, y, state, Bb, S, H, rep, P, st); break;
    case 32: err = launch_p<32>(c, b, vv, l, y, state, Bb, S, H, rep, P, st); break;
    case 64: err = launch_p<64>(c, b, vv, l, y, state, Bb, S, H, rep, P, st); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
