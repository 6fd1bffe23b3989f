// Grouped expert GEMM over rows sorted by expert, for Hopper (sm_90a),
// written by hand.
//
// Replaces the TPU kernel `grouped_gemm` (`_gemm_kernel`) of
// src/repro/kernels/moe_gemm.py: per-expert matmuls with f32 accumulation
// and the output in the input's dtype. One body serves both entry points
// of repro_torch/kernels/moe_gemm.py:
//   * segments: x (N, d) whose rows are grouped by expert (expert e's
//     counts[e] rows right after expert e-1's), counts (E,) int32 on the
//     device, w (E, d, f) -> out (N, f). The MoE FFN's dispatch calls it
//     three times per layer (gate, up, down).
//   * the reference's (E, C, d) x (E, d, f) -> (E, C, f): uniform segments
//     of C rows.
// Rows past sum(counts) are not written.
//
// The TPU kernel's grid was (E, C / bc, f / bf, d / bd) over a padded
// (E, C, d) layout with the contraction as its sequential axis, and it
// asserted d % 512 == 0 at its default tiles, which DeepSeek's expert
// width 1408 = 11 x 128 fails. Here the grid is (ceil(N / BM) + E,
// ceil(f / BN)), sized from N and E alone, so no host sync is needed to
// learn the segment sizes. In each block one warp scans the E counts
// (tiles per expert, ceil(count / BM), and rows before it) to find which
// BM-row tile of which expert is its own; the grid's spare tiles, and so
// the experts no row chose, return at once, and each BN-column strip of an
// expert's weights is read only by the tiles of that expert. The
// contraction walks 32-deep slices in a loop; ragged rows, columns and
// depth are masked to zero, so any d and f that are multiples of 8 work
// (2048 and 1408 alike).
//
// bf16 runs on the tensor cores through the WMMA API (mma.sync, 16 x 16 x
// 16 fragments, f32 accumulators) on 128 x 128 tiles: eight warps of 32 x
// 64, the x and w slices of the next 32-deep step copied into shared
// memory with cp.async (16 bytes each, zero-filled past the edges) while
// the tensor cores work on the current one (two stages); the wrapper
// refuses widths that are not multiples of 8 and pointers that are not
// 16-byte aligned, so every copy and store moves whole 16-byte chunks. f32
// runs on the CUDA cores on 64 x 64 tiles (4 x 8 outputs a thread).
//
// What bounds it on the H100: at decode (16 tokens x 6 choices = 96 rows
// over 64 experts) nearly every expert's whole weights are read for one or
// two rows, so it is bound by the weight bytes over the memory rate; at a
// prefill wave (16 x 512 x 6 = 49 152 rows, ~770 per expert) it is bound by
// the tensor cores' bf16 rate. mma.sync reaches a fraction of the wgmma
// rate, and two stages hide only part of the load latency; a persistent
// wgmma kernel fed by TMA is later work. PERF.md has its times.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace gemm {

// rows, columns and threads of a block's tile, by dtype
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BM = 64, BN = 64, kThreads = 128;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 128, kThreads = 256;
};

// 16 bytes global -> shared without passing through registers; src_size 0
// zero-fills (the source address is then not read, but must be valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

// two floats as the bits of a bf16 pair (the first in the low half)
__device__ __forceinline__ unsigned pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&t);
}

// bf16 tile: out[r, n0 + c] for r < rows, c < 128, on the tensor cores.
__device__ void tile_bf16(const __nv_bfloat16* __restrict__ xb,
                          const __nv_bfloat16* __restrict__ wb,
                          __nv_bfloat16* __restrict__ ob, int rows, int d,
                          int f, int n0) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int BM = 128, BN = 128, BK = 32;
  constexpr int LA = BK + 8;   // padded leading dims (multiples of 8)
  constexpr int LB = BN + 8;
  constexpr int kThreads = Tile<bf16>::kThreads;
  // raw 16-bit storage: a __shared__ array takes no element constructor
  __shared__ __align__(128) unsigned short As_raw[2 * BM * LA];
  __shared__ __align__(128) unsigned short Bs_raw[2 * BK * LB];
  __shared__ __align__(128) float Cs[kThreads / 32 * 16 * 16];
  bf16* As = reinterpret_cast<bf16*>(As_raw);
  bf16* Bs = reinterpret_cast<bf16*>(Bs_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 32 x 64
  const int nk = (d + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    bf16* A = As + stage * BM * LA;
    bf16* B = Bs + stage * BK * LB;
    for (int ch = tid; ch < BM * BK / 8; ch += kThreads) {
      const int r = ch / (BK / 8), kc = (ch % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < d;  // d % 8 == 0: all 8 or none
      cp_async16(A + r * LA + kc, ok ? xb + (long long)r * d + k0 + kc : xb,
                 ok);
    }
    for (int ch = tid; ch < BK * BN / 8; ch += kThreads) {
      const int r = ch / (BN / 8), nc = (ch % (BN / 8)) * 8;
      const bool ok = k0 + r < d && n0 + nc < f;
      cp_async16(B + r * LB + nc,
                 ok ? wb + (long long)(k0 + r) * f + n0 + nc : wb, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();     // (an empty group on the last step)
    cp_async_wait_prev();  // step kt's copies have landed
    __syncthreads();
    const bf16* A = As + (kt & 1) * BM * LA;
    const bf16* B = Bs + (kt & 1) * BK * LB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], A + (wm * 32 + i * 16) * LA + kk, LA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], B + kk * LB + wn * 64 + j * 16, LB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // step kt's stage is free for step kt + 2's copies
  }

  // each warp writes its fragments through a 16 x 16 f32 scratch
  float* cw = Cs + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = wm * 32 + i * 16 + r;
      const int col = n0 + wn * 64 + j * 16 + c0;
      if (row < rows && col < f) {  // f % 8 == 0: all 8 columns in range
        const float* c = cw + r * 16 + c0;
        *reinterpret_cast<uint4*>(ob + (long long)row * f + col) =
            make_uint4(pack2(c[0], c[1]), pack2(c[2], c[3]),
                       pack2(c[4], c[5]), pack2(c[6], c[7]));
      }
      __syncwarp();
    }
}

// f32 tile: out[r, n0 + c] for r < rows, c < 64, on the CUDA cores.
__device__ void tile_f32(const float* __restrict__ xb,
                         const float* __restrict__ wb, float* __restrict__ ob,
                         int rows, int d, int f, int n0) {
  constexpr int BM = Tile<float>::BM, BN = Tile<float>::BN;
  constexpr int kThreads = Tile<float>::kThreads;
  constexpr int BK = 16;
  __shared__ float As[BK][BM + 4];  // depth-major: a column per row
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 8;  // rows ty * 4 .. + 3
  const int tx = tid % 8;  // columns tx * 8 .. + 7
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, k = i % BK;
      As[k][r] = (r < rows && k0 + k < d) ? xb[(long long)r * d + k0 + k]
                                          : 0.f;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int k = i / BN, c = i % BN;
      Bs[k][c] = (k0 + k < d && n0 + c < f)
                     ? wb[(long long)(k0 + k) * f + n0 + c]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[k][tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tx * 8 + j;
      if (r < rows && c < f) ob[(long long)r * f + c] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Tile<T>::kThreads, 2)
grouped_gemm_kernel(const T* __restrict__ x, const int* __restrict__ counts,
                    const T* __restrict__ w, T* __restrict__ out, int N,
                    int E, int d, int f) {
  constexpr int BM = Tile<T>::BM, BN = Tile<T>::BN;
  __shared__ int s_tile[3];  // expert, first row, rows
  const int tid = threadIdx.x;

  // warp 0: inclusive scans of tiles and rows per expert, 32 experts at a
  // time; the lane whose expert's tile range holds this block's tile
  // records it
  if (tid < 32) {
    const int lane = tid;
    const int t = blockIdx.x;
    if (lane == 0) s_tile[0] = -1;
    __syncwarp();
    int tiles_base = 0, rows_base = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < E ? max(0, __ldg(counts + e)) : 0;
      const int nt = (c + BM - 1) / BM;
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
      const int t_lo = tiles_base + st - nt;
      if (t >= t_lo && t < t_lo + nt) {
        const int k = t - t_lo;
        s_tile[0] = e;
        s_tile[1] = rows_base + sr - c + k * BM;
        s_tile[2] = min(BM, c - k * BM);
      }
      tiles_base += __shfl_sync(0xffffffffu, st, 31);
      rows_base += __shfl_sync(0xffffffffu, sr, 31);
    }
  }
  __syncthreads();
  const int e = s_tile[0];
  if (e < 0) return;  // a spare tile of the grid
  const int row0 = s_tile[1];
  const int rows = min(s_tile[2], N - row0);  // counts past N are cut at N
  if (rows <= 0) return;
  const int n0 = blockIdx.y * BN;
  const T* xb = x + (long long)row0 * d;
  const T* wb = w + (long long)e * d * f;
  T* ob = out + (long long)row0 * f;
  if constexpr (std::is_same<T, float>::value)
    tile_f32(xb, wb, ob, rows, d, f, n0);
  else
    tile_bf16(xb, wb, ob, rows, d, f, n0);
}

template <typename T>
cudaError_t launch(const void* x, const int* counts, const void* w,
                   void* out, int N, int E, int d, int f,
                   cudaStream_t stream) {
  constexpr int BM = Tile<T>::BM, BN = Tile<T>::BN;
  dim3 grid((N + BM - 1) / BM + E, (f + BN - 1) / BN);
  grouped_gemm_kernel<T><<<grid, Tile<T>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), counts, static_cast<const T*>(w),
      static_cast<T*>(out), N, E, d, f);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace repro

// x (N, d) rows grouped by expert; counts (E,) int32; w (E, d, f); out
// (N, f); d and f multiples of 8, x, w and out 16-byte aligned. Returns
// the CUDA error code of the launch (0 = success).
extern "C" int grouped_gemm_fwd(const void* x, const int* counts,
                                const void* w, void* out, int N, int E, int d,
                                int f, int dtype, void* stream) {
  if (N == 0 || f == 0) return 0;
  if (E < 1 || d < 1 || N < 0 || f < 0 || d % 8 != 0 || f % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return static_cast<int>(repro::gemm::launch<__nv_bfloat16>(
        x, counts, w, out, N, E, d, f, st));
  if (dtype == REPRO_F32)
    return static_cast<int>(
        repro::gemm::launch<float>(x, counts, w, out, N, E, d, f, st));
  return cudaErrorInvalidValue;
}
