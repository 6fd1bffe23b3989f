// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel source is built on its own into a shared library with a plain
// C interface (see repro_torch/kernels/build.py) and loaded with ctypes, so
// this header is included once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// The reference's masked-score sentinel (kernels/ref.py NEG_INF): finite, so
// exp(NEG_INF - m) underflows to 0 instead of producing NaN from inf - inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sets the dynamic shared-memory limit of `kernel` to `bytes` before a
// launch that needs more than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The GEMMs' f32 route on the CUDA cores (grouped_gemm.cu per expert
// segment, dense_gemm.cu per row tile): ob[r, n0 + c] = xb[r, :] . w[:, n0 +
// c] for r < rows, c < kF32BN, one fmaf chain an output over d in order (4 x
// 8 outputs a thread); xb (rows, d) row-major, wb (d, f), or (f, d) with
// kKMajor (the tied unembedding's tok read in place).
constexpr int kF32BM = 64, kF32BN = 64, kF32Threads = 128;

template <bool kKMajor>
__device__ void tile_f32(const float* __restrict__ xb,
                         const float* __restrict__ wb, float* __restrict__ ob,
                         int rows, int d, int f, int n0) {
  constexpr int BM = kF32BM, BN = kF32BN, kThreads = kF32Threads;
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
      // neighbouring threads on neighbouring addresses of w
      const int k = kKMajor ? i % BK : i / BN;
      const int c = kKMajor ? i / BK : i % BN;
      Bs[k][c] = (k0 + k < d && n0 + c < f)
                     ? wb[kKMajor ? (long long)(n0 + c) * d + k0 + k
                                  : (long long)(k0 + k) * f + n0 + c]
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

}  // namespace repro

// dtype codes shared with the Python wrappers
#define REPRO_F32 0
#define REPRO_BF16 1

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
