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

}  // namespace repro

// dtype codes shared with the Python wrappers
#define REPRO_F32 0
#define REPRO_BF16 1

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
