// Shared helpers of the port's CUDA kernels: the dtype codes the Python
// wrappers pass (ops/kernels.py) and exact float/bfloat16/float16
// conversions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Score dtype codes (ops/kernels.py _SCORE_CODES).
enum ScoreCode { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };
// Token id dtype codes (ops/kernels.py _TOKEN_CODES).
enum TokenCode { kInt32 = 0, kUInt16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// Round a float result to the storage type T and back: identity for
// float, round-to-nearest-even to bfloat16 or float16 otherwise — what
// XLA and PyTorch do after each 16-bit elementwise op.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
