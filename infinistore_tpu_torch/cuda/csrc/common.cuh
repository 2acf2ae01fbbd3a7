// Helpers shared by the port's Hopper kernels (built with nvcc for sm_90a,
// bound to Python through ctypes: every entry point is extern "C", takes raw
// pointers and a cudaStream_t, launches, and returns cudaGetLastError()).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace its {

// dtype codes shared with cuda/_ext.py (DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// The numeric contract of the JAX package: -1e30 stands for a masked logit
// (not -inf, so max/exp arithmetic never produces NaN).
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's astype
}

// Round an f32 value to T's precision and back (identity for f32).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

}  // namespace its
