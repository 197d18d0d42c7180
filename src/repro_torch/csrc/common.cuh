// Shared helpers of the port's CUDA kernels (built for sm_90a, see
// repro_torch/kernels/build.py). Every kernel takes float32 or bfloat16
// tensors, computes in float32 and writes the input's type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes passed by the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// the finite mask value of the reference kernels: exp(kMasked - m) is exactly
// 0 once a row has seen one visible score
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace rt
