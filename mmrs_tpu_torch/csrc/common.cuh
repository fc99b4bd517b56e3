// Helpers shared by the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmrs {

// bf16 is the top half of an f32: widening is a shift, exact.
__device__ __forceinline__ float bf16_lo(uint32_t word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t word) {
  return __uint_as_float(word & 0xffff0000u);
}

// Eight bf16 values packed in 16 bytes -> eight floats, in memory order.
__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x);
  f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
  f[4] = bf16_lo(v.z); f[5] = bf16_hi(v.z);
  f[6] = bf16_lo(v.w); f[7] = bf16_hi(v.w);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

}  // namespace mmrs
