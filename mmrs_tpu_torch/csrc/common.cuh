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

// Four int8 (a word, memory order) -> exact floats without the 64-bit-
// path conversion units (I2F runs at a quarter of the FP32 add rate): each
// byte + 128 becomes the low mantissa bits of 2^23, and 2^23 + 128 is
// subtracted, exactly.
__device__ __forceinline__ void s8x4_to_float(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// The two int8 of w's low half -> a bf16x2 word (the first in the low
// half), exactly: |x| <= 128 needs 8 significant bits, so the bf16 is the
// f32's top half.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x8080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

// GELU's tanh approximation with the roundings of PyTorch's CUDA kernel
// (F.gelu(x, approximate="tanh") on f32): x^3 as (x * x) * x, the inner
// sum x + kappa x^3 as one FMA (as nvcc contracts that kernel's
// expression), tanhf, then (0.5 x) (1 + tanh); beta and kappa are that
// kernel's double constants cast to f32.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float beta = static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  const float kappa = static_cast<float>(0.044715);
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(beta, fmaf(kappa, cube, x));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

}  // namespace mmrs
