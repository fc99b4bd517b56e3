// The float dense layer's epilogue in one pass (mmrs_tpu_torch/ops/
// dense_epilogue.py): the f32 sums of a bf16 GEMM, plus the f32 bias,
// rounded once to bf16, then optionally QuickGELU or GELU with the
// roundings of the plain PyTorch ops it replaces, written as bf16.
//
// Replaces the Pallas TPU kernel: none. The JAX package leaves this
// epilogue to XLA, which fuses it into the matrix product; the port's
// `dense` ran it as separate PyTorch ops.
//
// The pass is bound by bytes (4 read and 2 written an element). A thread
// takes 8 columns of a row: two 16-byte f32 loads and one 16-byte bf16
// store. The grid's thread count is a multiple of the row's 8-column
// groups (`bias_act_plan`), so each thread keeps one group for the whole
// call: its 8 bias values are read once into registers, and it strides
// down the rows.
//
// Arithmetic, equal bit for bit to PyTorch's CUDA kernels on the same
// values (no FMA contraction: every step is rounded as those kernels
// round it):
//   y = bf16_rn(acc + b)                     torch.add(acc, b, out=bf16)
//   QuickGELU: s = bf16_rn(1 / (1 + expf(-(1.702f * y))))   sigmoid, .to()
//              out = bf16_rn(y * s)                          x * s in bf16
//   GELU:      out = bf16_rn(y * 0.5f * (1 + erff(y * M_SQRT1_2)))
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
enum Act { kNone = 0, kQuickGelu = 1, kGelu = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == kQuickGelu) {
    // the scalar 1.702 as PyTorch's kernel takes it: the double cast to f32
    const float t = __fmul_rn(static_cast<float>(1.702), y);
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t)));
    return __fmul_rn(y, round_bf16(s));
  } else if (ACT == kGelu) {
    const float alpha = static_cast<float>(M_SQRT1_2);
    return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(y, alpha))));
  }
  return y;
}

// Two values -> a bf16x2 word, the first in the low half.
template <int ACT, bool BIAS>
__device__ __forceinline__ uint32_t epilogue2(float a0, float a1, float b0, float b1) {
  const float y0 = round_bf16(BIAS ? __fadd_rn(a0, b0) : a0);
  const float y1 = round_bf16(BIAS ? __fadd_rn(a1, b1) : a1);
  const __nv_bfloat162 o = __floats2bfloat162_rn(activate<ACT>(y0), activate<ACT>(y1));
  return *reinterpret_cast<const uint32_t*>(&o);
}

template <int ACT, bool BIAS>
__global__ void __launch_bounds__(kThreads)
    bias_act_kernel(const float4* __restrict__ y, const float* __restrict__ bias,
                    uint4* __restrict__ out, long long vecs, int groups) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float b[8];
  const int c = static_cast<int>(v % groups);   // the same for every row
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = BIAS ? __ldg(bias + c * 8 + i) : 0.0f;
  for (; v < vecs; v += stride) {
    const float4 lo = __ldcs(y + 2 * v);
    const float4 hi = __ldcs(y + 2 * v + 1);
    uint4 o;
    o.x = epilogue2<ACT, BIAS>(lo.x, lo.y, b[0], b[1]);
    o.y = epilogue2<ACT, BIAS>(lo.z, lo.w, b[2], b[3]);
    o.z = epilogue2<ACT, BIAS>(hi.x, hi.y, b[4], b[5]);
    o.w = epilogue2<ACT, BIAS>(hi.z, hi.w, b[6], b[7]);
    out[v] = o;
  }
}

template <int ACT, bool BIAS>
int launch(const void* y, const void* bias, void* out, long long m, int n, int blocks,
           cudaStream_t s) {
  const int groups = n / 8;
  bias_act_kernel<ACT, BIAS><<<blocks, kThreads, 0, s>>>(
      static_cast<const float4*>(y), static_cast<const float*>(bias),
      static_cast<uint4*>(out), m * groups, groups);
  return static_cast<int>(cudaGetLastError());
}

template <int ACT, bool BIAS>
int slots() {
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bias_act_kernel<ACT, BIAS>,
                                                    kThreads, 0) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

}  // namespace

extern "C" {

// Blocks of kThreads the card holds at once for an instance (act: 0 none,
// 1 QuickGELU, 2 GELU), or -1.
int mmrs_bias_act_slots(int act, int has_bias) {
  switch (act * 2 + (has_bias ? 1 : 0)) {
    case 0: return slots<kNone, false>();
    case 1: return slots<kNone, true>();
    case 2: return slots<kQuickGelu, false>();
    case 3: return slots<kQuickGelu, true>();
    case 4: return slots<kGelu, false>();
    case 5: return slots<kGelu, true>();
  }
  return -1;
}

// y f32 [m, n] (the GEMM's sums), bias f32 [n] or NULL, out bf16 [m, n],
// all on `device`, whose `stream` the launch takes. The caller
// (ops/dense_epilogue.py: _bias_act_cuda) checks: CUDA, contiguous,
// 16-byte aligned y and out, n % 8 == 0, m >= 1, and takes `blocks` from
// `bias_act_plan`, whose thread count is a multiple of n / 8 (checked
// here). A launch must go to the current device's stream: `device` is
// made current for the launch where it is not, and the caller's device
// is restored (as a PyTorch device guard does).
int mmrs_bias_act(const void* y, const void* bias, void* out, long long m, int n, int act,
                  int blocks, int device, void* stream) {
  if (n < 8 || n % 8 || m < 1 || blocks < 1 || act < 0 || act > 2 ||
      (static_cast<long long>(blocks) * kThreads) % (n / 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err == cudaSuccess && caller != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  switch (act * 2 + (bias != nullptr ? 1 : 0)) {
    case 0: rc = launch<kNone, false>(y, bias, out, m, n, blocks, s); break;
    case 1: rc = launch<kNone, true>(y, bias, out, m, n, blocks, s); break;
    case 2: rc = launch<kQuickGelu, false>(y, bias, out, m, n, blocks, s); break;
    case 3: rc = launch<kQuickGelu, true>(y, bias, out, m, n, blocks, s); break;
    case 4: rc = launch<kGelu, false>(y, bias, out, m, n, blocks, s); break;
    case 5: rc = launch<kGelu, true>(y, bias, out, m, n, blocks, s); break;
  }
  if (caller != device) cudaSetDevice(caller);
  return rc;
}

}  // extern "C"
