// Fused multi-head attention for short sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels mmrs_tpu/ops/attention.py:_mha_pallas
// (body `_mha_kernel`) and _mha_pallas_bd (`_mha_bd_kernel`, the same math
// laid out block-diagonally for the TPU's matrix unit). q, k, v and the
// output are [B, T, W] with heads as column slices of width hd = W / heads
// and 1/sqrt(hd) already folded into q; there is no mask. Logits and the
// softmax are f32, the probabilities are rounded to the input type before
// the AV product (as `_mha_kernel` casts p to v's dtype), AV accumulates in
// f32 and the output is rounded to the input type.
//
// What bounds it on the H100: at the vision towers' T (50 for B/32, 257 for
// L/14) attention is a few percent of a block's FLOPs and its cost in a
// generic implementation is the traffic of the [B, H, T, T] logits and of
// transposing q/k/v into a head-major layout. This kernel moves only the
// four [B, T, W] tensors: one block per (image, head, tile of query rows)
// reads its head's column slice straight from [B, T, W] (no transpose in
// device memory), keeps K and V of that head in shared memory, and keeps
// the tile's logits there too, so the [T, T] scores never reach device
// memory. The query-row tile bounds shared memory: a [257, 257] f32 logits
// block alone would be 264 KB, above the 227 KB a block may use.
// Plain FMA loops on CUDA cores; tensor cores (mma.sync / wgmma) are later
// work.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int Tn, int W, int hd, int tq) {
  extern __shared__ __align__(16) unsigned char smem[];
  // K rows are padded by one 32-bit word so that threads scoring
  // consecutive keys hit distinct shared-memory banks.
  const int kst = hd + 4 / (int)sizeof(T);
  float* S = reinterpret_cast<float*>(smem);          // [tq][Tn] logits, then probs
  float* Qs = S + tq * Tn;                            // [tq][hd]
  T* Ks = reinterpret_cast<T*>(Qs + tq * hd);         // [Tn][kst]
  T* Vs = Ks + Tn * kst;                              // [Tn][hd]

  const int q0 = blockIdx.x * tq;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(tq, Tn - q0);
  const size_t img = (size_t)b * Tn * W + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = kThreads / 32;

  for (int e = threadIdx.x; e < Tn * hd; e += kThreads) {
    const int j = e / hd, d = e - j * hd;
    Ks[j * kst + d] = k[img + (size_t)j * W + d];
    Vs[j * hd + d] = v[img + (size_t)j * W + d];
  }
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int i = e / hd, d = e - i * hd;
    Qs[i * hd + d] = mmrs::to_float(q[img + (size_t)(q0 + i) * W + d]);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < rows * Tn; e += kThreads) {
    const int i = e / Tn, j = e - i * Tn;
    const float* qi = Qs + i * hd;
    const T* kj = Ks + j * kst;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qi[d], mmrs::to_float(kj[d]), s);
    S[i * Tn + j] = s;
  }
  __syncthreads();

  for (int i = warp; i < rows; i += nwarps) {
    float* srow = S + i * Tn;
    float m = -INFINITY;
    for (int j = lane; j < Tn; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int j = lane; j < Tn; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < Tn; j += 32)
      srow[j] = mmrs::to_float(mmrs::from_float<T>(srow[j] / sum));
  }
  __syncthreads();

  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int i = e / hd, d = e - i * hd;
    const float* p = S + i * Tn;
    float acc = 0.f;
    for (int j = 0; j < Tn; ++j) acc = fmaf(p[j], mmrs::to_float(Vs[j * hd + d]), acc);
    out[img + (size_t)(q0 + i) * W + d] = mmrs::from_float<T>(acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Tn, int W,
           int heads, int tq, int smem, cudaStream_t stream) {
  const int hd = W / heads;
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + tq - 1) / tq, heads, B);
  mha_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tn, W, hd, tq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. The caller (mmrs_tpu_torch/ops/attention.py:
// _mha_cuda) picks the query tile `tq` and the shared-memory size with
// `mha_tile`, and checks: CUDA, contiguous, q/k/v of one [B, T, W] shape and
// one dtype, W % heads == 0, 1 <= B <= 65535, heads <= 65535.
int mmrs_mha_short_seq(const void* q, const void* k, const void* v, void* out, int B,
                       int Tn, int W, int heads, int dtype, int tq, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, out, B, Tn, W, heads, tq, smem, s);
  if (dtype == 1) return launch<float>(q, k, v, out, B, Tn, W, heads, tq, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
