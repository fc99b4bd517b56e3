// Gallery top-k scans over int8 and int4 galleries, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels mmrs_tpu/ops/quant.py:_topk_quant_pallas
// (body `_kernel_q8`) and mmrs_tpu/ops/quant4.py:_topk_int4_pallas (body
// `_kernel_q4`). Queries are int8 codes [Q, D] with f32 row scales; the
// gallery is int8 rows [N, D] or packed int4 rows [N, D/2] (uint8), with
// f32 row scales. Dot products are exact int32 sums; the f32 epilogue is the
// reference's, operation by operation and with no contraction into FMAs, so
// the scores are bit-identical to the plain PyTorch versions
// (mmrs_tpu_torch/ops/quant.py, quant4.py) and to the JAX package's:
//   int8: (float)acc * q_scale * row_scale
//   int4: ((float)dlo - 8 * rs_q + (float)dhi / 16) * q_scale * row_scale
// (`_score_f32`: dlo is the low half's dot with codes offset by 8, rs_q the
// rowsum of the query's low half, dhi the high half's dot with 16x codes).
//
// The int4 layout is the port's own, row-major: byte j of a row holds dim j
// offset by 8 in its low nibble and dim D/2 + j (signed) in its high nibble.
// A 32-bit word w of a row gives four low-half dims as `w & 0x0F0F0F0F` and
// four high-half dims as `w & 0xF0F0F0F0` read as signed bytes (16x the
// code): exact s8 operands against the query codes of each half. The JAX
// package stores the same nibbles transposed as [D/8, N] words, a TPU
// sublane artefact.
//
// What bounds them on the H100: bytes. At Q <= 64 a query does at most 64
// multiply-adds per gallery byte, far below the card's int8 ridge, so the
// floor is one read of the gallery: 512 MiB (int8) or 256 MiB (int4) at
// N=2^20, D=512, i.e. 0.16 / 0.08 ms at 3.35 TB/s.
//   int8 (`topk_scan_q8_kernel`): the structure of the first bf16 scan: one
//     block per (chunk of 256 rows, tile of <= 8 queries), query tiles of
//     one chunk adjacent in launch order so the chunk comes from DRAM once;
//     a warp scores one row for all the tile's queries with 16-byte
//     coalesced loads and __dp4a on CUDA cores; the chunk's scores are
//     sorted in shared memory and the best k written as partials that
//     `mmrs_topk_merge` reduces. Tensor cores (mma.sync s8) are later work.
//   int4: span_scan.cuh, shared with the bf16 scan: the packed bytes are
//     the A fragment of mma.sync m16n8k32 s8 (low and high nibbles by
//     masking, as above), spans of rows through a cp.async ring, and a
//     running threshold with a warp arg-max in place of the chunk sort.

#include "span_scan.cuh"
#include "topk_common.cuh"

#include <math.h>

namespace {

using mmrs::kChunk;
using mmrs::kThreads;

// Stages the tile's query codes (as 32-bit words) and scales; rows past Q
// read as zeros and are never written.
template <int QT>
__device__ __forceinline__ void stage_queries(const int8_t* __restrict__ q,
                                              const float* __restrict__ q_scale, int Q,
                                              int D, int q0, int* qs, float* qsc) {
  const int dw = D / 4;
  const int* q32 = reinterpret_cast<const int*>(q);
  for (int e = threadIdx.x; e < QT * dw; e += kThreads) {
    const int qi = e / dw;
    qs[e] = (q0 + qi < Q) ? q32[(size_t)(q0 + qi) * dw + (e - qi * dw)] : 0;
  }
  if (threadIdx.x < QT)
    qsc[threadIdx.x] = q0 + threadIdx.x < Q ? q_scale[q0 + threadIdx.x] : 0.f;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int QT>
__global__ void __launch_bounds__(kThreads)
topk_scan_q8_kernel(const int8_t* __restrict__ q,        // [Q, D] codes
                    const float* __restrict__ q_scale,   // [Q]
                    const int8_t* __restrict__ g,        // [N, D] codes
                    const float* __restrict__ g_scale,   // [N]
                    int Q, int N, int D, int k, int n_qtiles,
                    float* __restrict__ part_v,          // [Q, n_chunks, k]
                    int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);                     // [QT][kChunk]
  int* si = reinterpret_cast<int*>(sv + QT * kChunk);             // [QT][kChunk]
  int* qs = si + QT * kChunk;                                     // [QT][D/4]
  __shared__ float qsc[QT];

  const int n_chunks = gridDim.x / n_qtiles;
  const int chunk = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * QT;
  const int row0 = chunk * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dw = D / 4;

  stage_queries<QT>(q, q_scale, Q, D, q0, qs, qsc);
  __syncthreads();

  for (int r = warp; r < kChunk; r += kThreads / 32) {
    const int row = row0 + r;
    int acc[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) acc[qi] = 0;
    if (row < N) {  // warp-uniform
      const int4* grow = reinterpret_cast<const int4*>(g + (size_t)row * D);
      for (int c = lane; c < D / 16; c += 32) {
        const int4 gv = grow[c];
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          const int4 qv = reinterpret_cast<const int4*>(qs + qi * dw)[c];
          int a = acc[qi];
          a = __dp4a(gv.x, qv.x, a);
          a = __dp4a(gv.y, qv.y, a);
          a = __dp4a(gv.z, qv.z, a);
          a = __dp4a(gv.w, qv.w, a);
          acc[qi] = a;
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) acc[qi] = warp_sum(acc[qi]);
    if (lane == 0) {
      const float rs = row < N ? g_scale[row] : 0.f;
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        sv[qi * kChunk + r] =
            row < N ? __fmul_rn(__fmul_rn(__int2float_rn(acc[qi]), qsc[qi]), rs) : -INFINITY;
        si[qi * kChunk + r] = row < N ? row : -1;
      }
    }
  }
  __syncthreads();
  mmrs::sort_segments(sv, si, kChunk, QT * kChunk);
  mmrs::write_partials(sv, si, QT, q0, Q, chunk, n_chunks, k, part_v, part_i);
}

template <int QT>
void launch_q8(const void* q, const void* qsc, const void* g, const void* gsc, int Q,
               int N, int D, int k, void* part_v, void* part_i, cudaStream_t stream) {
  const int n_qtiles = (Q + QT - 1) / QT;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const size_t smem = (size_t)QT * kChunk * (sizeof(float) + sizeof(int)) + (size_t)QT * D;
  topk_scan_q8_kernel<QT><<<n_chunks * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qsc),
      static_cast<const int8_t*>(g), static_cast<const float*>(gsc), Q, N, D, k, n_qtiles,
      static_cast<float*>(part_v), static_cast<int*>(part_i));
}

}  // namespace

extern "C" {

// The int8 scan: partials [Q, ceil(N / 256), k] for `mmrs_topk_merge`. The
// callers (mmrs_tpu_torch/ops/quant.py, quant4.py) check: CUDA, contiguous,
// 16-byte aligned, dtypes, D % 16 == 0, D <= 2048, 1 <= k <= 256 (the
// partial list length, min(k, 256) of the call), 1 <= Q <= 65535, qt in
// {1, 2, 4, 8}.
int mmrs_topk_scan_q8(const void* q, const void* q_scale, const void* g, const void* g_scale,
                      int Q, int N, int D, int k, int qt, void* part_v, void* part_i,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qt) {
    case 1: launch_q8<1>(q, q_scale, g, g_scale, Q, N, D, k, part_v, part_i, s); break;
    case 2: launch_q8<2>(q, q_scale, g, g_scale, Q, N, D, k, part_v, part_i, s); break;
    case 4: launch_q8<4>(q, q_scale, g, g_scale, Q, N, D, k, part_v, part_i, s); break;
    case 8: launch_q8<8>(q, q_scale, g, g_scale, Q, N, D, k, part_v, part_i, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The int4 scan: partials [Q, ceil(N / span), k], span as for
// mmrs_topk_scan (a multiple of 256; 256 when k > kSelectMax).
int mmrs_topk_scan_q4(const void* q, const void* q_scale, const void* q_rowsum,
                      const void* g, const void* g_scale, int Q, int N, int D, int k, int span,
                      void* part_v, void* part_i, void* stream) {
  return launch_span_scan<true>(q, q_scale, q_rowsum, g, g_scale, Q, N, D, k, span, part_v,
                                part_i, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
