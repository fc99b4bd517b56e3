// What every gallery top-k scan shares (cosine_topk.cu: bf16; quant_topk.cu:
// int8 and int4): the chunk of gallery rows one scan block scores, the merge
// width, and the block-wide bitonic sort both passes use.
//
// A scan block writes the best k (score, row id) pairs of its 256-row chunk,
// sorted, as partials [Q, n_chunks, k]; `mmrs_topk_merge` (cosine_topk.cu)
// reduces them to one sorted list per query. The order is (score desc, row
// id asc): the tie rule of mmrs_tpu/ops/topk.py:_topk_merge (first argmax,
// earlier rows first); rows past N enter as (-inf, -1), its sentinel.
#pragma once

#include "common.cuh"

namespace mmrs {

constexpr int kChunk = 256;        // gallery rows per scan block
constexpr int kThreads = 256;      // 8 warps per block, scan and merge
constexpr int kMergeWidth = 1024;  // candidates sorted per merge block

// "a ranks before b": higher score first, equal scores by lower row id.
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Sorts independent segments of `len` entries (a power of two) best-first.
// The segments tile sv/si[0, total). Every thread of the block must call it.
__device__ inline void sort_segments(float* sv, int* si, int len, int total) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < total / 2; t += blockDim.x) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int l = i + stride;
        const bool up = ((i & (len - 1)) & size) == 0;
        const float a = sv[i], b = sv[l];
        const int ia = si[i], ib = si[l];
        const bool swap = up ? before(b, ib, a, ia) : before(a, ia, b, ib);
        if (swap) {
          sv[i] = b; sv[l] = a;
          si[i] = ib; si[l] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// The chunk's sorted candidates, QT segments of kChunk in shared memory,
// -> the best k of each valid query as partials [Q, n_chunks, k].
__device__ inline void write_partials(const float* sv, const int* si, int QT, int q0,
                                      int Q, int chunk, int n_chunks, int k,
                                      float* __restrict__ part_v, int* __restrict__ part_i) {
  for (int e = threadIdx.x; e < QT * k; e += blockDim.x) {
    const int qi = e / k, j = e - qi * k;
    if (q0 + qi < Q) {
      const size_t o = ((size_t)(q0 + qi) * n_chunks + chunk) * k + j;
      part_v[o] = sv[qi * kChunk + j];
      part_i[o] = si[qi * kChunk + j];
    }
  }
}

}  // namespace mmrs
