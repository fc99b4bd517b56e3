// What every gallery top-k scan shares (cosine_topk.cu: bf16; quant_topk.cu:
// int8 and int4; ivf_probe.cu: the bucket probes): the chunk of gallery rows
// one scan block scores, the merge's largest shared-memory group, the
// block-wide bitonic sort of a chunk's candidates, the warp's arg-max
// select of a short list and the int8 / int4 score epilogues.
//
// A scan block writes the best kc = min(k, 256) (score, row id) pairs of its
// 256-row chunk (K1, K4 and K5 at kc <= kSelectMax: of a longer span, see
// span_scan.cuh), sorted, as partials [Q, n_parts, kc]; `mmrs_topk_merge`
// (cosine_topk.cu) reduces them to one sorted list of k per query. The
// order is (score desc, row id asc): the tie rule of
// mmrs_tpu/ops/topk.py:_topk_merge (first argmax, earlier rows first); rows
// past N enter as (-inf, -1), its sentinel.
#pragma once

#include "common.cuh"

#include <math.h>

namespace mmrs {

constexpr int kChunk = 256;        // gallery rows per scan block
constexpr int kThreads = 256;      // 8 warps per block, scan and merge
constexpr int kMaxSort = 8192;     // most candidates a merge block holds (64 KB)
constexpr int kSelectMax = 32;     // lists up to this long: warp arg-max rounds

// the gallery row kinds: bf16 (K1, K7), int8 codes (K4, K7) and packed int4
// codes (K5, K8)
enum RowKind : int { kRowBf16, kRowS8, kRowS4 };

// "a ranks before b": higher score first, equal scores by lower row id.
__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// The f32 epilogues of the int8 and int4 scores, operation by operation as
// the plain versions (no contraction into FMAs), so the scores are
// bit-identical to them and to the JAX package's:
//   int8 (ops/quant.py scores_q8): (float)acc * q_scale * row_scale;
//   int4 (ops/quant4.py `_score_f32`): ((float)dlo - 8 * rs_q + (float)dhi
//     / 16) * q_scale * row_scale, dlo the low half's dot with codes offset
//     by 8, rs_q the rowsum of the query's low half, dhi the high half's
//     dot with 16x codes.
__device__ __forceinline__ float score_q8(int acc, float q_scale, float row_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), q_scale), row_scale);
}
__device__ __forceinline__ float score_q4(int dlo, int dhi, float rs_q, float q_scale,
                                          float row_scale) {
  const float s = __fadd_rn(__fsub_rn(__int2float_rn(dlo), __fmul_rn(8.f, rs_q)),
                            __fmul_rn(__int2float_rn(dhi), 0.0625f));
  return __fmul_rn(__fmul_rn(s, q_scale), row_scale);
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
// -> the best k (<= kChunk) of each valid query as partials [Q, n_chunks, k].
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

// The best kc of one warp's cnt (<= 32 * PER) candidates vals[0..cnt), by
// (score desc, id asc), into out_v/out_i[0..kc), sorted: kc (<= cnt)
// rounds, each taking the best candidate not yet taken (each lane's best of
// its PER, then a butterfly over the lanes; the ids are distinct, so every
// lane agrees on the winner, and the lane that held it marks it taken).
// `ids` holds the candidates' ids, or is null when a candidate's id is its
// index. Every candidate is read before the first write, so the output may
// be the input. Lane 0 writes.
template <int PER = 8>
__device__ __forceinline__ void warp_select(const float* vals, const int* ids, int cnt, int kc,
                                            float* out_v, int* out_i, int lane) {
  static_assert(PER <= 32, "taken bits");
  float v[PER];
  int id[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int x = j * 32 + lane;
    v[j] = x < cnt ? vals[x] : -INFINITY;
    id[j] = x < cnt ? (ids ? ids[x] : x) : 0x7fffffff;
  }
  __syncwarp();
  uint32_t taken = 0;
  for (int n = 0; n < kc; ++n) {
    float bv = -INFINITY;
    int bs = 0x7fffffff;   // ranks after every candidate, -inf ones too
    int bj = -1;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (!((taken >> j) & 1u) && before(v[j], id[j], bv, bs)) {
        bv = v[j];
        bs = id[j];
        bj = j;
      }
    const int mine = bs;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int os = __shfl_xor_sync(0xffffffffu, bs, off);
      if (before(ov, os, bv, bs)) {
        bv = ov;
        bs = os;
      }
    }
    if (bj >= 0 && mine == bs) taken |= 1u << bj;
    if (lane == 0) {
      out_v[n] = bv;
      out_i[n] = bs;
    }
  }
}

}  // namespace mmrs
