// Tensor-core building blocks of the two-pass attention kernels
// (mha_short_seq.cu: K2; decode_attention.cu: K10), sm_90a, and the s8
// product of the int8 / int4 scans and probes (span_scan.cuh, ivf_probe.cu).
//
// Both kernels give each warp 16 query rows and walk the keys in tiles of
// kAttnKeys, staged in shared memory with cp.async (16 bytes a thread,
// zero-filled past the end) into a double-buffered ring. Scores come from
// mma.sync m16n8k16 bf16 -> f32 (exact products, f32 sums). The softmax is
// exact, not online: pass 1 keeps each row's running max m and sum l of
// exp(s - m) (rescaled when m grows), pass 2 recomputes the scores, forms
// p = exp(s - m) / l in f32, rounds it to bf16 once and feeds it, repacked
// from the score accumulators (the C fragment of one product is the A
// fragment of the next), to the P.V mma with f32 accumulators. So the
// probabilities are normalized before their one rounding, as in the
// reference kernels, and no [rows, S] score array exists anywhere. When the
// keys fit one tile, pass 2 reuses pass 1's scores (they are the same bits).
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//     a3 (g+8, 2t+8..);  B (16x8): b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16x8): c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mmrs {

constexpr int kAttnKeys = 64;   // keys per staged tile: 8 n tiles of 8

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The s8 product of the int8 / int4 gallery scans and probes (span_scan.cuh,
// ivf_probe.cu): m16n8k32, exact int32 sums. Fragments (g = lane / 4,
// t = lane % 4; bytes as k): A a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g,
// 16+4t..), a3 (g+8, 16+4t..), which ldmatrix_x4 of two 16-byte pieces of
// 16 rows gives; B b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment of packed int4 bytes (ops/quant4.py: byte j holds dim j
// offset by 8 in its low nibble, dim D/2 + j in its high one) -> its two
// s8 planes: `& 0x0F0F0F0F` the low nibbles (dims j, offset by 8), `&
// 0xF0F0F0F0` the high ones read as signed bytes (dims D/2 + j, times 16).
// Both are exact s8 operands against the query codes of each half.
__device__ __forceinline__ void nibble_planes(const uint32_t (&a)[4], uint32_t (&lo)[4],
                                              uint32_t (&hi)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = a[i] & 0x0F0F0F0Fu;
    hi[i] = a[i] & 0xF0F0F0F0u;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// cp.async of `bytes` (4, 8 or 16) of which the first `valid` are copied
// and the rest zero-filled (valid = 0: nothing is read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats -> one bf16x2 operand word, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(s - m) for the softmax; a masked score (-inf) is an exact zero even
// when every score so far is masked (m = -inf)
__device__ __forceinline__ float exp_shift(float s, float m) {
  return s == -INFINITY ? 0.f : expf(s - m);
}

// x / l, correctly rounded, from r = 1 / l (rounded to nearest): a
// product and one correction by its exact residual, the fast path of IEEE
// division with the reciprocal taken once per row instead of per element
__device__ __forceinline__ float div_by(float x, float l, float r) {
  const float q = __fmul_rn(x, r);
  return fmaf(fmaf(-q, l, x), r, q);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (16 rows x kAttnKeys) = Q K^T for one warp: qfrag(kk, a) gives the
// warp's Q fragment of k step kk, Ks is the key tile [kAttnKeys][LD]
// (bf16, keys as rows). Groups of 16 keys at or past `live` (warp-uniform)
// are skipped and score 0: the caller masks them.
template <int HDP, int LD, typename QFrag>
__device__ __forceinline__ void scores_tile_by(float (&s)[kAttnKeys / 8][4], QFrag&& qfrag,
                                               const __nv_bfloat16* Ks, int live, int lane) {
#pragma unroll
  for (int nt = 0; nt < kAttnKeys / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  // matrix i = lane / 8: keys +8 for i >= 2, columns +8 for odd i
  const __nv_bfloat16* base = Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t qa[4];
    qfrag(kk, qa);
#pragma unroll
    for (int np = 0; np < kAttnKeys / 16; ++np) {
      if (np * 16 >= live) break;
      uint32_t b[4];
      ldmatrix_x4(b, base + np * 16 * LD + kk * 16);
      mma_bf16(s[2 * np], qa, b[0], b[1]);
      mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
    }
  }
}

// As scores_tile_by, with the warp's Q fragments held in registers (qa).
template <int HDP, int LD>
__device__ __forceinline__ void scores_tile(float (&s)[kAttnKeys / 8][4],
                                            const uint32_t (&qa)[HDP / 16][4],
                                            const __nv_bfloat16* Ks, int live, int lane) {
  scores_tile_by<HDP, LD>(
      s,
      [&](int kk, uint32_t (&a)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
      },
      Ks, live, lane);
}

// The warp's 16 Q rows of a [rows][LD] tile -> A fragments.
template <int HDP, int LD>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[HDP / 16][4],
                                            const __nv_bfloat16* Qs, int warp, int lane) {
  const __nv_bfloat16* base = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) ldmatrix_x4(qa[kk], base + kk * 16);
}

// Pass 1 for one tile: fold the masked scores of rows g (e = 0, 1) and
// g + 8 (e = 2, 3) into the running max m[] and this thread's share of
// the sums l[] (the quad's shares are added after the last tile).
__device__ __forceinline__ void running_stats(const float (&s)[kAttnKeys / 8][4], float (&m)[2],
                                              float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kAttnKeys / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kAttnKeys / 8; ++nt)
      sum += exp_shift(s[nt][2 * h], mn) + exp_shift(s[nt][2 * h + 1], mn);
    l[h] = l[h] * exp_shift(m[h], mn) + sum;
    m[h] = mn;
  }
}

// Pass 2 for one tile: o += P V, P from the probabilities p[nt][e] (f32,
// already normalized and scaled, rounded here to bf16 once), V the value
// tile [kAttnKeys][LD] (keys as rows) read with ldmatrix.trans. Groups of
// 16 keys at or past `live` (all p = 0) are skipped.
template <int HDP, int LD>
__device__ __forceinline__ void pv_tile(float (&o)[HDP / 8][4], const float (&p)[kAttnKeys / 8][4],
                                        const __nv_bfloat16* Vs, int live, int lane) {
  // matrix i: keys +8 for odd i, columns +8 for i >= 2
  const __nv_bfloat16* base = Vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < kAttnKeys / 16; ++ks) {
    if (ks * 16 >= live) break;
    const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                           pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                           pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                           pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
    for (int np = 0; np < HDP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, base + ks * 16 * LD + np * 16);
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace mmrs
