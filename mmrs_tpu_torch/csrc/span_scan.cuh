// The flat gallery scans K1 (bf16 rows, cosine_topk.cu), K4 (int8 rows) and
// K5 (packed int4 rows, both quant_topk.cu) on tensor cores, sm_90a: one
// kernel template, `span_scan_kernel<KIND, stages>` over the row kind.
//
// A block takes a tile of kScanQT = 8 queries (the N side of the mma) and a
// span of `span` consecutive gallery rows (a multiple of 256), walked in
// 256-row chunks; the query tiles of one span are neighbours in the launch
// order, so a span comes from device memory once and from L2 for the other
// tiles. Rows stream through a cp.async ring in 128-byte row slices
// (16-byte pieces swizzled so that eight rows' pieces fall in distinct
// banks; past a row's end or the last row the pieces are zero-filled and
// nothing is read; K4's and K5's row scales ride with each chunk's first
// slice): 2 stages and two blocks an SM where they fit, so that one
// block's select overlaps the other's loads, else 5 stages
// (`scan_stages`). Each warp scores its 32 rows of a stage against the 8
// queries:
//   K1: mma.sync m16n8k16 bf16 -> f32, a fresh accumulator for each slice
//       (64 dims) added to the row's sum on the CUDA cores (the tensor
//       cores' f32 sums truncate; the slices keep that to 4 k steps);
//   K4: the int8 row bytes are the A fragment of mma.sync m16n8k32 s8
//       against the query codes, exact int32 sums, and the epilogue
//       `acc * q_scale * row_scale` of ops/quant.py operation by
//       operation (`score_q8`), so the scores are bit-identical to plain;
//   K5: the packed bytes are the A fragment of mma.sync m16n8k32 s8 twice:
//       `& 0x0F0F0F0F` gives the low nibbles (dims j, offset by 8) and
//       `& 0xF0F0F0F0` the high ones (dims D/2 + j, times 16), against the
//       query codes of [0, D/2) and [D/2, D) (ops/quant4.py's layout); the
//       exact int32 sums go through `_score_f32`'s epilogue operation by
//       operation (`score_q4`), so the scores are bit-identical to plain.
// The queries are staged once in shared memory, zero past D (and past Q).
//
// What a block keeps of its span (the select; kc = the partial list
// length):
//   kc <= kSelectMax: each query keeps its candidates in a 384-entry
//     buffer in shared memory, seeded with the best kc of the span's first
//     chunk (kc rounds of a warp arg-max, `warp_select`, by the query's
//     warp); its threshold is the kc-th best score kept so far. In each
//     later chunk every thread tests its scores against their queries'
//     thresholds in registers as the mma leaves them, and appends the few
//     above (a shared atomic for the place; ids break ties, so order in the
//     buffer does not matter); when a buffer might not take another chunk,
//     its warp keeps the best kc and raises the threshold. Thresholds move
//     only between chunks, and a later row equal to the threshold ranks
//     after the kept kc-th (same score, higher row id), so the test is
//     strict and ties cost no room. The span's best kc, sorted, is its
//     partial list.
//   kc > kSelectMax: spans of one chunk, whose 8 x 256 candidates are
//     sorted in shared memory (`sort_segments`), the best kc written.
// Partials are [Q, ceil(N / span), kc] in (score desc, row id asc) order,
// `_topk_merge`'s tie rule; a span short of kc rows pads with (-inf, -1).
// `mmrs_topk_merge` reduces them (ops/topk.py: scan_plan, span_rows).
#pragma once

#include "attention_mma.cuh"
#include "topk_common.cuh"

#include <math.h>

namespace {

constexpr int kScanQT = 8;                 // queries a block: the mma's N
constexpr int kScanSlice = 128;            // bytes of a row a ring stage holds
constexpr int kScanSmemLimit = 232448 - 1024;   // one block an SM, less the static part
constexpr int kScanSmemPair = 112 * 1024;       // two blocks an SM
constexpr int kScanStage = mmrs::kChunk * kScanSlice;
constexpr int kScanCap = 384;              // a query's select buffer (12 a lane)

using mmrs::kRowBf16;
using mmrs::kRowS4;
using mmrs::kRowS8;

// byte offset of 16-byte piece c of row r in a stage of 128-byte row slices
__device__ __forceinline__ int scan_piece(int r, int c) {
  return r * kScanSlice + ((c ^ (r & 7)) << 4);
}

// Bytes of a row; k steps of the mma (16 bf16 or 32 code bytes) a row;
// the query planes staged (int4: the codes of each half); the staged query
// row stride in bytes (padded so that the 8 rows' B fragment words fall in
// distinct banks).
template <int KIND> __host__ __device__ constexpr int scan_row_bytes(int D) {
  return KIND == kRowS4 ? D / 2 : KIND == kRowS8 ? D : 2 * D;
}
template <int KIND> __host__ __device__ constexpr int scan_ksteps(int D) {
  return KIND == kRowBf16 ? (D + 15) / 16 : (scan_row_bytes<KIND>(D) + 31) / 32;
}
template <int KIND> __host__ __device__ constexpr int scan_planes() {
  return KIND == kRowS4 ? 2 : 1;
}
template <int KIND> __host__ __device__ constexpr int scan_qld(int D) {
  return 32 * scan_ksteps<KIND>(D) + 16;
}

// dynamic shared memory: the ring of `stages` (int8 / int4: and a chunk's
// row scales a stage), the staged query planes, a chunk's scores [8][256],
// the select buffers [8][kScanCap] of scores and row ids
template <int KIND> __host__ __device__ constexpr int scan_smem(int D, int stages) {
  return stages * (kScanStage + (KIND != kRowBf16 ? mmrs::kChunk * 4 : 0)) +
         scan_planes<KIND>() * kScanQT * scan_qld<KIND>(D) +
         kScanQT * (mmrs::kChunk + 2 * kScanCap) * 4;
}
// The ring: 2 stages where two blocks then fit an SM (bf16 rows up to
// D = 1008, int8 up to 1760, int4 up to 1728), so that one block's select
// and its span's start and end overlap the other's loads; else 5 stages,
// one block an SM (224 KB at bf16 D = 2048; bf16 up to D = 2160, int8 up
// to 3680); else 3, where the staged query planes of a wide row leave room
// for no more (bf16 up to D = 6256, int8 up to 12128); 0: the query planes
// do not fit (ops/topk.py: span_stages refuses the same D).
template <int KIND> __host__ __device__ constexpr int scan_stages(int D) {
  return scan_smem<KIND>(D, 2) <= kScanSmemPair   ? 2
         : scan_smem<KIND>(D, 5) <= kScanSmemLimit ? 5
         : scan_smem<KIND>(D, 3) <= kScanSmemLimit ? 3
                                                   : 0;
}

// kRowBf16: q bf16 [Q, D], g bf16 [N, D]; q_scale, q_rowsum, g_scale null.
// kRowS8: q int8 codes [Q, D] with f32 scales, g int8 [N, D] with f32 row
// scales; q_rowsum null. kRowS4: q int8 codes [Q, D] with f32 scales and
// low-half rowsums, g packed [N, D/2] with f32 row scales.
template <int KIND, int NST>
__global__ void __launch_bounds__(mmrs::kThreads, NST == 2 ? 2 : 1)
span_scan_kernel(const void* __restrict__ q, const float* __restrict__ q_scale,
                 const float* __restrict__ q_rowsum, const unsigned char* __restrict__ g,
                 const float* __restrict__ g_scale, int Q, int N, int D, int kc, int span,
                 int n_qtiles, float* __restrict__ part_v, int* __restrict__ part_i) {
  using mmrs::kChunk;
  constexpr bool SCALED = KIND != kRowBf16;   // row scales (int8, int4)
  constexpr int PL = scan_planes<KIND>();
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                   // [NST][256][128]
  float* scl = reinterpret_cast<float*>(ring + NST * kScanStage);  // [NST][256] (SCALED)
  unsigned char* qs = reinterpret_cast<unsigned char*>(scl + (SCALED ? NST * kChunk : 0));
  const int QLD = scan_qld<KIND>(D);                            // qs: [PL][8][QLD]
  float* sv = reinterpret_cast<float*>(qs + PL * kScanQT * QLD);  // [8][256]
  float* cv = sv + kScanQT * kChunk;                            // [8][kScanCap]
  int* ci = reinterpret_cast<int*>(cv + kScanQT * kScanCap);    // [8][kScanCap]
  __shared__ float qsc[kScanQT], qrs[kScanQT];
  __shared__ float thr_s[kScanQT];   // each query's threshold (select route)
  __shared__ int cnt_s[kScanQT];     // and the candidates its buffer holds

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = blockIdx.x / n_qtiles, n_parts = gridDim.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kScanQT, nq = min(kScanQT, Q - q0);
  const int row0 = part * span, row_end = min(N, row0 + span);
  const int row_bytes = scan_row_bytes<KIND>(D), ksteps = scan_ksteps<KIND>(D);
  const int nslice = (row_bytes + kScanSlice - 1) / kScanSlice;
  const int nchunk = (row_end - row0 + kChunk - 1) / kChunk;
  const int total = nchunk * nslice;   // ring items: (chunk, slice)

  // the ring: item it = chunk * nslice + slice, stage it % NST; a chunk's
  // row scales (int8, int4) ride with its first slice
  const bool wide = row_bytes % 16 == 0;   // int4 rows of D % 32 == 16: 8-byte pieces
  auto issue = [&](int it) {
    if (it < total) {
      const int c = it / nslice, sl = it - c * nslice;
      unsigned char* dst = ring + (it % NST) * kScanStage;
      const int rbase = row0 + c * kChunk;
      if (wide) {
        for (int x = tid; x < kChunk * 8; x += mmrs::kThreads) {
          const int r = x >> 3, p = x & 7, byte = sl * kScanSlice + p * 16;
          const bool ok = rbase + r < row_end && byte < row_bytes;
          mmrs::cp_async<16>(dst + scan_piece(r, p),
                             ok ? g + (size_t)(rbase + r) * row_bytes + byte : g, ok);
        }
      } else {
        for (int x = tid; x < kChunk * 16; x += mmrs::kThreads) {
          const int r = x >> 4, p = x & 15, byte = sl * kScanSlice + p * 8;
          const bool ok = rbase + r < row_end && byte < row_bytes;
          mmrs::cp_async<8>(dst + scan_piece(r, p >> 1) + (p & 1) * 8,
                            ok ? g + (size_t)(rbase + r) * row_bytes + byte : g, ok);
        }
      }
      if (SCALED && sl == 0) {
        static_assert(mmrs::kThreads == kChunk, "a thread a chunk row");
        const bool ok = rbase + tid < row_end;
        mmrs::cp_async<4>(scl + (it % NST) * kChunk + tid, ok ? g_scale + rbase + tid : g_scale,
                          ok);
      }
    }
    mmrs::cp_async_commit();
  };
  for (int i = 0; i < NST - 1; ++i) issue(i);

  // the query tile, zero past nq rows and past D (int4: each plane past
  // D/2)
  if constexpr (SCALED) {
    const int8_t* qc = static_cast<const int8_t*>(q);
    const int width = D / PL, words = QLD / 8;
    for (int x = tid; x < PL * kScanQT * words; x += mmrs::kThreads) {
      const int pl = x / (kScanQT * words), rem = x - pl * kScanQT * words;
      const int r = rem / words, w = rem - r * words;
      uint2 v = make_uint2(0u, 0u);
      if (r < nq && 8 * w < width)
        v = *reinterpret_cast<const uint2*>(qc + (size_t)(q0 + r) * D + pl * width + 8 * w);
      *reinterpret_cast<uint2*>(qs + (pl * kScanQT + r) * QLD + 8 * w) = v;
    }
    if (tid < kScanQT) {
      qsc[tid] = tid < nq ? q_scale[q0 + tid] : 0.f;
      if (KIND == kRowS4) qrs[tid] = tid < nq ? q_rowsum[q0 + tid] : 0.f;
    }
  } else {
    const uint16_t* qb = static_cast<const uint16_t*>(q);
    const int pieces = QLD / 16;
    for (int x = tid; x < kScanQT * pieces; x += mmrs::kThreads) {
      const int r = x / pieces, c8 = (x - r * pieces) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nq && c8 < D) v = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * D + c8);
      *reinterpret_cast<uint4*>(qs + r * QLD + 2 * c8) = v;
    }
  }

  const bool select = kc <= mmrs::kSelectMax;
  float* bv = cv + warp * kScanCap;   // this warp's query's buffer (select route)
  int* bi = ci + warp * kScanCap;

  const int g8 = lane >> 2, t4 = lane & 3, m0 = warp * 32;
  int it = 0;
  for (int c = 0; c < nchunk; ++c) {
    const int rbase = row0 + c * kChunk;
    float gs[2][2];   // K4, K5: the scales of this thread's rows
    float tot[2][4] = {};   // K1
    int dlo[2][4] = {}, dhi[2][4] = {};   // K4 (dlo: the sums), K5
    for (int sl = 0; sl < nslice; ++sl, ++it) {
      issue(it + NST - 1);
      mmrs::cp_async_wait<NST - 1>();
      __syncthreads();
      const unsigned char* st = ring + (it % NST) * kScanStage;
      if constexpr (SCALED) {
        if (sl == 0) {
          const float* sc = scl + (it % NST) * kChunk + m0 + g8;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) gs[mt][h] = sc[mt * 16 + 8 * h];
        }
#pragma unroll
        for (int kk = 0; kk < kScanSlice / 32; ++kk) {
          const int ks = sl * (kScanSlice / 32) + kk;
          if (ks >= ksteps) break;
          const unsigned char* ql = qs + g8 * QLD + ks * 32 + 4 * t4;
          const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(ql);
          const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(ql + 16);
          uint32_t bh0 = 0, bh1 = 0;
          if constexpr (KIND == kRowS4) {
            const unsigned char* qh = ql + kScanQT * QLD;
            bh0 = *reinterpret_cast<const uint32_t*>(qh);
            bh1 = *reinterpret_cast<const uint32_t*>(qh + 16);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t a[4];
            mmrs::ldmatrix_x4(a, st + scan_piece(m0 + mt * 16 + (lane & 15), kk * 2 + (lane >> 4)));
            if constexpr (KIND == kRowS4) {
              uint32_t lo[4], hi[4];
              mmrs::nibble_planes(a, lo, hi);
              mmrs::mma_s8(dlo[mt], lo, bl0, bl1);
              mmrs::mma_s8(dhi[mt], hi, bh0, bh1);
            } else {
              mmrs::mma_s8(dlo[mt], a, bl0, bl1);
            }
          }
        }
      } else {
        float acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kScanSlice / 32; ++kk) {
          const int ks = sl * (kScanSlice / 32) + kk;
          if (ks >= ksteps) break;
          const unsigned char* qb = qs + g8 * QLD + ks * 32 + 4 * t4;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qb);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qb + 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t a[4];
            mmrs::ldmatrix_x4(a, st + scan_piece(m0 + mt * 16 + (lane & 15), kk * 2 + (lane >> 4)));
            mmrs::mma_bf16(acc[mt], a, b0, b1);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[mt][e] = __fadd_rn(tot[mt][e], acc[mt][e]);
      }
      __syncthreads();   // the stage may be refilled
    }

    // the chunk's scores: C fragment (mt, 2h + j) = (row m0 + 16 mt + g8 +
    // 8h, query 2 t4 + j). The sort route and a span's first chunk write
    // them to sv; later chunks append each score above its query's
    // threshold to the query's buffer (rare once the threshold has risen)
    const bool to_sv = !select || c == 0;
    float th[2] = {0.f, 0.f};
    if (!to_sv) {
      th[0] = thr_s[2 * t4];
      th[1] = thr_s[2 * t4 + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mt * 16 + g8 + 8 * h;
        const bool live = rbase + r < row_end;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = 2 * t4 + j;
          float s;
          if constexpr (KIND == kRowS4)
            s = mmrs::score_q4(dlo[mt][2 * h + j], dhi[mt][2 * h + j], qrs[qi], qsc[qi],
                               gs[mt][h]);
          else if constexpr (KIND == kRowS8)
            s = mmrs::score_q8(dlo[mt][2 * h + j], qsc[qi], gs[mt][h]);
          else
            s = tot[mt][2 * h + j];
          if (to_sv) {
            sv[qi * kChunk + r] = live ? s : -INFINITY;
            if (!select) ci[qi * kChunk + r] = live ? rbase + r : -1;
          } else if (live && qi < nq && s > th[j]) {
            const int pos = atomicAdd(&cnt_s[qi], 1);
            cv[qi * kScanCap + pos] = s;
            ci[qi * kScanCap + pos] = rbase + r;
          }
        }
      }
    __syncthreads();

    if (!select) {   // one chunk a span: sort its candidates, write the best kc
      mmrs::sort_segments(sv, ci, kChunk, kScanQT * kChunk);
      mmrs::write_partials(sv, ci, kScanQT, q0, Q, part, n_parts, kc, part_v, part_i);
      return;
    }
    if (warp < nq) {
      if (c == 0) {   // the first chunk's best kc seed the buffer and the threshold
        const int live = min(kChunk, row_end - rbase), m = min(kc, live);
        mmrs::warp_select(sv + warp * kChunk, nullptr, live, m, bv, bi, lane);
        __syncwarp();
        for (int e = lane; e < m; e += 32) bi[e] += rbase;   // chunk slots -> rows
        if (lane == 0) {
          cnt_s[warp] = m;
          thr_s[warp] = m == kc ? bv[kc - 1] : -INFINITY;
        }
      } else if (cnt_s[warp] > kScanCap - kChunk) {
        // the next chunk might not fit: keep the best kc, raise the threshold
        const int cnt = cnt_s[warp];
        mmrs::warp_select<kScanCap / 32>(bv, bi, cnt, kc, bv, bi, lane);
        __syncwarp();
        if (lane == 0) {
          cnt_s[warp] = kc;
          thr_s[warp] = bv[kc - 1];
        }
      }
      __syncwarp();
    }
    // the next chunk's first __syncthreads orders these writes before its
    // epilogue reads the thresholds and appends
  }

  // the span's best kc, sorted: partial list `part` of query q0 + warp
  if (warp < nq) {
    const int cnt = cnt_s[warp], m = min(kc, cnt);
    mmrs::warp_select<kScanCap / 32>(bv, bi, cnt, m, bv, bi, lane);
    __syncwarp();
    const size_t o = ((size_t)(q0 + warp) * n_parts + part) * kc;
    for (int j = lane; j < kc; j += 32) {
      part_v[o + j] = j < m ? bv[j] : -INFINITY;
      part_i[o + j] = j < m ? bi[j] : -1;
    }
  }
  mmrs::cp_async_wait<0>();
}

// Launch over [Q, ceil(N / span), kc] partials; checks the plan's rules.
template <int KIND>
int launch_span_scan(const void* q, const void* q_scale, const void* q_rowsum, const void* g,
                     const void* g_scale, int Q, int N, int D, int kc, int span, void* part_v,
                     void* part_i, cudaStream_t stream) {
  if (kc < 1 || kc > mmrs::kChunk || span < mmrs::kChunk || span % mmrs::kChunk ||
      (kc > mmrs::kSelectMax && span != mmrs::kChunk) || Q < 1 || N < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stages = scan_stages<KIND>(D);
  if (stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = scan_smem<KIND>(D, stages);
  auto kern = stages == 2   ? span_scan_kernel<KIND, 2>
              : stages == 5 ? span_scan_kernel<KIND, 5>
                            : span_scan_kernel<KIND, 3>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qtiles = (Q + kScanQT - 1) / kScanQT;
  const int n_parts = (N + span - 1) / span;
  if ((long long)n_parts * n_qtiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<n_parts * n_qtiles, mmrs::kThreads, smem, stream>>>(
      q, static_cast<const float*>(q_scale), static_cast<const float*>(q_rowsum),
      static_cast<const unsigned char*>(g), static_cast<const float*>(g_scale), Q, N, D, kc,
      span, n_qtiles, static_cast<float*>(part_v), static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
