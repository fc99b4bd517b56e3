// IVF bucket probes for Hopper (sm_90a): K7 over bf16 or int8 bucket rows,
// K8 over packed int4 bucket rows.
//
// Replaces the Pallas TPU kernels mmrs_tpu/index/ivf.py:_probe_buckets_pallas
// (body `_ivf_kernel`) and _probe_buckets_pallas_q4 (body `_ivf_kernel_q4`).
// Each query q has its own probe list probe[q, 0..P) of cluster ids, best
// first. The query's candidates are the slots of those buckets: bucket slot
// s of its r-th probed cluster is "virtual row" r * cap + s of a virtual
// gallery of P * cap rows. Empty slots (id -1) score -inf.
//
//   K7 (`probe_scan_kernel`): bf16 query . bucket row, f32 sums; an int8
//      row widens exactly (as the JAX kernel casts it to bf16 before its
//      bf16 x bf16 -> f32 dot; the query is never quantized), and the sum
//      is multiplied by the slot's f32 scale.
//   K8 (`probe_scan_q4_kernel`): int8 query codes against the packed int4
//      rows of ops/quant4.py (row-major [C, cap, D/2]: low nibble dim j + 8,
//      high nibble dim D/2 + j), two exact __dp4a dots and `_score_f32`'s
//      epilogue with __fmul_rn/__fadd_rn in the reference's order, so the
//      scores are bit-identical to the plain version and the JAX package.
//
// The TPU kernel walks (query, probe) steps in order and folds each bucket
// into a running top-k in VMEM; CUDA blocks run in no order. The probes
// write each 256-slot chunk's best k, sorted, as partials [Q, n_parts, k]
// that `mmrs_topk_merge` (cosine_topk.cu) reduces. The id the partials
// carry is the VIRTUAL ROW, not the gallery id: the merge's (score desc,
// id asc) order is then the JAX probe's tie rule (equal scores: earlier
// probe rank, then earlier slot), with no change to topk_common.cuh.
// `probe_ids_kernel` maps the final rows to bucket_ids and -inf to -1.
//
// What bounds them on the H100: bytes, each probed bucket's live rows read
// once (at C = 1024, nprobe = 128, Q = 8, D = 512: ~0.7 GB of bf16 rows,
// ~0.2 ms at 3.35 TB/s), 1 multiply-add per byte pair and query.
//   K7 is bucket-major: queries come in tiles of 8, and a bucket that
//      several queries of a tile probe is read once for all of them. One
//      block per (probe entry of the tile, 256-slot chunk of its bucket)
//      keeps the chunk only if no earlier entry of the tile names the same
//      bucket (a scan of the tile's 8 x P probe ints; the others exit),
//      streams the chunk's live rows through a cp.async ring of row
//      slices (empty slots are never read; int8 rows staged raw), scores
//      them on mma.sync m16n8k16 (rows as M, the tile's queries as N,
//      bf16 -> f32), and keeps each probing query's best min(k, 256) by k
//      rounds of a warp arg-max (k <= 32, topk_common.cuh `warp_select`) or
//      a bitonic sort, written once
//      for every entry naming the bucket: list r * n_cc + c,
//      positions r * cap + slot, so a bucket listed twice in one query's
//      list still gives both virtual positions. An out-of-range cluster id
//      scores as empty slots and is never read.
//   K8 keeps the query-major grid (chunk of a query's virtual gallery,
//      query): a warp scores one row with 8-byte coalesced loads.

#include "attention_mma.cuh"
#include "topk_common.cuh"

#include <math.h>

namespace {

using mmrs::kChunk;
using mmrs::kThreads;

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Virtual row `pos` of `query` -> flat slot index (bucket * cap + slot), or
// -1 when pos is past the virtual gallery or the probe entry is out of range.
__device__ __forceinline__ long long slot_of(const int* __restrict__ probe, int query,
                                             int pos, int n, int P, int C, int cap) {
  if (pos >= n) return -1;
  const int rank = pos / cap;
  const int b = probe[(size_t)query * P + rank];
  if (b < 0 || b >= C) return -1;
  return (long long)b * cap + (pos - rank * cap);
}

// ---------------------------------------------------------------------------
// K7 geometry: a tile of kProbeQT queries (the mma's N); a bucket chunk's
// kChunk rows stream as slices of every row through a cp.async ring: bf16
// rows in 128-byte slices (64 elements) through 2 stages, int8 rows in
// 64-byte slices (64 elements) through 4 stages; three blocks an SM. A row's 16-byte pieces are swizzled so that eight rows'
// pieces fall in distinct banks.
constexpr int kProbeQT = 8;
template <bool INT8> __host__ __device__ constexpr int probe_slice() { return INT8 ? 64 : 128; }
template <bool INT8> __host__ __device__ constexpr int probe_stages() { return INT8 ? 4 : 2; }
template <bool INT8> __host__ __device__ constexpr int probe_ring() {
  return probe_stages<INT8>() * kChunk * probe_slice<INT8>();
}

// byte offset of 16-byte piece c of row r in a stage of SLICE-byte rows
template <int SLICE>
__device__ __forceinline__ int piece(int r, int c) {
  return r * SLICE + ((SLICE == 128 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3))) << 4);
}

// K7, bucket-major. grid (nq * P entries of a query tile, ceil(cap / 256)
// chunks of a bucket, tiles of kProbeQT queries). The block of entry
// (qi, r) takes bucket b = probe[q0 + qi, r] only if no earlier entry of
// its tile (row-major) names b, so each distinct bucket of a tile is read
// once; it scores its chunk's rows against all kProbeQT queries on
// mma.sync m16n8k16 (rows as M, queries as N), and writes the chunk's best
// kc for every entry (qi', r') of the tile that names b, as the partial
// list r' * n_cc + chunk of query q0 + qi', carrying the virtual positions
// r' * cap + slot. INT8 = false: bf16 rows [C, cap, D]; true: int8 rows
// with scales [C, cap], widened exactly to bf16 in registers.
template <bool INT8>
__global__ void __launch_bounds__(kThreads, 3)
probe_scan_kernel(const uint16_t* __restrict__ q,      // [Q, D] bf16 bits
                  const int* __restrict__ probe,       // [Q, P]
                  const void* __restrict__ buckets,    // [C, cap, D]
                  const int* __restrict__ bucket_ids,  // [C, cap]
                  const float* __restrict__ scales,    // [C, cap] (INT8 only)
                  int Q, int P, int C, int cap, int D, int kc,
                  float* __restrict__ part_v,          // [Q, P * n_cc, kc]
                  int* __restrict__ part_i) {
  constexpr int ESZ = INT8 ? 1 : 2;
  constexpr int SLICE = probe_slice<INT8>(), NST = probe_stages<INT8>();
  constexpr int STAGE = kChunk * SLICE;
  constexpr int KSTEPS = SLICE / (16 * ESZ);         // k steps of 16 a slice
  const int DP = (D + 15) & ~15;                     // K padded to 16
  const int QLD = DP + 8;                            // query row stride
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                     // [NST][256][SLICE]
  uint16_t* qs = reinterpret_cast<uint16_t*>(ring + NST * STAGE);  // [8][QLD]
  int* ids = reinterpret_cast<int*>(qs + kProbeQT * QLD);         // [256]
  float* sv = reinterpret_cast<float*>(ring);                     // [8][256], after the scan
  int* si = reinterpret_cast<int*>(sv + kProbeQT * kChunk);
  __shared__ int s_mask;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e = blockIdx.x, chunk = blockIdx.y, n_cc = gridDim.y;
  const int q0 = blockIdx.z * kProbeQT, nq = min(kProbeQT, Q - q0);
  if (e >= nq * P) return;                  // the last tile's absent queries
  const int* tp = probe + (size_t)q0 * P;   // the tile's probe lists [nq][P]
  const int bkt = tp[e];
  // this thread's slot id of the chunk: -1 for an empty slot, a slot past
  // cap and an out-of-range cluster id (never read); loaded here, so that
  // its latency overlaps the ownership scan's
  const int s0 = chunk * kChunk;
  const bool valid = bkt >= 0 && bkt < C;
  const int my_id = valid && s0 + tid < cap ? bucket_ids[(size_t)bkt * cap + s0 + tid] : -1;

  // ownership, and which of the tile's queries probe bkt
  if (tid == 0) s_mask = 0;
  __syncthreads();
  bool dup = false;
  int mask = 0;
  for (int e2 = tid; e2 < nq * P; e2 += kThreads)
    if (tp[e2] == bkt) {
      dup |= e2 < e;
      mask |= 1 << (e2 / P);
    }
  mask = __reduce_or_sync(0xffffffffu, mask);
  if (lane == 0 && mask) atomicOr(&s_mask, mask);
  if (__syncthreads_or(dup)) return;
  const int qmask = s_mask;

  ids[tid] = my_id;
  // the query tile, zeros past nq rows and past D
  for (int x = tid; x < kProbeQT * (DP / 8); x += kThreads) {
    const int r = x / (DP / 8), c8 = (x - r * (DP / 8)) * 8;
    const bool ok = r < nq && c8 < D;
    mmrs::cp_async<16>(qs + r * QLD + c8, ok ? q + (size_t)(q0 + r) * D + c8 : q, ok);
  }
  mmrs::cp_async_commit();
  const bool any_live = __syncthreads_or(ids[tid] >= 0);

  const int m0 = warp * 32;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  if (any_live) {
    const int row_bytes = D * ESZ;
    const int nslice = (row_bytes + SLICE - 1) / SLICE;
    const unsigned char* base =
        static_cast<const unsigned char*>(buckets) + ((size_t)bkt * cap + s0) * row_bytes;
    // int8 rows with D % 16 == 8 are 8-byte aligned: 8-byte pieces
    const bool wide = row_bytes % 16 == 0;
    auto issue = [&](int sl) {
      if (sl < nslice) {
        unsigned char* dst = ring + (sl % NST) * STAGE;
        if (wide) {
          constexpr int PR = SLICE / 16;   // pieces a row
          for (int x = tid; x < kChunk * PR; x += kThreads) {
            const int r = x / PR, c = x % PR, byte = sl * SLICE + c * 16;
            const bool ok = ids[r] >= 0 && byte < row_bytes;
            mmrs::cp_async<16>(dst + piece<SLICE>(r, c),
                               ok ? base + (size_t)r * row_bytes + byte : base, ok);
          }
        } else {
          constexpr int PR = SLICE / 8;
          for (int x = tid; x < kChunk * PR; x += kThreads) {
            const int r = x / PR, c = x % PR, byte = sl * SLICE + c * 8;
            const bool ok = ids[r] >= 0 && byte < row_bytes;
            mmrs::cp_async<8>(dst + piece<SLICE>(r, c >> 1) + (c & 1) * 8,
                              ok ? base + (size_t)r * row_bytes + byte : base, ok);
          }
        }
      }
      mmrs::cp_async_commit();
    };
    const bool wlive = __any_sync(0xffffffffu, ids[m0 + lane] >= 0);
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < NST - 1; ++i) issue(i);
    for (int sl = 0; sl < nslice; ++sl) {
      issue(sl + NST - 1);
      mmrs::cp_async_wait<NST - 1>();
      __syncthreads();
      const unsigned char* st = ring + (sl % NST) * STAGE;
      if (wlive) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int k0 = sl * (SLICE / ESZ) + kk * 16;
          if (k0 >= DP) break;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qs + g * QLD + k0 + 2 * t);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qs + g * QLD + k0 + 2 * t + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t a[4];
            if constexpr (INT8) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = m0 + mt * 16 + g + (i & 1) * 8;
                const uint16_t w = *reinterpret_cast<const uint16_t*>(
                    st + piece<SLICE>(r, kk) + 2 * t + (i >> 1) * 8);
                a[i] = mmrs::s8x2_to_bf16x2(w);
              }
            } else {
              const int r = m0 + mt * 16 + (lane & 15);
              mmrs::ldmatrix_x4(a, st + piece<SLICE>(r, kk * 2 + (lane >> 4)));
            }
            mmrs::mma_bf16(acc[mt], a, b0, b1);
          }
        }
      }
      __syncthreads();
    }
    mmrs::cp_async_wait<0>();
    __syncthreads();   // the ring is free: the scores [8][256]
    // C fragment: acc[mt][2h + j] = (row m0 + 16 mt + g + 8h, query 2t + j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mt * 16 + g + 8 * h;
        const bool live = ids[r] >= 0;
        const float sc = INT8 && live ? scales[(size_t)bkt * cap + s0 + r] : 1.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = acc[mt][2 * h + j];
          if (INT8) x = __fmul_rn(x, sc);
          sv[(2 * t + j) * kChunk + r] = live ? x : -INFINITY;
        }
      }
  } else {
    mmrs::cp_async_wait<0>();
    for (int x = tid; x < kProbeQT * kChunk; x += kThreads) sv[x] = -INFINITY;
  }
  __syncthreads();

  // each probing query's best kc of the chunk, sorted, at sv/si[qi * 256 ..]
  if (!any_live) {   // every score -inf: the chunk's first kc slots
    for (int x = tid; x < kProbeQT * kChunk; x += kThreads) si[x] = x & (kChunk - 1);
  } else if (kc <= mmrs::kSelectMax) {
    if ((qmask >> warp) & 1)
      mmrs::warp_select(sv + warp * kChunk, nullptr, kChunk, kc, sv + warp * kChunk,
                        si + warp * kChunk, lane);
  } else {
    for (int x = tid; x < kProbeQT * kChunk; x += kThreads) si[x] = x & (kChunk - 1);
    __syncthreads();
    mmrs::sort_segments(sv, si, kChunk, kProbeQT * kChunk);
  }
  __syncthreads();

  // one partial list for every entry of the tile that names bkt
  const size_t n_parts = (size_t)P * n_cc;
  for (int e2 = tid; e2 < nq * P; e2 += kThreads) {
    if (tp[e2] != bkt) continue;
    const int qi = e2 / P, r = e2 - qi * P;
    const size_t o = (((size_t)(q0 + qi)) * n_parts + (size_t)r * n_cc + chunk) * kc;
    for (int j = 0; j < kc; ++j) {
      const int slot = s0 + si[qi * kChunk + j];
      part_v[o + j] = sv[qi * kChunk + j];
      part_i[o + j] = slot < cap ? r * cap + slot : -1;
    }
  }
}

// K8: packed int4 rows [C, cap, D/2], scales [C, cap].
__global__ void __launch_bounds__(kThreads)
probe_scan_q4_kernel(const int8_t* __restrict__ q,        // [Q, D] codes
                     const float* __restrict__ q_scale,   // [Q]
                     const float* __restrict__ q_rowsum,  // [Q] sum of codes [0, D/2)
                     const int* __restrict__ probe,       // [Q, P]
                     const uint8_t* __restrict__ buckets, // [C, cap, D/2]
                     const int* __restrict__ bucket_ids,  // [C, cap]
                     const float* __restrict__ scales,    // [C, cap]
                     int P, int C, int cap, int D, int k,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sv + kChunk);
  int* qs = si + kChunk;                                       // [D/4] code words

  const int query = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int n = P * cap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dw = D / 4, hw = D / 8;  // query words per row; words per half

  const int* q32 = reinterpret_cast<const int*>(q) + (size_t)query * dw;
  for (int e = threadIdx.x; e < dw; e += kThreads) qs[e] = q32[e];
  const float qsc = q_scale[query], qrs = q_rowsum[query];
  __syncthreads();

  for (int r = warp; r < kChunk; r += kThreads / 32) {
    const int pos = chunk * kChunk + r;
    const long long slot = slot_of(probe, query, pos, n, P, C, cap);
    const bool live = slot >= 0 && bucket_ids[slot] >= 0;  // warp-uniform
    int dlo = 0, dhi = 0;
    if (live) {
      const uint2* row = reinterpret_cast<const uint2*>(buckets + slot * (D / 2));
      for (int c = lane; c < D / 16; c += 32) {  // 8 packed bytes: dims 8c..8c+7 of each half
        const uint2 gv = row[c];
        const int2 ql = reinterpret_cast<const int2*>(qs)[c];
        const int2 qh = reinterpret_cast<const int2*>(qs + hw)[c];
        dlo = __dp4a(static_cast<int>(gv.y & 0x0F0F0F0Fu), ql.y,
                     __dp4a(static_cast<int>(gv.x & 0x0F0F0F0Fu), ql.x, dlo));
        dhi = __dp4a(static_cast<int>(gv.y & 0xF0F0F0F0u), qh.y,
                     __dp4a(static_cast<int>(gv.x & 0xF0F0F0F0u), qh.x, dhi));
      }
    }
    dlo = warp_sum_i(dlo);
    dhi = warp_sum_i(dhi);
    if (lane == 0) {
      float s = -INFINITY;
      if (live) {
        s = __fadd_rn(__fsub_rn(__int2float_rn(dlo), __fmul_rn(8.f, qrs)),
                      __fmul_rn(__int2float_rn(dhi), 0.0625f));
        s = __fmul_rn(__fmul_rn(s, qsc), scales[slot]);
      }
      sv[r] = s;
      si[r] = pos < n ? pos : -1;
    }
  }
  __syncthreads();
  mmrs::sort_segments(sv, si, kChunk, kChunk);
  mmrs::write_partials(sv, si, 1, query, query + 1, chunk, n_chunks, k, part_v, part_i);
}

// Final virtual rows -> global ids; -inf (empty slot, short list) -> -1.
__global__ void probe_ids_kernel(const float* __restrict__ vals,   // [Q, k]
                                 const int* __restrict__ pos,      // [Q, k]
                                 const int* __restrict__ probe,    // [Q, P]
                                 const int* __restrict__ bucket_ids,
                                 int Q, int P, int C, int cap, int k,
                                 int* __restrict__ out) {         // [Q, k]
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Q * k) return;
  const int p = pos[e];
  int id = -1;
  if (vals[e] != -INFINITY && p >= 0) {
    const long long slot = slot_of(probe, e / k, p, P * cap, P, C, cap);
    if (slot >= 0) id = bucket_ids[slot];
  }
  out[e] = id;
}

dim3 scan_grid(int Q, int n) { return dim3((n + kChunk - 1) / kChunk, Q); }

}  // namespace

extern "C" {

// K7 scan pass: partials [Q, P * ceil(cap / 256), k] (list r * n_cc + c of
// a query: chunk c of its r-th probed bucket) for `mmrs_topk_merge`. The
// caller (mmrs_tpu_torch/index/ivf.py) checks: CUDA, contiguous, 16-byte
// aligned, dtypes, D % 8 == 0, D <= 2048, 1 <= k <= 256 (the partial list
// length, min(k, 256) of the call), 1 <= Q <= 65535, P * cap < 2^31;
// `scales` is null unless int8 != 0.
int mmrs_probe_scan(const void* q, const void* probe, const void* buckets,
                    const void* bucket_ids, const void* scales, int int8, int Q, int P,
                    int C, int cap, int D, int k, void* part_v, void* part_i,
                    void* stream) {
  static_assert(kThreads == kChunk, "a thread a chunk row");
  if (D % 8 || D > 2048 || k < 1 || k > kChunk || P < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (D + 15) & ~15;
  const int smem = (int8 ? probe_ring<true>() : probe_ring<false>()) +
                   kProbeQT * (dp + 8) * 2 + kChunk * 4;
  const dim3 grid(min(Q, kProbeQT) * P, (cap + kChunk - 1) / kChunk,
                  (Q + kProbeQT - 1) / kProbeQT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* qb = static_cast<const uint16_t*>(q);
  const int* pr = static_cast<const int*>(probe);
  const int* ids = static_cast<const int*>(bucket_ids);
  const float* sc = static_cast<const float*>(scales);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  auto kern = int8 ? probe_scan_kernel<true> : probe_scan_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, s>>>(qb, pr, buckets, ids, sc, Q, P, C, cap, D, k, pv, pi);
  return static_cast<int>(cudaGetLastError());
}

// K8 scan pass; the caller checks as above, with D % 16 == 0.
int mmrs_probe_scan_q4(const void* q, const void* q_scale, const void* q_rowsum,
                       const void* probe, const void* buckets, const void* bucket_ids,
                       const void* scales, int Q, int P, int C, int cap, int D, int k,
                       void* part_v, void* part_i, void* stream) {
  const size_t smem = (size_t)kChunk * (sizeof(float) + sizeof(int)) + (size_t)D;
  probe_scan_q4_kernel<<<scan_grid(Q, P * cap), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(q_scale),
      static_cast<const float*>(q_rowsum), static_cast<const int*>(probe),
      static_cast<const uint8_t*>(buckets), static_cast<const int*>(bucket_ids),
      static_cast<const float*>(scales), P, C, cap, D, k, static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

// Merged top-k virtual rows [Q, k] -> global ids [Q, k].
int mmrs_probe_ids(const void* vals, const void* pos, const void* probe,
                   const void* bucket_ids, int Q, int P, int C, int cap, int k, void* out,
                   void* stream) {
  const int total = Q * k;
  probe_ids_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(pos),
      static_cast<const int*>(probe), static_cast<const int*>(bucket_ids), Q, P, C, cap, k,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
