// IVF bucket probes for Hopper (sm_90a): K7 over bf16 or int8 bucket rows,
// K8 over packed int4 bucket rows; one kernel template over the row kind.
//
// Replaces the Pallas TPU kernels mmrs_tpu/index/ivf.py:_probe_buckets_pallas
// (body `_ivf_kernel`) and _probe_buckets_pallas_q4 (body `_ivf_kernel_q4`).
// Each query q has its own probe list probe[q, 0..P) of cluster ids, best
// first. The query's candidates are the slots of those buckets: bucket slot
// s of its r-th probed cluster is "virtual row" r * cap + s of a virtual
// gallery of P * cap rows. Empty slots (id -1) score -inf.
//
//   K7 (bf16 / int8 rows): bf16 query . bucket row, f32 sums; an int8 row
//      widens exactly (as the JAX kernel casts it to bf16 before its
//      bf16 x bf16 -> f32 dot; the query is never quantized), and the sum
//      is multiplied by the slot's f32 scale.
//   K8 (packed int4 rows): int8 query codes against the packed int4 rows of
//      ops/quant4.py (row-major [C, cap, D/2]: low nibble dim j + 8, high
//      nibble dim D/2 + j), exact int32 sums and `_score_f32`'s epilogue
//      with __fmul_rn/__fadd_rn in the reference's order (topk_common.cuh
//      `score_q4`), so the scores are bit-identical to the plain version
//      and the JAX package.
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
// ~0.2 ms at 3.35 TB/s; int4 rows a quarter of that), 1 multiply-add per
// element and query. Both are bucket-major: queries come in tiles of 8,
// and a bucket that several queries of a tile probe is read once for all
// of them. One block per (probe entry of the tile, 256-slot chunk of its
// bucket) keeps the chunk only if no earlier entry of the tile names the
// same bucket (a scan of the tile's 8 x P probe ints; the others exit),
// streams the chunk's live rows through a cp.async ring of row slices
// (empty slots are never read; int8 and int4 rows staged raw), scores them
// on tensor cores with rows as M and the tile's queries as N:
//   K7: mma.sync m16n8k16 bf16 -> f32, int8 rows widened in registers;
//   K8: the packed bytes are the A fragment of mma.sync m16n8k32 s8 twice,
//       masked into their two nibble planes (attention_mma.cuh
//       `nibble_planes`, as the flat int4 scan K5 does) against the tile's
//       query codes of [0, D/2) and [D/2, D);
// keeps each probing query's best min(k, 256) by k rounds of a warp
// arg-max (k <= 32, topk_common.cuh `warp_select`) or a bitonic sort, and
// writes it once for every entry naming the bucket: list r * n_cc + c,
// positions r * cap + slot, so a bucket listed twice in one query's list
// still gives both virtual positions. An out-of-range cluster id scores as
// empty slots and is never read.

#include "attention_mma.cuh"
#include "topk_common.cuh"

#include <math.h>

namespace {

using mmrs::kChunk;
using mmrs::kRowBf16;
using mmrs::kRowS4;
using mmrs::kRowS8;
using mmrs::kThreads;

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
// Geometry: a tile of kProbeQT queries (the mma's N); a bucket chunk's
// kChunk rows stream as slices of every row through a cp.async ring: bf16
// rows in 128-byte slices (64 elements) through 2 stages, int8 rows in
// 64-byte slices (64 elements) through 4 stages, packed int4 rows in
// 128-byte slices (256 dims) through 2 stages; three blocks an SM (two for
// int4 rows past D = 1024). A row's 16-byte pieces are swizzled so that
// eight rows' pieces fall in distinct banks.
constexpr int kProbeQT = 8;
template <int KIND> __host__ __device__ constexpr int probe_slice() {
  return KIND == kRowS8 ? 64 : 128;
}
template <int KIND> __host__ __device__ constexpr int probe_stages() {
  return KIND == kRowS8 ? 4 : 2;
}
template <int KIND> __host__ __device__ constexpr int probe_ring() {
  return probe_stages<KIND>() * kChunk * probe_slice<KIND>();
}
template <int KIND> __host__ __device__ constexpr int probe_row_bytes(int D) {
  return KIND == kRowS4 ? D / 2 : KIND == kRowS8 ? D : 2 * D;
}
// k steps of the s8 mma (32 packed bytes) an int4 row, and the stride in
// bytes of a staged plane row of query codes (padded so that the 8 rows'
// B fragment words fall in distinct banks)
__host__ __device__ constexpr int probe_ksteps_q4(int D) { return (D / 2 + 31) / 32; }
__host__ __device__ constexpr int probe_qld_q4(int D) { return 32 * probe_ksteps_q4(D) + 16; }
// bytes of the staged query tile: bf16 [8][DP + 8], DP = D padded to 16;
// int4 rows: the codes of each half, [2][8][probe_qld_q4]
template <int KIND> __host__ __device__ constexpr int probe_qbytes(int D) {
  return KIND == kRowS4 ? 2 * kProbeQT * probe_qld_q4(D) : kProbeQT * (((D + 15) & ~15) + 8) * 2;
}
// dynamic shared memory: the ring, the query tile, the chunk's slot ids
template <int KIND> __host__ __device__ constexpr int probe_smem(int D) {
  return probe_ring<KIND>() + probe_qbytes<KIND>(D) + kChunk * 4;
}

// byte offset of 16-byte piece c of row r in a stage of SLICE-byte rows
template <int SLICE>
__device__ __forceinline__ int piece(int r, int c) {
  return r * SLICE + ((SLICE == 128 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3))) << 4);
}

// K7 and K8, bucket-major. grid (nq * P entries of a query tile,
// ceil(cap / 256) chunks of a bucket, tiles of kProbeQT queries). The block
// of entry (qi, r) takes bucket b = probe[q0 + qi, r] only if no earlier
// entry of its tile (row-major) names b, so each distinct bucket of a tile
// is read once; it scores its chunk's rows against all kProbeQT queries,
// and writes the chunk's best kc for every entry (qi', r') of the tile that
// names b, as the partial list r' * n_cc + chunk of query q0 + qi',
// carrying the virtual positions r' * cap + slot.
//   kRowBf16: q bf16 [Q, D], rows bf16 [C, cap, D]; no scales.
//   kRowS8:   q bf16 [Q, D], rows int8 [C, cap, D] with scales [C, cap],
//             widened exactly to bf16 in registers.
//   kRowS4:   q int8 codes [Q, D] with q_scale and q_rowsum [Q] (the low
//             half's code sum), rows packed [C, cap, D/2] with scales.
template <int KIND>
__global__ void __launch_bounds__(kThreads, 3)
probe_scan_kernel(const void* __restrict__ q,          // [Q, D]
                  const float* __restrict__ q_scale,   // [Q] (int4 rows only)
                  const float* __restrict__ q_rowsum,  // [Q] (int4 rows only)
                  const int* __restrict__ probe,       // [Q, P]
                  const void* __restrict__ buckets,    // [C, cap, row bytes]
                  const int* __restrict__ bucket_ids,  // [C, cap]
                  const float* __restrict__ scales,    // [C, cap] (int8, int4)
                  int Q, int P, int C, int cap, int D, int kc,
                  float* __restrict__ part_v,          // [Q, P * n_cc, kc]
                  int* __restrict__ part_i) {
  constexpr int SLICE = probe_slice<KIND>(), NST = probe_stages<KIND>();
  constexpr int STAGE = kChunk * SLICE;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                   // [NST][256][SLICE]
  unsigned char* qs = ring + NST * STAGE;                       // the query tile
  int* ids = reinterpret_cast<int*>(qs + probe_qbytes<KIND>(D));  // [256]
  float* sv = reinterpret_cast<float*>(ring);                   // [8][256], after the scan
  int* si = reinterpret_cast<int*>(sv + kProbeQT * kChunk);
  __shared__ int s_mask;
  __shared__ float qsc[kProbeQT], qrs[kProbeQT];                // int4 rows

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
  // the query tile, zeros past nq rows and past D (int4 rows: each code
  // plane past D/2)
  const int DP = (D + 15) & ~15;                     // bf16 queries: K padded to 16
  const int QLD = DP + 8;                            // bf16 query row stride
  const int QLB = probe_qld_q4(D);                   // int4 rows: plane row stride
  if constexpr (KIND == kRowS4) {
    const int8_t* qc = static_cast<const int8_t*>(q);
    const int half = D / 2, words = QLB / 8;
    for (int x = tid; x < 2 * kProbeQT * words; x += kThreads) {
      const int pl = x / (kProbeQT * words), rem = x - pl * kProbeQT * words;
      const int r = rem / words, w = rem - r * words;
      const bool ok = r < nq && 8 * w < half;
      mmrs::cp_async<8>(qs + (pl * kProbeQT + r) * QLB + 8 * w,
                        ok ? qc + (size_t)(q0 + r) * D + pl * half + 8 * w : qc, ok);
    }
    if (tid < kProbeQT) {
      qsc[tid] = tid < nq ? q_scale[q0 + tid] : 0.f;
      qrs[tid] = tid < nq ? q_rowsum[q0 + tid] : 0.f;
    }
  } else {
    const uint16_t* qb = static_cast<const uint16_t*>(q);
    uint16_t* qh = reinterpret_cast<uint16_t*>(qs);
    for (int x = tid; x < kProbeQT * (DP / 8); x += kThreads) {
      const int r = x / (DP / 8), c8 = (x - r * (DP / 8)) * 8;
      const bool ok = r < nq && c8 < D;
      mmrs::cp_async<16>(qh + r * QLD + c8, ok ? qb + (size_t)(q0 + r) * D + c8 : qb, ok);
    }
  }
  mmrs::cp_async_commit();
  const bool any_live = __syncthreads_or(ids[tid] >= 0);

  const int m0 = warp * 32;
  const int g = lane >> 2, t = lane & 3;
  // C fragments: (mt, 2h + j) = (row m0 + 16 mt + g + 8h, query 2t + j)
  float acc[2][4] = {};             // K7
  int dlo[2][4] = {}, dhi[2][4] = {};   // K8
  if (any_live) {
    const int row_bytes = probe_row_bytes<KIND>(D);
    const int nslice = (row_bytes + SLICE - 1) / SLICE;
    const unsigned char* base =
        static_cast<const unsigned char*>(buckets) + ((size_t)bkt * cap + s0) * row_bytes;
    // rows of 8 (mod 16) bytes (int8 rows of D % 16 == 8, int4 rows of
    // D % 32 == 16) are 8-byte aligned: 8-byte pieces
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
    for (int i = 0; i < NST - 1; ++i) issue(i);
    for (int sl = 0; sl < nslice; ++sl) {
      issue(sl + NST - 1);
      mmrs::cp_async_wait<NST - 1>();
      __syncthreads();
      const unsigned char* st = ring + (sl % NST) * STAGE;
      if (wlive) {
        if constexpr (KIND == kRowS4) {
#pragma unroll
          for (int kk = 0; kk < SLICE / 32; ++kk) {
            const int ks = sl * (SLICE / 32) + kk;
            if (ks >= probe_ksteps_q4(D)) break;
            const unsigned char* ql = qs + g * QLB + ks * 32 + 4 * t;
            const unsigned char* qh = ql + kProbeQT * QLB;
            const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(ql);
            const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(ql + 16);
            const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(qh);
            const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(qh + 16);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              uint32_t a[4], lo[4], hi[4];
              mmrs::ldmatrix_x4(a, st + piece<SLICE>(m0 + mt * 16 + (lane & 15),
                                                     kk * 2 + (lane >> 4)));
              mmrs::nibble_planes(a, lo, hi);
              mmrs::mma_s8(dlo[mt], lo, bl0, bl1);
              mmrs::mma_s8(dhi[mt], hi, bh0, bh1);
            }
          }
        } else {
          constexpr int ESZ = KIND == kRowS8 ? 1 : 2;
          const uint16_t* qh = reinterpret_cast<const uint16_t*>(qs);
#pragma unroll
          for (int kk = 0; kk < SLICE / (16 * ESZ); ++kk) {
            const int k0 = sl * (SLICE / ESZ) + kk * 16;
            if (k0 >= DP) break;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(qh + g * QLD + k0 + 2 * t);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(qh + g * QLD + k0 + 2 * t + 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              uint32_t a[4];
              if constexpr (KIND == kRowS8) {
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
      }
      __syncthreads();
    }
    mmrs::cp_async_wait<0>();
    __syncthreads();   // the ring is free: the scores [8][256]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + mt * 16 + g + 8 * h;
        const bool live = ids[r] >= 0;
        const float sc = KIND != kRowBf16 && live ? scales[(size_t)bkt * cap + s0 + r] : 1.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = 2 * t + j;
          float x;
          if constexpr (KIND == kRowS4)
            x = mmrs::score_q4(dlo[mt][2 * h + j], dhi[mt][2 * h + j], qrs[qi], qsc[qi], sc);
          else if constexpr (KIND == kRowS8)
            x = __fmul_rn(acc[mt][2 * h + j], sc);
          else
            x = acc[mt][2 * h + j];
          sv[qi * kChunk + r] = live ? x : -INFINITY;
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

// One launch of probe_scan_kernel<KIND>: partials [Q, P * ceil(cap / 256),
// k]. Checks the kernel's own limits; the callers check the rest.
template <int KIND>
int launch_probe(const void* q, const void* q_scale, const void* q_rowsum, const void* probe,
                 const void* buckets, const void* bucket_ids, const void* scales, int Q, int P,
                 int C, int cap, int D, int k, void* part_v, void* part_i, void* stream) {
  static_assert(kThreads == kChunk, "a thread a chunk row");
  if (D % 8 || (KIND == kRowS4 && D % 16) || D > 2048 || k < 1 || k > kChunk || P < 1 ||
      cap < 1 || Q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = probe_smem<KIND>(D);
  const dim3 grid(min(Q, kProbeQT) * P, (cap + kChunk - 1) / kChunk,
                  (Q + kProbeQT - 1) / kProbeQT);
  auto kern = probe_scan_kernel<KIND>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<const float*>(q_scale), static_cast<const float*>(q_rowsum),
      static_cast<const int*>(probe), buckets, static_cast<const int*>(bucket_ids),
      static_cast<const float*>(scales), Q, P, C, cap, D, k, static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
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
  auto launch = int8 ? launch_probe<kRowS8> : launch_probe<kRowBf16>;
  return launch(q, nullptr, nullptr, probe, buckets, bucket_ids, scales, Q, P, C, cap, D, k,
                part_v, part_i, stream);
}

// K8 scan pass: as above, for int8 query codes with their f32 scales and
// low-half rowsums over packed int4 rows [C, cap, D/2] with scales; the
// caller checks as above, with D % 16 == 0.
int mmrs_probe_scan_q4(const void* q, const void* q_scale, const void* q_rowsum,
                       const void* probe, const void* buckets, const void* bucket_ids,
                       const void* scales, int Q, int P, int C, int cap, int D, int k,
                       void* part_v, void* part_i, void* stream) {
  return launch_probe<kRowS4>(q, q_scale, q_rowsum, probe, buckets, bucket_ids, scales, Q, P,
                              C, cap, D, k, part_v, part_i, stream);
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
