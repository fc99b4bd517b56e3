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
// into a running top-k in VMEM; CUDA blocks run in no order. Here one block
// scores one 256-row chunk of one query's virtual gallery and writes its
// best k, sorted, as partials [Q, n_chunks, k] that `mmrs_topk_merge`
// (cosine_topk.cu) reduces. The id the partials carry is the VIRTUAL ROW,
// not the gallery id: the merge's (score desc, id asc) order is then the
// JAX probe's tie rule (equal scores: earlier probe rank, then earlier
// slot), with no change to topk_common.cuh. `probe_ids_kernel` maps the
// final rows to bucket_ids and -inf to -1.
//
// What bounds it on the H100: bytes. A query reads its P * cap rows once
// (at C = 1024, nprobe = 128, cap ~1.3k, D = 512: ~170 MB bf16 per query,
// ~50 us at 3.35 TB/s) and does 1 multiply-add per byte pair. Unlike the
// flat scans, queries do not share rows (their probe lists differ), so
// there is no query tile: grid (chunk, query). A warp scores one row with
// 16-byte (bf16) or 8-byte (int8 / int4) coalesced loads; an out-of-range
// cluster id in a probe list scores as empty slots and is never read.
// Tensor cores, TMA and a persistent grid are later work.

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

__device__ __forceinline__ float warp_sum_f(float v) {
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

// Eight signed bytes (memory order) -> eight floats, exact.
__device__ __forceinline__ void unpack8_i8(const uint2& v, float* f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = static_cast<float>(static_cast<int8_t>((v.x >> (8 * j)) & 0xffu));
    f[4 + j] = static_cast<float>(static_cast<int8_t>((v.y >> (8 * j)) & 0xffu));
  }
}

// K7. INT8 = false: bf16 rows [C, cap, D]; true: int8 rows with scales [C, cap].
template <bool INT8>
__global__ void __launch_bounds__(kThreads)
probe_scan_kernel(const uint16_t* __restrict__ q,      // [Q, D] bf16 bits
                  const int* __restrict__ probe,       // [Q, P]
                  const void* __restrict__ buckets,    // [C, cap, D]
                  const int* __restrict__ bucket_ids,  // [C, cap]
                  const float* __restrict__ scales,    // [C, cap] (INT8 only)
                  int P, int C, int cap, int D, int k,
                  float* __restrict__ part_v,          // [Q, n_chunks, k]
                  int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);                 // [kChunk]
  int* si = reinterpret_cast<int*>(sv + kChunk);              // [kChunk]
  uint16_t* qs = reinterpret_cast<uint16_t*>(si + kChunk);    // [D]

  const int query = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int n = P * cap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < D; e += kThreads) qs[e] = q[(size_t)query * D + e];
  __syncthreads();

  for (int r = warp; r < kChunk; r += kThreads / 32) {
    const int pos = chunk * kChunk + r;
    const long long slot = slot_of(probe, query, pos, n, P, C, cap);
    const bool live = slot >= 0 && bucket_ids[slot] >= 0;  // warp-uniform
    float acc = 0.f;
    if (live) {
      for (int d0 = lane * 8; d0 < D; d0 += 256) {
        float qf[8], gf[8];
        mmrs::unpack8(*reinterpret_cast<const uint4*>(qs + d0), qf);
        if (INT8) {
          const int8_t* row = static_cast<const int8_t*>(buckets) + slot * D;
          unpack8_i8(*reinterpret_cast<const uint2*>(row + d0), gf);
        } else {
          const uint16_t* row = static_cast<const uint16_t*>(buckets) + slot * D;
          mmrs::unpack8(*reinterpret_cast<const uint4*>(row + d0), gf);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc = fmaf(qf[j], gf[j], acc);
      }
    }
    acc = warp_sum_f(acc);
    if (lane == 0) {
      sv[r] = !live ? -INFINITY : INT8 ? __fmul_rn(acc, scales[slot]) : acc;
      si[r] = pos < n ? pos : -1;
    }
  }
  __syncthreads();
  mmrs::sort_segments(sv, si, kChunk, kChunk);
  mmrs::write_partials(sv, si, 1, query, query + 1, chunk, n_chunks, k, part_v, part_i);
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

// K7 scan pass: partials [Q, ceil(P * cap / 256), k] for `mmrs_topk_merge`.
// The caller (mmrs_tpu_torch/index/ivf.py) checks: CUDA, contiguous, 16-byte
// aligned, dtypes, D % 8 == 0, D <= 2048, 1 <= k <= 256 (the partial list
// length, min(k, 256) of the call), 1 <= Q <= 65535, P * cap < 2^31; `scales` is null unless int8 != 0.
int mmrs_probe_scan(const void* q, const void* probe, const void* buckets,
                    const void* bucket_ids, const void* scales, int int8, int Q, int P,
                    int C, int cap, int D, int k, void* part_v, void* part_i,
                    void* stream) {
  const size_t smem = (size_t)kChunk * (sizeof(float) + sizeof(int)) + (size_t)D * 2;
  const dim3 grid = scan_grid(Q, P * cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* qb = static_cast<const uint16_t*>(q);
  const int* pr = static_cast<const int*>(probe);
  const int* ids = static_cast<const int*>(bucket_ids);
  const float* sc = static_cast<const float*>(scales);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  if (int8) {
    probe_scan_kernel<true><<<grid, kThreads, smem, s>>>(qb, pr, buckets, ids, sc, P, C, cap,
                                                         D, k, pv, pi);
  } else {
    probe_scan_kernel<false><<<grid, kThreads, smem, s>>>(qb, pr, buckets, ids, sc, P, C,
                                                          cap, D, k, pv, pi);
  }
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
