// Fused cosine top-k gallery scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmrs_tpu/ops/topk.py:_cosine_topk_pallas
// (body `_kernel`, running top-k `_topk_merge`). Queries [Q, D] and the
// gallery [N, D] are bf16; scores are f32 dot products; the result is the
// best k (score, row id) pairs per query, best first.
//
// What bounds it on the H100: bytes. At Q <= 64 a query does at most 64
// multiply-adds per gallery byte pair, far below the ~295 FLOP/byte ridge,
// so the floor is one read of the gallery (1 GiB at N=2^20, D=512: ~0.32 ms
// at 3.35 TB/s). The design reads every gallery row from device memory once
// per call and never writes the [Q, N] score matrix:
//   - scan pass: one block per (chunk of 256 rows, tile of <= 8 queries);
//     the query tiles of one chunk are neighbours in the launch order, so
//     the chunk comes from DRAM once and from L2 for the other tiles. A
//     warp scores one row for all the tile's queries (16-byte coalesced
//     loads, f32 FMA), the chunk's scores go to shared memory, a bitonic
//     network sorts each query's 256 candidates and the best k are written
//     as partials [Q, n_chunks, k].
//   - merge pass (repeated until one list is left): one block per (query,
//     group of 1024/k partial lists) sorts the group and keeps its best k.
// The TPU kernel carried its running top-k across a sequential grid; CUDA
// blocks run in no order, hence partials plus merge. Both passes order by
// (score desc, row id asc), which is `_topk_merge`'s tie rule (first argmax,
// earlier rows first), and rows past N enter as (-inf, -1), its sentinel.
// Tensor cores, TMA and a persistent grid are later work.

#include "topk_common.cuh"

#include <math.h>

namespace {

using mmrs::kChunk;
using mmrs::kMergeWidth;
using mmrs::kThreads;
using mmrs::sort_segments;

template <int QT>
__global__ void __launch_bounds__(kThreads)
topk_scan_kernel(const uint16_t* __restrict__ q,   // [Q, D] bf16 bits
                 const uint16_t* __restrict__ g,   // [N, D] bf16 bits
                 int Q, int N, int D, int k, int n_qtiles,
                 float* __restrict__ part_v,       // [Q, n_chunks, k]
                 int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);                     // [QT][kChunk]
  int* si = reinterpret_cast<int*>(sv + QT * kChunk);             // [QT][kChunk]
  uint16_t* qs = reinterpret_cast<uint16_t*>(si + QT * kChunk);   // [QT][D]

  const int n_chunks = gridDim.x / n_qtiles;
  const int chunk = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * QT;
  const int row0 = chunk * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // stage the tile's queries; rows past Q read as zeros and are never written
  for (int e = threadIdx.x; e < QT * D; e += kThreads) {
    const int qi = e / D;
    qs[e] = (q0 + qi < Q) ? q[(size_t)(q0 + qi) * D + (e - qi * D)] : 0;
  }
  __syncthreads();

  for (int r = warp; r < kChunk; r += kThreads / 32) {
    const int row = row0 + r;
    float acc[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) acc[qi] = 0.f;
    if (row < N) {  // warp-uniform
      const uint16_t* grow = g + (size_t)row * D;
      for (int d0 = lane * 8; d0 < D; d0 += 256) {
        float gf[8];
        mmrs::unpack8(*reinterpret_cast<const uint4*>(grow + d0), gf);
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          float qf[8];
          mmrs::unpack8(*reinterpret_cast<const uint4*>(qs + qi * D + d0), qf);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[qi] = fmaf(qf[j], gf[j], acc[qi]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      float s = acc[qi];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      acc[qi] = s;
    }
    if (lane == 0) {
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        sv[qi * kChunk + r] = row < N ? acc[qi] : -INFINITY;
        si[qi * kChunk + r] = row < N ? row : -1;
      }
    }
  }
  __syncthreads();
  sort_segments(sv, si, kChunk, QT * kChunk);
  mmrs::write_partials(sv, si, QT, q0, Q, chunk, n_chunks, k, part_v, part_i);
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ in_v,  // [Q, S, k], each list sorted
                  const int* __restrict__ in_i,
                  int S, int k, int per,
                  float* __restrict__ out_v,       // [Q, ceil(S / per), k]
                  int* __restrict__ out_i) {
  __shared__ float sv[kMergeWidth];
  __shared__ int si[kMergeWidth];
  const int query = blockIdx.y, group = blockIdx.x;
  const int s0 = group * per;
  const int count = min(per, S - s0) * k;
  const size_t base = ((size_t)query * S + s0) * k;
  for (int e = threadIdx.x; e < kMergeWidth; e += kThreads) {
    const bool valid = e < count;
    sv[e] = valid ? in_v[base + e] : -INFINITY;
    si[e] = valid ? in_i[base + e] : -1;
  }
  __syncthreads();
  sort_segments(sv, si, kMergeWidth, kMergeWidth);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const size_t o = ((size_t)query * gridDim.x + group) * k + j;
    out_v[o] = sv[j];
    out_i[o] = si[j];
  }
}

template <int QT>
void launch_scan(const void* q, const void* g, int Q, int N, int D, int k,
                 void* part_v, void* part_i, cudaStream_t stream) {
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const int n_qtiles = (Q + QT - 1) / QT;
  const size_t smem = (size_t)QT * kChunk * (sizeof(float) + sizeof(int)) +
                      (size_t)QT * D * sizeof(uint16_t);
  topk_scan_kernel<QT><<<n_chunks * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(g), Q, N, D, k,
      n_qtiles, static_cast<float*>(part_v), static_cast<int*>(part_i));
}

}  // namespace

extern "C" {

int mmrs_topk_chunk_rows() { return kChunk; }
int mmrs_topk_merge_width() { return kMergeWidth; }

const char* mmrs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scan pass: partials [Q, ceil(N / 256), k]. The caller checks shapes:
// D % 8 == 0, D <= 2048, 1 <= k <= 256, qt in {1, 2, 4, 8}.
int mmrs_topk_scan(const void* q, const void* g, int Q, int N, int D, int k, int qt,
                   void* part_v, void* part_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qt) {
    case 1: launch_scan<1>(q, g, Q, N, D, k, part_v, part_i, s); break;
    case 2: launch_scan<2>(q, g, Q, N, D, k, part_v, part_i, s); break;
    case 4: launch_scan<4>(q, g, Q, N, D, k, part_v, part_i, s); break;
    case 8: launch_scan<8>(q, g, Q, N, D, k, part_v, part_i, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Merge pass: groups of `per` sorted lists of k -> one sorted list of k each.
int mmrs_topk_merge(const void* in_v, const void* in_i, int Q, int S, int k, int per,
                    void* out_v, void* out_i, void* stream) {
  const dim3 grid((S + per - 1) / per, Q);
  topk_merge_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in_v), static_cast<const int*>(in_i), S, k, per,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
