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
//     as partials [Q, n_chunks, kc], kc = min(k, 256): above k = 256 a
//     chunk's partial list is the whole chunk, sorted.
//   - merge passes (repeated until one list is left; ops/topk.py:scan_plan
//     plans them, each merging at least two lists, so any k terminates):
//     while two lists fit kMaxSort (8192 candidates, 64 KB), one block per
//     (query, group of lists) merges the group's sorted lists in shared
//     memory by bitonic merges that drop the worse half of each pair once
//     a run holds k, and keeps its best min(k, candidates); above that
//     (k > 4096), a merge-path pass merges list pairs, each output
//     position finding its co-rank in the pair by binary search in device
//     memory.
// The TPU kernel carried its running top-k across a sequential grid; CUDA
// blocks run in no order, hence partials plus merge. Both passes order by
// (score desc, row id asc), which is `_topk_merge`'s tie rule (first argmax,
// earlier rows first), and rows past N enter as (-inf, -1), its sentinel.
// Tensor cores, TMA and a persistent grid are later work.

#include "topk_common.cuh"

#include <math.h>

namespace {

using mmrs::kChunk;
using mmrs::kMaxSort;
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

// Sort merge: groups of `per` sorted lists of L -> the best Lout of each
// group, sorted. Each list sits in shared memory padded to LP = 2^ceil(log2
// L) entries (-inf, -1), the group padded with empty lists to width (a
// power of two <= kMaxSort). Runs of sorted entries are merged pairwise by
// bitonic merges (a flip stage comparing A[i] with B[R-1-i], then half-
// cleaners) until a run holds KP = 2^ceil(log2 Lout) entries; from there
// each pairwise merge keeps only its better half (the flip stage's winners
// are the pair's best R, a bitonic run that the half-cleaners sort), so
// the candidates halve at every level. Runs stay where they were loaded,
// `gap` apart: nothing moves but the compare-exchanges.
__device__ __forceinline__ void cmp_swap(float* sv, int* si, int a, int b) {
  const float va = sv[a], vb = sv[b];
  const int ia = si[a], ib = si[b];
  if (mmrs::before(vb, ib, va, ia)) {
    sv[a] = vb; sv[b] = va;
    si[a] = ib; si[b] = ia;
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ in_v,  // [Q, S, L], each list sorted
                  const int* __restrict__ in_i,
                  int S, int L, int per, int width, int Lout,
                  float* __restrict__ out_v,       // [Q, ceil(S / per), Lout]
                  int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sv = reinterpret_cast<float*>(smem);      // [width]
  int* si = reinterpret_cast<int*>(sv + width);    // [width]
  const int query = blockIdx.y, group = blockIdx.x;
  const int s0 = group * per;
  const int lists = min(per, S - s0);
  const size_t base = ((size_t)query * S + s0) * L;
  int LP = 1, KP = 1;
  while (LP < L) LP <<= 1;
  while (KP < Lout) KP <<= 1;
  for (int e = threadIdx.x; e < width; e += kThreads) {
    const int list = e / LP, j = e - list * LP;
    const bool valid = list < lists && j < L;
    sv[e] = valid ? in_v[base + (size_t)list * L + j] : -INFINITY;
    si[e] = valid ? in_i[base + (size_t)list * L + j] : -1;
  }
  __syncthreads();
  int run = LP, gap = LP, runs = width / LP;
  while (runs > 1) {
    const bool keep_both = 2 * run <= KP;   // then gap == run: pairs are contiguous
    for (int t = threadIdx.x; t < (runs / 2) * run; t += kThreads) {
      const int pair = t / run, i = t - pair * run;
      cmp_swap(sv, si, 2 * pair * gap + i, (2 * pair + 1) * gap + run - 1 - i);
    }
    __syncthreads();
    // half-cleaners inside each half that is kept (each half is bitonic)
    const int halves = keep_both ? runs : runs / 2;
    const int stride_of_half = keep_both ? gap : 2 * gap;
    for (int st = run / 2; st > 0; st >>= 1) {
      for (int t = threadIdx.x; t < halves * (run / 2); t += kThreads) {
        const int h = t / (run / 2), x = t - h * (run / 2);
        const int i = 2 * st * (x / st) + (x % st);
        const int a = h * stride_of_half + i;
        cmp_swap(sv, si, a, a + st);
      }
      __syncthreads();
    }
    if (keep_both) {
      run *= 2;
      gap = run;
    } else {
      gap *= 2;
    }
    runs /= 2;
  }
  for (int j = threadIdx.x; j < Lout; j += kThreads) {
    const size_t o = ((size_t)query * gridDim.x + group) * Lout + j;
    out_v[o] = sv[j];
    out_i[o] = si[j];
  }
}

// Merge-path merge: list pairs (A = 2g, B = 2g + 1; an odd last list is
// copied, padded with (-inf, -1)) of L -> one sorted list of Lout = min(k, 2L). Output position j
// takes its co-rank i, the count of A's entries among the first j, by
// binary search: the smallest i at which A[i] no longer ranks before
// B[j - i - 1]. On equal (score, id) A is taken first.
__global__ void __launch_bounds__(kThreads)
topk_merge_path_kernel(const float* __restrict__ in_v,  // [Q, S, L]
                       const int* __restrict__ in_i,
                       int S, int L, int Lout,
                       float* __restrict__ out_v,       // [Q, ceil(S / 2), Lout]
                       int* __restrict__ out_i) {
  const int tiles = (Lout + kThreads - 1) / kThreads;
  const int group = blockIdx.x / tiles, query = blockIdx.y;
  const int j = (blockIdx.x - group * tiles) * kThreads + threadIdx.x;
  if (j >= Lout) return;
  const size_t a0 = ((size_t)query * S + 2 * group) * L;
  const float* av = in_v + a0;
  const int* ai = in_i + a0;
  const float* bv = av + L;
  const int* bi = ai + L;
  const int lb = 2 * group + 1 < S ? L : 0;
  const size_t o = ((size_t)query * ((S + 1) / 2) + group) * Lout + j;
  if (j >= L + lb) {   // past a lone last list's candidates
    out_v[o] = -INFINITY;
    out_i[o] = -1;
    return;
  }
  // A[i] is taken before B[x] unless B[x] ranks strictly before it
  auto a_first = [&](int i, int x) { return !mmrs::before(bv[x], bi[x], av[i], ai[i]); };
  int lo = max(0, j - lb), hi = min(j, L);
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (a_first(i, j - i - 1)) lo = i + 1; else hi = i;
  }
  const int i = lo, x = j - lo;
  const bool take_a = i < L && (x >= lb || a_first(i, x));
  out_v[o] = take_a ? av[i] : bv[x];
  out_i[o] = take_a ? ai[i] : bi[x];
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
int mmrs_topk_max_sort() { return kMaxSort; }

const char* mmrs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scan pass: partials [Q, ceil(N / 256), k], k the partial list length
// (min(k, 256) of the call). The caller checks shapes: D % 8 == 0,
// D <= 2048, 1 <= k <= 256, 1 <= Q <= 65535, qt in {1, 2, 4, 8}.
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

// Merge pass over partials [Q, S, L] -> [Q, ceil(S / per), Lout]. width > 0:
// sort merge of `per` lists in `width` (a power of two, per * 2^ceil(log2 L)
// <= width <= kMaxSort, Lout <= per * L); width == 0: merge-path merge of list pairs
// (per == 2, Lout <= 2L). ops/topk.py:scan_plan picks the passes.
int mmrs_topk_merge(const void* in_v, const void* in_i, int Q, int S, int L, int per,
                    int width, int Lout, void* out_v, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (S + per - 1) / per;
  if (width == 0) {
    if (per != 2) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (Lout + kThreads - 1) / kThreads;
    topk_merge_path_kernel<<<dim3(groups * tiles, Q), kThreads, 0, s>>>(
        static_cast<const float*>(in_v), static_cast<const int*>(in_i), S, L, Lout,
        static_cast<float*>(out_v), static_cast<int*>(out_i));
    return static_cast<int>(cudaGetLastError());
  }
  int LP = 1;
  while (LP < L) LP <<= 1;
  if (width > kMaxSort || (width & (width - 1)) || per * LP > width || Lout > per * L)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = width * (int)(sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<dim3(groups, Q), kThreads, smem, s>>>(
      static_cast<const float*>(in_v), static_cast<const int*>(in_i), S, L, per, width,
      Lout, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
