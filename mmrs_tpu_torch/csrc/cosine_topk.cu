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
//   - scan pass (span_scan.cuh, shared with the int8 and int4 scans): one
//     block per (span of rows, tile of 8 queries), the query tiles of one span
//     neighbours in the launch order; rows stream through a cp.async ring
//     into mma.sync m16n8k16 against the tile's queries (rows as M,
//     queries as N, f32 sums); a block keeps each query's best kc of its
//     span by a running threshold and a warp arg-max (kc <= 32; spans of
//     up to 2048 rows), or sorts each 256-row chunk's candidates (kc > 32)
//     and writes partials [Q, n_parts, kc], kc = min(k, 256).
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

#include "span_scan.cuh"
#include "topk_common.cuh"

#include <math.h>

namespace {

using mmrs::kChunk;
using mmrs::kMaxSort;
using mmrs::kThreads;

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

}  // namespace

extern "C" {

int mmrs_topk_chunk_rows() { return kChunk; }
int mmrs_topk_max_sort() { return kMaxSort; }
int mmrs_topk_select_max() { return mmrs::kSelectMax; }

const char* mmrs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scan pass: partials [Q, ceil(N / span), k], k the partial list length
// (min(k, 256) of the call), span the rows a list covers (a multiple of
// 256; 256 when k > kSelectMax). The caller checks shapes: D % 8 == 0
// (ops/topk.py pads a ragged D with zero columns), a D whose query tile
// fits (scan_stages), 1 <= Q <= 65535, 16-byte aligned rows.
int mmrs_topk_scan(const void* q, const void* g, int Q, int N, int D, int k, int span,
                   void* part_v, void* part_i, void* stream) {
  return launch_span_scan<kRowBf16>(q, nullptr, nullptr, g, nullptr, Q, N, D, k, span, part_v,
                                 part_i, static_cast<cudaStream_t>(stream));
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
