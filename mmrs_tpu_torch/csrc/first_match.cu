// K9: keep-first all-pairs first match for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mmrs_tpu/ops/allpairs.py:_first_match_pallas
// (body `_kernel`). For each row i of a [N, D] it returns the lowest local
// column j of b [M, D] with dot(a_i, b_j) >= tau (tau an f32), or -1; with
// `intra` a column counts only when j + col_off < i + row_off (keep-first:
// only earlier global rows are keepers; the sharded ring passes nonzero
// offsets). Rows >= N and columns >= M never match. The [N, M] similarity
// matrix is never written: each tile of it is reduced in registers.
//
// What bounds it on the H100: operations. At N = M = 131,072, D = 512 with
// `intra` the triangle is 8.8 TFLOP: 8.9 ms at the 989 TFLOP/s bf16 tensor
// rate. f32 rows run six such products (below): 53.4 ms.
//
// Design. The TPU grid runs its column tiles in order and computes all of
// them, carrying a running minimum in VMEM. Here one block owns a 128-row
// tile and walks the column tiles in ascending order itself, so a row's
// first match is final as soon as it is found and the running minimum
// stays in shared memory: no atomics across blocks, no merge pass, a
// deterministic result. Two exits the TPU grid could not take, with the
// same function:
//   - with `intra`, the walk stops at the first column tile that no row of
//     the row tile may match (about half the work of the full square);
//   - the walk stops once every row of the tile has a match: a later
//     column cannot lower a minimum.
// Block b takes row tile (tiles - 1 - b): the longest walks of the
// triangle are launched first, so its tail does not idle the card.
//
// Products: two warpgroups, 64 rows each, run wgmma m64n256k16 bf16 -> f32
// (each A row read once for all 256 columns). The walk is one stream of K steps
// through a cp.async ring of A [128 rows] and B [256 rows] tiles in shared
// memory (wgmma_common.cuh), running on from one column tile into the
// next, one step's products in flight while the next step's are issued.
// bf16 rows take K steps of 64 values (128-byte rows, 4 stages of 48 KB).
// Ragged N, M and D are zero-filled on load (D % 8 == 0: a 16-byte chunk
// lies wholly inside or outside a row) and masked in the epilogue (sim >=
// tau, the intra bound, the lowest column per row reduced in registers
// and across the row's four lanes). What binds: the tiles come from L2,
// and every staged byte is written to and read from shared memory by
// both warpgroups' products (B twice).
//
// f32 rows: split_kernel writes each row as three bf16 planes, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (every subtraction
// exact in f32, hi + mid + lo == x for normal values). A stage then holds
// all three planes of A and of B at one K step of 32 values (64-byte rows,
// 3 stages of 72 KB). A column tile's K is walked twice into one f32
// sum: first the five correction products, smallest first: lo.hi, hi.lo,
// mid.mid, mid.hi, hi.mid (each staged byte feeds up to two), then hi.hi
// alone, a stage holding three K steps of the hi planes. The three
// dropped products are at most 3 * 2^-24 * sum |a_i b_i|, below the
// rounding of an f32 sum over D = 512. Products on tensor cores are exact,
// but each wgmma's addition to the f32 accumulator drops low bits toward
// zero, a fraction of an ulp of the running sum: issued after hi.hi at
// every K step, the corrections were added to a sum near the score and
// pulled scores near tau below it by a few 1e-6 (chip_smoke.py's near-tau
// check fails on that). Summed first, they keep the accumulator about
// 2^-8 of the score while they are added, and hi.hi adds D / 16
// instructions, as the bf16 route does. Never TF32, which keeps about
// three digits and would flip decisions near tau.

#include "common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTileM = 128;  // rows of a block: one m64 a warpgroup
constexpr int kTileN = 256;  // columns of a walk step: one wgmma n256
constexpr int kThreads = 256;
constexpr int kNone = 0x7fffffff;
// the planes (0 hi, 1 mid, 2 lo) of the f32 route's products, in the order
// they are summed, smallest first, one 4-bit field each: the first five in
// the first pass over K, hi.hi in the second
constexpr uint32_t kPlaneA = 0x001102;  // lo, hi, mid, mid, hi, hi
constexpr uint32_t kPlaneB = 0x010120;  // hi, lo, mid, hi, mid, hi

// Geometry by input planes. bf16 rows (1): K steps of 64 values (128-byte
// rows), 4 stages of 48 KB. f32 rows (3 planes: hi, mid, lo): K steps of
// 32 values (64-byte rows), 3 stages of all planes' tiles, 72 KB each (in
// the hi.hi pass, three K steps of the hi planes). Both keep one step's products in flight while the
// next step's are issued, and load kStages - 2 steps ahead.
template <int PLANES>
struct Walk {
  static constexpr int kRow = PLANES == 1 ? 128 : 64;  // bytes of K a tile row
  static constexpr int kKStep = kRow / 2;              // bf16 values
  static constexpr int kChunks = kRow / 16;            // 16-byte copies a row
  static constexpr int kStages = PLANES == 1 ? 4 : 3;
  static constexpr int kAhead = kStages - 2;           // steps loading ahead
  static constexpr int kATile = kTileM * kRow;
  static constexpr int kBTile = kTileN * kRow;
  static constexpr int kStageBytes = PLANES * (kATile + kBTile);
  static constexpr int kSmem = kStages * kStageBytes + mmrs::kTileAlign;
};

struct Problem {
  int n, m, d, intra;
  float tau;
  long long row_off, col_off;
  long long a_plane, b_plane;  // elements from one plane to the next
};

// Columns [0, limit) may match a row of the tile starting at r0.
__device__ __forceinline__ int column_limit(const Problem& p, int r0) {
  if (!p.intra) return p.m;
  // column j may match row i only if j < i + row_off - col_off
  const long long lim = (long long)min(r0 + kTileM, p.n) - 1 + p.row_off - p.col_off;
  return (int)max(0LL, min((long long)p.m, lim));
}

// Columns [0, bound) may match row `row`: none past M, none for rows past
// N, and under `intra` only global columns before the row's.
__device__ __forceinline__ int row_bound(const Problem& p, int row) {
  if (row >= p.n) return 0;
  if (!p.intra) return p.m;
  const long long lim = (long long)row + p.row_off - p.col_off;
  return (int)max(0LL, min((long long)p.m, lim));
}

template <int PLANES>
__global__ void __launch_bounds__(kThreads, 1)
first_match_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                   Problem p, int* __restrict__ out) {
  using W = Walk<PLANES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int best[kTileM];
  const uint32_t raw = mmrs::shared_u32(smem_raw);
  const uint32_t base = (raw + mmrs::kTileAlign - 1) & ~uint32_t(mmrs::kTileAlign - 1);

  const int tiles = (p.n + kTileM - 1) / kTileM;
  const int r0 = (tiles - 1 - (int)blockIdx.x) * kTileM;
  const int tid = threadIdx.x;
  if (tid < kTileM) best[tid] = kNone;

  // K steps of a column tile. f32 rows walk K twice: first the five
  // correction products from all planes (steps1), then hi.hi alone, three
  // K steps of the hi planes a stage (see the f32 note above)
  const int steps1 = (p.d + W::kKStep - 1) / W::kKStep;
  const int steps = PLANES == 1 ? steps1 : steps1 + (p.d + 3 * W::kKStep - 1) / (3 * W::kKStep);
  const int limit = column_limit(p, r0);
  const int col_tiles = (limit + kTileN - 1) / kTileN;
  const long long total = (long long)col_tiles * steps;

  // copies of the walk's next K step, in order: every plane's A [128 rows]
  // and B [256 rows] tile, 16-byte chunks; stage layout: A planes, then B
  // planes
  long long loaded = 0;
  int ld_c0 = 0, ld_k0 = 0, ld_s = 0;  // its column tile, K offset and step
  auto load_next = [&]() {
    const uint32_t sA = base + (uint32_t)(loaded % W::kStages) * W::kStageBytes;
    const uint32_t sB = sA + PLANES * W::kATile;
    const bool hi_only = PLANES == 3 && ld_s >= steps1;  // slot pl: hi at K + pl * kKStep
#pragma unroll
    for (int i = 0; i < kTileN * W::kChunks / kThreads; ++i) {
      const int id = tid + i * kThreads, r = id / W::kChunks, c = id % W::kChunks;
      const bool ra = r0 + r < p.n, rb = ld_c0 + r < p.m;
      const int at = mmrs::swizzled<W::kRow>(r, c);
#pragma unroll
      for (int pl = 0; pl < PLANES; ++pl) {
        const int k = ld_k0 + 8 * c + (hi_only ? pl * W::kKStep : 0);
        const long long plane = hi_only ? 0 : pl;
        const bool va = k < p.d && ra, vb = k < p.d && rb;
        const size_t ea = va ? (size_t)(r0 + r) * p.d + k : 0;
        const size_t eb = vb ? (size_t)(ld_c0 + r) * p.d + k : 0;
        if (i < kTileM * W::kChunks / kThreads)
          mmrs::cp_async16(sA + pl * W::kATile + at, a + plane * p.a_plane + ea, va);
        mmrs::cp_async16(sB + pl * W::kBTile + at, b + plane * p.b_plane + eb, vb);
      }
    }
    ++loaded;
    ld_k0 += (hi_only ? 3 : 1) * W::kKStep;
    if (++ld_s == steps1) ld_k0 = 0;
    if (ld_s == steps) {
      ld_s = ld_k0 = 0;
      ld_c0 += kTileN;
    }
  };

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // this thread's two rows (local g + 8h of its warp's 16) and their bounds
  const int rl[2] = {wg * 64 + warp * 16 + g, wg * 64 + warp * 16 + g + 8};
  const int bound[2] = {row_bound(p, r0 + rl[0]), row_bound(p, r0 + rl[1])};

#pragma unroll
  for (int s = 0; s < W::kAhead; ++s) {
    if (loaded < total) load_next();
    mmrs::cp_async_commit_group();
  }
  long long it = 0;
  for (int ct = 0; ct < col_tiles; ++ct) {
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    mmrs::fence_regs(acc);
    for (int kk = 0; kk < steps; ++kk, ++it) {
      mmrs::cp_async_wait_group<W::kAhead - 1>();  // this thread's copies of step it landed
      mmrs::fence_proxy_async();
      // every copy of step it landed; every warpgroup's products of step
      // it - 2 are done, so that step's stage may be refilled
      __syncthreads();
      if (loaded < total) load_next();  // step it + kAhead
      mmrs::cp_async_commit_group();
      const uint32_t sA = base + (uint32_t)(it % W::kStages) * W::kStageBytes;
      const uint64_t da = mmrs::sw_desc<W::kRow>(sA + wg * 64 * W::kRow);
      const uint64_t db = mmrs::sw_desc<W::kRow>(sA + PLANES * W::kATile);
      mmrs::wgmma_fence();
      if (PLANES == 1 || kk >= steps1) {  // bf16 rows; f32 rows' hi.hi, one a slot
#pragma unroll
        for (int pl = 0; pl < PLANES; ++pl)
#pragma unroll
          for (int j = 0; j < W::kRow / 32; ++j)
            mmrs::wgmma_bf16_m64n256k16(acc, da + (pl * W::kATile >> 4) + 2 * j,
                                        db + (pl * W::kBTile >> 4) + 2 * j);
      } else {  // f32 rows' five correction products
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const int pa = (kPlaneA >> (4 * q)) & 0xf, pb = (kPlaneB >> (4 * q)) & 0xf;
#pragma unroll
          for (int j = 0; j < W::kRow / 32; ++j)
            mmrs::wgmma_bf16_m64n256k16(acc, da + (pa * W::kATile >> 4) + 2 * j,
                                        db + (pb * W::kBTile >> 4) + 2 * j);
        }
      }
      mmrs::wgmma_commit();
      mmrs::wgmma_wait<1>();  // step it - 1's products are done
      mmrs::fence_regs(acc);
    }
    mmrs::wgmma_wait<0>();
    mmrs::fence_regs(acc);

    // epilogue: register 4j + 2h + e is row rl[h], column c0 + 8j + 2t + e;
    // each row's lowest counting column over the row's four lanes, folded
    // into best[] by lane t == 0 (its only writer)
    const int c0 = ct * kTileN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int cand = kNone;
#pragma unroll
      for (int j = kTileN / 8 - 1; j >= 0; --j) {
#pragma unroll
        for (int e = 1; e >= 0; --e) {  // descending: the last hit is the lowest
          const int col = c0 + 8 * j + 2 * t + e;
          if (acc[4 * j + 2 * h + e] >= p.tau && col < bound[h]) cand = col;
        }
      }
      cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, 1));
      cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, 2));
      if (t == 0 && cand < best[rl[h]]) best[rl[h]] = cand;
    }
    __syncthreads();
    // every live row of the tile has its match: a later column cannot win
    const bool ok = tid >= kTileM || r0 + tid >= p.n || best[tid] != kNone;
    if (__syncthreads_and(ok)) break;
  }
  mmrs::cp_async_wait_group<0>();
  if (tid < kTileM && r0 + tid < p.n) out[r0 + tid] = best[tid] == kNone ? -1 : best[tid];
}

template <int PLANES>
int walk(const void* a, const void* b, const Problem& p, void* out, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(first_match_kernel<PLANES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Walk<PLANES>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (p.n + kTileM - 1) / kTileM;
  first_match_kernel<PLANES><<<blocks, kThreads, Walk<PLANES>::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), p,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[3, count] bf16 planes hi, mid, lo of x[count] f32 (count % 4 == 0,
// 16-byte aligned): an elementwise pass, written in CUDA beside the kernel
// that reads it (Triton would serve as well).
__global__ void split_kernel(const float4* __restrict__ x, __nv_bfloat16* __restrict__ out,
                             long long count) {
  const long long quads = count / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < quads;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[2] = {0u, 0u}, mid[2] = {0u, 0u}, lo[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16 h = __float2bfloat16_rn(f[j]);
      const float r1 = __fsub_rn(f[j], __bfloat162float(h));
      const __nv_bfloat16 md = __float2bfloat16_rn(r1);
      const __nv_bfloat16 l = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(md)));
      const int sh = 16 * (j & 1);  // the first of two values in the low half
      hi[j >> 1] |= (uint32_t)__bfloat16_as_ushort(h) << sh;
      mid[j >> 1] |= (uint32_t)__bfloat16_as_ushort(md) << sh;
      lo[j >> 1] |= (uint32_t)__bfloat16_as_ushort(l) << sh;
    }
    *reinterpret_cast<uint2*>(out + 4 * i) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(out + count + 4 * i) = make_uint2(mid[0], mid[1]);
    *reinterpret_cast<uint2*>(out + 2 * count + 4 * i) = make_uint2(lo[0], lo[1]);
  }
}

}  // namespace

extern "C" {

// Tile rows, tile columns, then the K step (bf16 values), ring stages and
// dynamic shared memory of the bf16 and the f32 walks, for the caller's
// plan (mmrs_tpu_torch/ops/allpairs.py: first_match_plan).
int mmrs_first_match_geometry(int what) {
  const int v[8] = {kTileM,          kTileN,           Walk<1>::kKStep, Walk<1>::kStages,
                    Walk<1>::kSmem,  Walk<3>::kKStep,  Walk<3>::kStages, Walk<3>::kSmem};
  return what >= 0 && what < 8 ? v[what] : -1;
}

// The hi/mid/lo bf16 planes [3, count] of count f32 values.
int mmrs_split_bf16x3(const void* x, void* out, long long count, void* stream) {
  if (count < 0 || count % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0) return 0;
  const long long quads = count / 4;
  const long long want = (quads + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<__nv_bfloat16*>(out), count);
  return static_cast<int>(cudaGetLastError());
}

// planes == 1: a bf16 [N, D], b bf16 [M, D]; planes == 3: a [3, N, D] and b
// [3, M, D], the hi/mid/lo planes of f32 rows. The caller (mmrs_tpu_torch/
// ops/allpairs.py) checks: CUDA, contiguous, one dtype, D % 8 == 0, 16-byte
// aligned rows, 1 <= N, 0 <= M < 2^31.
int mmrs_first_match(const void* a, const void* b, int n, int m, int d, float tau, int intra,
                     long long row_off, long long col_off, int planes, void* out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || m < 0 || d <= 0 || d % 8) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{n, m, d, intra ? 1 : 0, tau, row_off, col_off, (long long)n * d,
                  (long long)m * d};
  if (planes == 1) return walk<1>(a, b, p, out, s);
  if (planes == 3) return walk<3>(a, b, p, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
