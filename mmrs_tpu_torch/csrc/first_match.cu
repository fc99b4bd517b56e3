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
// rate, 131 ms at the 67 TFLOP/s f32 CUDA-core rate; its inputs are 134 MB
// (bf16), 0.04 ms of device memory.
//
// Design. The TPU grid runs its column tiles in order and computes all of
// them, carrying a running minimum in VMEM. Here one block owns a 128-row
// tile and walks the 128-column tiles in ascending order itself, so a
// row's first match is final as soon as it is found and the running
// minimum stays in shared memory: no atomics across blocks, no merge pass,
// a deterministic result. Two exits the TPU grid could not take, with the
// same function:
//   - with `intra`, the walk stops at the first column tile that no row of
//     the row tile may match (about half the work of the full square);
//   - the walk stops once every row of the tile has a match: a later
//     column cannot lower a minimum.
// Block b takes row tile (tiles - 1 - b): the longest walks of the
// triangle are launched first, so its tail does not idle the card.
//
// Arithmetic: sums are f32 in both kernels. bf16 inputs go through
// mma.sync m16n8k16 bf16 -> f32 (exact products; only the order of the
// sums differs from the reference). f32 inputs (what embedding dedup
// passes) use FMAs on the CUDA cores with 8 x 8 register tiles, never
// TF32, which keeps about three digits and would flip decisions near tau.
// Each D chunk of the a and b tiles is staged in shared memory, the next
// chunk loaded into registers meanwhile; ragged N, M and D are masked
// (D % 8 == 0, so a 16-byte vector is wholly inside or outside a row).
// TMA-fed tiles and wgmma are later work.

#include "common.cuh"

namespace {

constexpr int kTile = 128;  // rows (and columns) of one tile
constexpr int kThreads = 256;
constexpr int kNone = 0x7fffffff;

struct Problem {
  int n, m, d, intra;
  float tau;
  long long row_off, col_off;
};

// Columns [0, limit) may match a row of the tile starting at r0.
__device__ __forceinline__ int column_limit(const Problem& p, int r0) {
  if (!p.intra) return p.m;
  // column j may match row i only if j < i + row_off - col_off
  const long long lim = (long long)min(r0 + kTile, p.n) - 1 + p.row_off - p.col_off;
  return (int)max(0LL, min((long long)p.m, lim));
}

__device__ __forceinline__ bool counts(const Problem& p, float sim, int row, int col) {
  return sim >= p.tau && row < p.n && col < p.m &&
         (!p.intra || col + p.col_off < row + p.row_off);
}

// After a column tile: every live row of the tile has its match.
__device__ __forceinline__ bool tile_done(const Problem& p, int r0, const int* best0,
                                          const int* best1) {
  __syncthreads();
  const int r = threadIdx.x;
  const bool ok =
      r >= kTile || r0 + r >= p.n || best0[r] != kNone || (best1 && best1[r] != kNone);
  return __syncthreads_and(ok);
}

// ---------------------------------------------------------------------------
// f32 inputs: CUDA-core FMAs. Thread (ty, tx) of a 16 x 16 grid owns rows
// {ty*4 .. ty*4+3, 64+ty*4 .. 64+ty*4+3} and the same columns from tx.
constexpr int kChunk32 = 8;  // D per staged chunk

__global__ void __launch_bounds__(kThreads)
first_match_f32_kernel(const float* __restrict__ a, const float* __restrict__ b, Problem p,
                       int* __restrict__ out) {
  __shared__ __align__(16) float As[kChunk32][kTile + 4];  // transposed tiles
  __shared__ __align__(16) float Bs[kChunk32][kTile + 4];
  __shared__ int best[kTile];

  const int tiles = (p.n + kTile - 1) / kTile;
  const int r0 = (tiles - 1 - (int)blockIdx.x) * kTile;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (tid < kTile) best[tid] = kNone;

  // loader: one float4 of a and one of b per chunk; row tid / 2, k (tid & 1) * 4
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool a_live = r0 + lr < p.n;
  const float* a_row = a + (size_t)(a_live ? r0 + lr : 0) * p.d + lk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int limit = column_limit(p, r0);

  for (int c0 = 0; c0 < limit; c0 += kTile) {
    const bool b_live = c0 + lr < p.m;
    const float* b_row = b + (size_t)(b_live ? c0 + lr : 0) * p.d + lk;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float4 ra = a_live ? __ldg(reinterpret_cast<const float4*>(a_row)) : zero;
    float4 rb = b_live ? __ldg(reinterpret_cast<const float4*>(b_row)) : zero;
    for (int k0 = 0; k0 < p.d; k0 += kChunk32) {
      As[lk + 0][lr] = ra.x; As[lk + 1][lr] = ra.y; As[lk + 2][lr] = ra.z; As[lk + 3][lr] = ra.w;
      Bs[lk + 0][lr] = rb.x; Bs[lk + 1][lr] = rb.y; Bs[lk + 2][lr] = rb.z; Bs[lk + 3][lr] = rb.w;
      __syncthreads();
      if (k0 + kChunk32 < p.d) {  // the next chunk is in flight during the FMAs
        ra = a_live ? __ldg(reinterpret_cast<const float4*>(a_row + k0 + kChunk32)) : zero;
        rb = b_live ? __ldg(reinterpret_cast<const float4*>(b_row + k0 + kChunk32)) : zero;
      }
#pragma unroll
      for (int k = 0; k < kChunk32; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: each row's lowest matching column, over the 16 tx lanes of
    // its half-warp, folded into best[] by lane tx == 0 (its only writer)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      int cand = kNone;
#pragma unroll
      for (int j = 7; j >= 0; --j) {  // descending: the last hit is the lowest
        const int col = c0 + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
        if (counts(p, acc[i][j], r0 + rl, col)) cand = col;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, off));
      if (tx == 0 && cand < best[rl]) best[rl] = cand;
    }
    if (tile_done(p, r0, best, nullptr)) break;
  }
  __syncthreads();
  if (tid < kTile && r0 + tid < p.n) out[r0 + tid] = best[tid] == kNone ? -1 : best[tid];
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores. Warp w computes rows (w & 3) * 32 .. +31 and
// columns (w >> 2) * 64 .. +63 of the tile: 2 x 8 mma tiles of 16 x 8.
constexpr int kChunk16 = 32;         // D per staged chunk (two k16 steps)
constexpr int kLd = kChunk16 + 8;    // padded shared row: conflict-free fragments

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
first_match_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b, Problem p,
                        int* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 As[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 Bs[kTile][kLd];
  __shared__ int best[2][kTile];  // per column half: one writer per entry

  const int tiles = (p.n + kTile - 1) / kTile;
  const int r0 = (tiles - 1 - (int)blockIdx.x) * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  if (tid < kTile) best[0][tid] = best[1][tid] = kNone;

  // loader: rows tid / 4 and 64 + tid / 4, eight bf16 at k (tid & 3) * 8
  const int lr = tid >> 2, lk = (tid & 3) * 8;
  bool a_live[2];
  const __nv_bfloat16* a_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a_live[h] = r0 + lr + 64 * h < p.n;
    a_row[h] = a + (size_t)(a_live[h] ? r0 + lr + 64 * h : 0) * p.d + lk;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int limit = column_limit(p, r0);

  for (int c0 = 0; c0 < limit; c0 += kTile) {
    bool b_live[2];
    const __nv_bfloat16* b_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      b_live[h] = c0 + lr + 64 * h < p.m;
      b_row[h] = b + (size_t)(b_live[h] ? c0 + lr + 64 * h : 0) * p.d + lk;
    }
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    uint4 ra[2], rb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ra[h] = a_live[h] && lk < p.d ? __ldg(reinterpret_cast<const uint4*>(a_row[h])) : zero;
      rb[h] = b_live[h] && lk < p.d ? __ldg(reinterpret_cast<const uint4*>(b_row[h])) : zero;
    }
    for (int k0 = 0; k0 < p.d; k0 += kChunk16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<uint4*>(&As[lr + 64 * h][lk]) = ra[h];
        *reinterpret_cast<uint4*>(&Bs[lr + 64 * h][lk]) = rb[h];
      }
      __syncthreads();
      const int kn = k0 + kChunk16 + lk;  // this thread's next vector
      if (k0 + kChunk16 < p.d) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ra[h] = a_live[h] && kn < p.d
                      ? __ldg(reinterpret_cast<const uint4*>(a_row[h] + k0 + kChunk16))
                      : zero;
          rb[h] = b_live[h] && kn < p.d
                      ? __ldg(reinterpret_cast<const uint4*>(b_row[h] + k0 + kChunk16))
                      : zero;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kChunk16; ks += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const __nv_bfloat16* r = &As[wm * 32 + mt * 16 + g][ks + 2 * t];
          af[mt][0] = ld32(r);
          af[mt][1] = ld32(r + 8 * kLd);
          af[mt][2] = ld32(r + 8);
          af[mt][3] = ld32(r + 8 * kLd + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* r = &Bs[wn * 64 + nt * 8 + g][ks + 2 * t];
          const uint32_t bf[2] = {ld32(r), ld32(r + 8)};
          mma_bf16(acc[0][nt], af[0], bf);
          mma_bf16(acc[1][nt], af[1], bf);
        }
      }
      __syncthreads();
    }

    // epilogue: accumulator e of tile (mt, nt) is row g + 8 * (e >> 1) of
    // m-tile mt and column 2t + (e & 1) of n-tile nt; the four lanes of a
    // group hold one row's 64 columns of this warp
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm * 32 + mt * 16 + 8 * h + g;
        int cand = kNone;
#pragma unroll
        for (int nt = 7; nt >= 0; --nt) {
#pragma unroll
          for (int e = 1; e >= 0; --e) {  // descending: the last hit is the lowest
            const int col = c0 + wn * 64 + nt * 8 + 2 * t + e;
            if (counts(p, acc[mt][nt][2 * h + e], r0 + rl, col)) cand = col;
          }
        }
        cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, 1));
        cand = min(cand, __shfl_xor_sync(0xffffffffu, cand, 2));
        if (t == 0 && cand < best[wn][rl]) best[wn][rl] = cand;
      }
    }
    if (tile_done(p, r0, best[0], best[1])) break;
  }
  __syncthreads();
  if (tid < kTile && r0 + tid < p.n) {
    const int v = min(best[0][tid], best[1][tid]);
    out[r0 + tid] = v == kNone ? -1 : v;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32. The caller (mmrs_tpu_torch/ops/allpairs.py)
// checks: CUDA, contiguous, one dtype, D % 8 == 0, 16-byte aligned rows,
// 1 <= N, 0 <= M < 2^31.
int mmrs_first_match(const void* a, const void* b, int n, int m, int d, float tau,
                     int intra, long long row_off, long long col_off, int dtype, void* out,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || m < 0 || d <= 0 || d % 8) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{n, m, d, intra ? 1 : 0, tau, row_off, col_off};
  const int blocks = (n + kTile - 1) / kTile;
  if (dtype == 0)
    first_match_bf16_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), p,
        static_cast<int*>(out));
  else if (dtype == 1)
    first_match_f32_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), p, static_cast<int*>(out));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
