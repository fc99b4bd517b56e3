// Fused int8 transformer MLP for Hopper (sm_90a):
//   row-quantize x -> int8 w1 -> * scales + bias -> GELU / quick_gelu (f32)
//   -> row-quantize h -> int8 w2 -> * scales + bias -> x's dtype.
//
// Replaces the Pallas TPU kernel mmrs_tpu/ops/mlp_int8.py:mlp_int8_fused
// (body `_kernel`). x is [M, W] bf16 or f32; w1 is int8 [H, W] and w2 int8
// [W, H] in the port's [out, in] layout, so each output's K-vector is
// contiguous; scales and biases are f32 per output channel. Numerics are
// the reference kernel's: per-row scale max(|x|, 1e-12) / 127, codes
// rint(x / scale) (half to even, a true division), exact int32 products,
// the epilogue (float)acc * sx * s + b with no FMA contraction, and the
// hidden activations h kept in f32 until they are quantized: they are never
// rounded to bf16 (the JAX package's default XLA route does round them).
//
// What bounds it on the H100: at the ViT-B/32 serving batch (M = 224 * 50,
// W = 768, H = 3072) the two products are 105 G int8 operations, ~53 us at
// the card's 1979 TOPS; the unfused form also moves the f32 [M, H] hidden
// activations through device memory about ten times (~1.4 GB). This kernel
// keeps h in shared memory: one block per tile of 16 rows (8 when H is too
// wide for 16 f32 rows, e.g. L/14's 4096) quantizes its x rows into shared
// memory, runs the first product with warp-level tensor-core MMA
// (mma.sync m16n8k32 s8 -> s32) against w1 rows read from L2, writes f32 h
// to shared memory with the epilogue and activation, takes each row's max,
// quantizes h in place to int8, and runs the second product the same way.
// Only x, the int8 weights (from L2 after the first blocks) and the output
// cross device memory. The weights are re-read by every block (700 blocks
// x 4.5 MB of L2 traffic at B/32): larger row tiles with h spilled to
// registers, TMA-fed weight tiles and wgmma are later work.
//
// MMA operand layout: for one 32-wide K step, lane (g = lane / 4,
// t = lane % 4) loads 8 contiguous bytes, K offsets 8t..8t+7, of A rows g
// and g + 8 and of B row (output channel) g. The hardware's K positions
// 4t..4t+3 take bytes 0..3 and 16+4t..16+4t+3 take bytes 4..7, for A and B
// alike, so the MMA sums the same products as the natural layout in another
// order; int32 sums are exact, so the order is free.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;  // rows of one MMA tile
// a row's scale is max(|x|, 1e-12) * f32(1/127): the reference divides by
// the constant 127, which XLA turns into this product
constexpr float kInv127 = 1.f / 127.f;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// act: 0 = quick_gelu, x * sigmoid(1.702 x); 1 = erf GELU.
__device__ __forceinline__ float activation(float h, int act) {
  if (act == 0) {
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h))));
    return __fmul_rn(h, sig);
  }
  return __fmul_rn(__fmul_rn(h, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(h, 0.70710678118654752f))));
}

// c[i][r][n] = sum_k A[r][k] * B[n][k] for the warp's kTiles 8-column tiles
// n0 + i * kWarps * 8 (tiles at or past N stay zero), with A int8 rows in
// shared memory (stride `as`, rows >= `rows` read as zero) and B int8 rows
// in device memory (stride K, mostly L2 hits). The B fragments of kBatch K
// steps of every tile are loaded before their MMAs, so that many loads are
// in flight per warp, and the tiles' independent MMA chains share each A
// fragment.
constexpr int kTiles = 2;
constexpr int kBatch = 8;

__device__ __forceinline__ void mma_tiles(int (&c)[kTiles][4], const int8_t* A, int as,
                                          int rows, const int8_t* __restrict__ B, int K,
                                          int N, int n0, int g, int t) {
  const int8_t* brow[kTiles];
  bool live[kTiles];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int n = n0 + i * kWarps * 8;
    live[i] = n < N;  // warp-uniform
    brow[i] = B + (size_t)((live[i] ? n : n0) + g) * K + 8 * t;
    c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0;
  }
  const int8_t* a0 = A + g * as + 8 * t;
  const int8_t* a1 = A + (g + 8) * as + 8 * t;
  const bool hi_rows = g + 8 < rows;
  for (int kb = 0; kb < K; kb += 32 * kBatch) {
    uint2 bv[kTiles][kBatch];
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k0 = kb + 32 * j;  // K % 32 == 0: warp-uniform guard
        bv[i][j] = live[i] && k0 < K ? __ldg(reinterpret_cast<const uint2*>(brow[i] + k0))
                                     : make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k0 = kb + 32 * j;
      if (k0 < K) {
        const uint2 lo = *reinterpret_cast<const uint2*>(a0 + k0);
        const uint2 hi =
            hi_rows ? *reinterpret_cast<const uint2*>(a1 + k0) : make_uint2(0u, 0u);
        const unsigned a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int i = 0; i < kTiles; ++i) {
          const unsigned b[2] = {bv[i][j].x, bv[i][j].y};
          if (live[i]) mma_s8(c[i], a, b);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_int8_kernel(const T* __restrict__ x,                                   // [M, W]
                const int8_t* __restrict__ w1,                             // [H, W]
                const float* __restrict__ s1, const float* __restrict__ b1,  // [H]
                const int8_t* __restrict__ w2,                             // [W, H]
                const float* __restrict__ s2, const float* __restrict__ b2,  // [W]
                T* __restrict__ out,                                       // [M, W]
                int M, int W, int H, int rows, int xs, int hs, int hqs, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hbuf = reinterpret_cast<float*>(smem);               // [rows][hs] f32 h
  int8_t* hq = reinterpret_cast<int8_t*>(smem);               // [rows][hqs], in place
  int8_t* xq = reinterpret_cast<int8_t*>(hbuf + rows * hs);   // [rows][xs]
  __shared__ float sx[kMaxRows], sh[kMaxRows];
  __shared__ unsigned hmax[kMaxRows];

  const int m0 = blockIdx.x * rows;
  const int valid = min(rows, M - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // 1. quantize the x rows (one warp per row); rows past M are zeros
  for (int r = warp; r < rows; r += kWarps) {
    if (r < valid) {
      const T* xr = x + (size_t)(m0 + r) * W;
      float m = 0.f;
      for (int k = lane; k < W; k += 32) m = fmaxf(m, fabsf(mmrs::to_float(xr[k])));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float s = __fmul_rn(fmaxf(m, 1e-12f), kInv127);
      for (int k = lane; k < W; k += 32)
        xq[r * xs + k] = (int8_t)__float2int_rn(__fdiv_rn(mmrs::to_float(xr[k]), s));
      if (lane == 0) sx[r] = s;
    } else {
      for (int k = lane; k < W; k += 32) xq[r * xs + k] = 0;
      if (lane == 0) sx[r] = 0.f;
    }
    if (lane == 0) hmax[r] = 0u;
  }
  __syncthreads();

  // 2. h = act(acc * sx * s1 + b1) in f32, and each row's max |h|
  float mx_lo = 0.f, mx_hi = 0.f;  // rows g and g + 8
  for (int n0 = warp * 8; n0 < H; n0 += kTiles * kWarps * 8) {
    int c[kTiles][4];
    mma_tiles(c, xq, xs, rows, w1, W, H, n0, g, t);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int n = n0 + i * kWarps * 8 + 2 * t;
      if (n >= H) continue;  // warp-uniform: the tile is past H
      const float sa = s1[n], sb = s1[n + 1], ba = b1[n], bb = b1[n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half;
        if (r < rows) {
          const float h0 = activation(
              __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(c[i][2 * half]), sx[r]), sa), ba),
              act);
          const float h1 = activation(
              __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(c[i][2 * half + 1]), sx[r]), sb),
                        bb),
              act);
          *reinterpret_cast<float2*>(hbuf + r * hs + n) = make_float2(h0, h1);
          const float m = fmaxf(fabsf(h0), fabsf(h1));
          if (half == 0) mx_lo = fmaxf(mx_lo, m); else mx_hi = fmaxf(mx_hi, m);
        }
      }
    }
  }
  // the four lanes of a group hold the same rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  if (t == 0) {  // |h| >= 0: float order is the order of the bits
    atomicMax(&hmax[g], __float_as_uint(mx_lo));
    if (g + 8 < rows) atomicMax(&hmax[g + 8], __float_as_uint(mx_hi));
  }
  __syncthreads();
  if (threadIdx.x < rows)
    sh[threadIdx.x] = __fmul_rn(fmaxf(__uint_as_float(hmax[threadIdx.x]), 1e-12f), kInv127);
  __syncthreads();

  // 3. quantize h in place, chunk by chunk in flat order: a chunk is read
  // into registers before any of it is written, and the int8 row r, col n
  // lands at byte r * hqs + n, inside f32 element (r * hqs + n) / 4 <=
  // r * hs + n (hqs <= 4 * hs), which was read in this or an earlier chunk
  constexpr int kPer = 8;
  const int total = rows * hs;
  for (int base = 0; base < total; base += kThreads * kPer) {
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = base + j * kThreads + threadIdx.x;
      v[j] = e < total ? hbuf[e] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = base + j * kThreads + threadIdx.x;
      const int r = e / hs, n = e - r * hs;
      if (e < total && n < H) hq[r * hqs + n] = (int8_t)__float2int_rn(__fdiv_rn(v[j], sh[r]));
    }
    __syncthreads();
  }

  // 4. y = acc * sh * s2 + b2, written in x's dtype for the valid rows
  for (int n0 = warp * 8; n0 < W; n0 += kTiles * kWarps * 8) {
    int c[kTiles][4];
    mma_tiles(c, hq, hqs, rows, w2, H, W, n0, g, t);
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int n = n0 + i * kWarps * 8 + 2 * t;
      if (n >= W) continue;
      const float sa = s2[n], sb = s2[n + 1], ba = b2[n], bb = b2[n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half;
        if (r < valid) {
          T* o = out + (size_t)(m0 + r) * W + n;
          o[0] = mmrs::from_float<T>(
              __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(c[i][2 * half]), sh[r]), sa), ba));
          o[1] = mmrs::from_float<T>(__fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(c[i][2 * half + 1]), sh[r]), sb), bb));
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
           const void* s2, const void* b2, void* out, int M, int W, int H, int rows,
           int xs, int hs, int hqs, int smem, int act, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_int8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + rows - 1) / rows;
  mlp_int8_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out), M, W, H, rows, xs, hs, hqs, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = f32; act: 0 = quick_gelu, 1 = gelu. The caller
// (mmrs_tpu_torch/ops/mlp_int8.py) picks the row tile and the shared-memory
// strides with `mlp_tile` and checks: CUDA, contiguous, dtypes, shapes,
// W % 32 == 0, H % 32 == 0, rows in {8, 16}, hqs <= 4 * hs.
int mmrs_mlp_int8(const void* x, const void* w1, const void* s1, const void* b1,
                  const void* w2, const void* s2, const void* b2, void* out, int M, int W,
                  int H, int rows, int xs, int hs, int hqs, int smem, int dtype, int act,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows != 8 && rows != kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, out, M, W, H, rows, xs, hs, hqs,
                                 smem, act, s);
  if (dtype == 1)
    return launch<float>(x, w1, s1, b1, w2, s2, b2, out, M, W, H, rows, xs, hs, hqs, smem,
                         act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
