// Int8 transformer MLP for Hopper (sm_90a), in four launches:
//   row-quantize x -> s8 GEMM with w1, * scales + bias, GELU / tanh GELU /
//   quick_gelu
//   (f32 h) -> row-quantize h -> s8 GEMM with w2, * scales + bias -> x's
//   dtype.
//
// Replaces the Pallas TPU kernel mmrs_tpu/ops/mlp_int8.py:mlp_int8_fused
// (body `_kernel`). x is [M, W] bf16 or f32; w1 is int8 [H, W] and w2 int8
// [W, H] in the port's [out, in] layout, so both operands of both products
// are K-major int8 rows; scales and biases are f32 per output channel.
// Numerics are the reference kernel's: per-row scale max(|v|, 1e-12) *
// f32(1/127), codes rint(v / scale) (half to even, a true division), exact
// int32 products, the epilogue (float)acc * s_row * s_col + b with no FMA
// contraction, and the hidden activations h kept in f32 until they are
// quantized: never rounded to bf16 (the JAX package's default XLA route
// does round them).
//
// What bounds it on the H100: at the ViT-B/32 serving batch (M = 224 * 50,
// W = 768, H = 3072) the two products are 105 G int8 operations, 53 us at
// the card's 1979 TOPS. The TPU kernel kept h in VMEM; here h at a useful
// row tile does not fit one SM (128 rows x 3072 x 4 B = 1.5 MB), so the
// MLP is split at h, which goes through device memory in f32, exact:
// h written and read (2 x 138 MB at B/32), the int8 codes of x and h
// (2 x 43 MB), x and the output (2 x 17 MB), about 0.12 ms at 3.35 TB/s.
// That round trip is this design's own floor.
//
// Design:
//   - s8_gemm_kernel: one block of two warpgroups per 128 x 128 output
//     tile. K steps of 128 bytes of both operands come through a 3-stage
//     cp.async ring in shared memory (wgmma_common.cuh), shared by both
//     warpgroups; each warpgroup runs wgmma m64n128k32 s8 -> s32 on its 64
//     rows, four products a stage. Every weight tile then feeds 128 rows.
//     Two blocks fit an SM (97 KB of shared memory each), so one block's
//     epilogue (the activation's expf and division dominate it) runs
//     under the other's products. Epilogue 1 writes f32 h with the
//     activation and each row's max |h| over the tile's 128 columns (one
//     slot per row and column tile, no atomics); epilogue 2 writes the
//     output in x's dtype. Rows past M are zero-filled on load and never
//     written; no row past M is read.
//   - row_quant_kernel: one warp per row takes the row's max |v| (for h,
//     from the GEMM's per-tile maxima, so h is read once), then writes the
//     codes (4 a lane, one 32-bit store) and the row scale.
//   - A cluster design that splits H across blocks and trades the row max
//     through distributed shared memory would avoid the h round trip; it
//     is later work (ROADMAP B.6b).

#include "common.cuh"
#include "wgmma_common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;              // two warpgroups
constexpr int kTileM = 128;                // rows of an output tile
constexpr int kTileN = 128;                // output columns: one wgmma n128
constexpr int kStages = 3;
constexpr int kTileBytes = kTileM * mmrs::kRowBytes;  // an A or a B tile
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes + mmrs::kTileAlign;  // + alignment slack
constexpr int kQuantRows = kThreads / 32;  // rows a row_quant block takes
// a row's scale is max(|v|, 1e-12) * f32(1/127): the reference divides by
// the constant 127, which XLA turns into this product
constexpr float kInv127 = 1.f / 127.f;

// act: 0 = quick_gelu, x * sigmoid(1.702 x); 1 = erf GELU; 2 = GELU's
// tanh approximation (F.gelu(h, approximate="tanh")'s roundings).
__device__ __forceinline__ float activation(float h, int act) {
  if (act == 0) {
    // 1 / v correctly rounded: the bits of the division the reference takes
    const float sig = __frcp_rn(__fadd_rn(1.f, expf(-__fmul_rn(1.702f, h))));
    return __fmul_rn(h, sig);
  }
  if (act == 2) return mmrs::gelu_tanh(h);
  return __fmul_rn(__fmul_rn(h, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(h, 0.70710678118654752f))));
}

// four consecutive values as floats; vector loads where the row allows
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_float4(mmrs::bf16_lo(v.x), mmrs::bf16_hi(v.x), mmrs::bf16_lo(v.y),
                       mmrs::bf16_hi(v.y));
  }
  return make_float4(mmrs::to_float(p[0]), mmrs::to_float(p[1]), mmrs::to_float(p[2]),
                     mmrs::to_float(p[3]));
}

__device__ __forceinline__ uint32_t code(float v, float s) {
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(__float2int_rn(__fdiv_rn(v, s)))));
}

// codes [M, K] int8 and scales [M] f32 of the rows of v [M, K] (K % 4 == 0);
// with `part`, each row's max |v| is the max of its `parts` partial maxima
// part[row * parts ...] and v is read once
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_quant_kernel(const T* __restrict__ v, const float* __restrict__ part, int parts,
                 int8_t* __restrict__ q, float* __restrict__ s, int M, int K) {
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* vr = v + (size_t)row * K;
  const bool vec = (reinterpret_cast<uintptr_t>(vr) & (4 * sizeof(T) - 1)) == 0;
  float m = 0.f;
  if (part) {
    for (int i = lane; i < parts; i += 32) m = fmaxf(m, part[(size_t)row * parts + i]);
  } else {
    for (int k = 4 * lane; k < K; k += 128) {
      const float4 f = load4(vr + k, vec);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(f.x), fabsf(f.y)), fmaxf(fabsf(f.z), fabsf(f.w))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = __fmul_rn(fmaxf(m, 1e-12f), kInv127);
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * K);  // K % 4 == 0
#pragma unroll 4
  for (int k = 4 * lane; k < K; k += 128) {
    const float4 f = load4(vr + k, vec);
    qr[k >> 2] = code(f.x, sc) | code(f.y, sc) << 8 | code(f.z, sc) << 16 | code(f.w, sc) << 24;
  }
  if (lane == 0) s[row] = sc;
}

// two neighbouring outputs, each rounded once to the output type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// out[r, n] = epi((float)(A[r] . B[n]) * sa[r] * sb[n] + bias[n]) for r < M,
// n < N: A [M, K] and B [N, K] int8 codes (K % 16 == 0, 16-byte aligned
// rows), epi = the activation (ACT, out f32, and rowmax[r * tiles + tile]
// = the max |out| of row r over the tile's columns) or the identity (out
// in T).
template <bool ACT, typename T>
__global__ void __launch_bounds__(kThreads, 2)
s8_gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ sa,
               const int8_t* __restrict__ B, const float* __restrict__ sb,
               const float* __restrict__ bias, T* __restrict__ out,
               float* __restrict__ rowmax, int M, int N, int K, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = mmrs::shared_u32(smem_raw);
  const uint32_t base = (raw + mmrs::kTileAlign - 1) & ~uint32_t(mmrs::kTileAlign - 1);

  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int kt_count = (K + mmrs::kRowBytes - 1) / mmrs::kRowBytes;

  // copies: 1024 chunks of 16 bytes a tile, four of A and four of B a thread
  auto load = [&](int kt) {
    const uint32_t sA = base + (kt % kStages) * kStageBytes, sB = sA + kTileBytes;
    const int k0 = kt * mmrs::kRowBytes;
#pragma unroll
    for (int i = 0; i < kTileM * 8 / kThreads; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, c = id & 7, k = k0 + 16 * c;
      const bool ka = k < K;
      const bool va = ka && m0 + r < M, vb = ka && n0 + r < N;
      mmrs::cp_async16(sA + mmrs::swizzled(r, c), A + (va ? (size_t)(m0 + r) * K + k : 0), va);
      mmrs::cp_async16(sB + mmrs::swizzled(r, c), B + (vb ? (size_t)(n0 + r) * K + k : 0), vb);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load(s);
    mmrs::cp_async_commit_group();
  }
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  mmrs::fence_regs(acc);

  const int wg = tid >> 7;
  for (int kt = 0; kt < kt_count; ++kt) {
    mmrs::cp_async_wait_group<kStages - 2>();  // this thread's copies of step kt landed
    mmrs::fence_proxy_async();
    __syncthreads();  // every copy of step kt landed; step kt - 1's products are done
    if (kt + kStages - 1 < kt_count) load(kt + kStages - 1);
    mmrs::cp_async_commit_group();
    const uint32_t sA = base + (kt % kStages) * kStageBytes;
    const uint64_t da = mmrs::sw_desc(sA + wg * 64 * mmrs::kRowBytes);
    const uint64_t db = mmrs::sw_desc(sA + kTileBytes);
    mmrs::wgmma_fence();
#pragma unroll
    for (int j = 0; j < mmrs::kRowBytes / 32; ++j)
      mmrs::wgmma_s8_m64n128k32(acc, da + 2 * j, db + 2 * j);
    mmrs::wgmma_commit();
    mmrs::wgmma_wait<0>();
    mmrs::fence_regs(acc);
  }
  mmrs::cp_async_wait_group<0>();

  // epilogue: register 4j + 2h + e is row (16 w + g + 8h), column 8j + 2t + e
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int rows[2];
  float s_row[2], mx[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = m0 + wg * 64 + warp * 16 + g + 8 * h;  // one row for 4 lanes
    s_row[h] = rows[h] < M ? sa[rows[h]] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;  // N even: n < N means n + 1 < N
    if (n >= N) continue;
    const float sc[2] = {sb[n], sb[n + 1]}, bi[2] = {bias[n], bias[n + 1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] >= M) continue;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        y[e] = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), s_row[h]), sc[e]),
            bi[e]);
        if (ACT) {
          y[e] = activation(y[e], act);
          mx[h] = fmaxf(mx[h], fabsf(y[e]));
        }
      }
      store2(out + (size_t)rows[h] * N + n, y[0], y[1]);
    }
  }
  if (ACT) {  // over each row's four lanes (t = 0..3); every lane shuffles
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (rows[h] < M && t == 0) rowmax[(size_t)rows[h] * gridDim.y + blockIdx.y] = m;
    }
  }
}

template <typename T>
int quantize(const T* v, const float* part, int parts, int8_t* q, float* s, int M, int K,
             cudaStream_t stream) {
  row_quant_kernel<T><<<(M + kQuantRows - 1) / kQuantRows, kThreads, 0, stream>>>(
      v, part, parts, q, s, M, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool ACT, typename T>
int gemm(const int8_t* A, const float* sa, const int8_t* B, const float* sb, const float* bias,
         T* out, float* rowmax, int M, int N, int K, int act, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      s8_gemm_kernel<ACT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  s8_gemm_kernel<ACT, T><<<grid, kThreads, kSmemBytes, stream>>>(A, sa, B, sb, bias, out,
                                                                 rowmax, M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int mlp(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
        const void* s2, const void* b2, void* out, void* xq, void* sx, void* h, void* hmax,
        void* hq, void* sh, int M, int W, int H, int act, int only, cudaStream_t stream) {
  const int parts = (H + kTileN - 1) / kTileN;  // hmax is [M, parts]
  int err = 0;
  if (only < 0 || only == 0)
    err = quantize(static_cast<const T*>(x), nullptr, 0, static_cast<int8_t*>(xq),
                   static_cast<float*>(sx), M, W, stream);
  if (err) return err;
  if (only < 0 || only == 1)
    err = gemm<true, float>(static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
                            static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
                            static_cast<const float*>(b1), static_cast<float*>(h),
                            static_cast<float*>(hmax), M, H, W, act, stream);
  if (err) return err;
  if (only < 0 || only == 2)
    err = quantize(static_cast<const float*>(h), static_cast<const float*>(hmax), parts,
                   static_cast<int8_t*>(hq), static_cast<float*>(sh), M, H, stream);
  if (err) return err;
  if (only < 0 || only == 3)
    err = gemm<false, T>(static_cast<const int8_t*>(hq), static_cast<const float*>(sh),
                         static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
                         static_cast<const float*>(b2), static_cast<T*>(out), nullptr, M, W,
                         H, act, stream);
  return err;
}

}  // namespace

extern "C" {

// Tile rows, tile columns, ring stages and dynamic shared memory of the
// GEMM, for the caller's plan (mmrs_tpu_torch/ops/mlp_int8.py: mlp_plan).
int mmrs_mlp_int8_geometry(int what) {
  const int v[4] = {kTileM, kTileN, kStages, kSmemBytes};
  return what >= 0 && what < 4 ? v[what] : -1;
}

// dtype: 0 = bf16, 1 = f32; act: 0 = quick_gelu, 1 = gelu, 2 = tanh GELU
// (H padded by the caller to a multiple of 32, with zero units). Scratch from
// the caller: xq int8 [M, W], sx f32 [M], h f32 [M, H], hmax f32 [M,
// ceil(H / 128)], hq int8 [M, H], sh f32 [M]. The caller
// (mmrs_tpu_torch/ops/mlp_int8.py) plans with `mlp_plan` and checks: CUDA,
// contiguous, dtypes, shapes, W % 32 == 0, H % 32 == 0, 16-byte aligned
// weights and scratch, 1 <= M, the grid. only: -1 runs the four launches;
// 0-3 runs that one alone (row-quantize x, x.w1, row-quantize h, h.w2), on
// the scratch a whole call left, for timing a launch by itself.
int mmrs_mlp_int8(const void* x, const void* w1, const void* s1, const void* b1,
                  const void* w2, const void* s2, const void* b2, void* out, void* xq,
                  void* sx, void* h, void* hmax, void* hq, void* sh, int M, int W, int H,
                  int dtype, int act, int only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || W % 32 || H % 32 || W < 32 || H < 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return mlp<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, out, xq, sx, h, hmax, hq, sh, M, W, H,
                              act, only, s);
  if (dtype == 1)
    return mlp<float>(x, w1, s1, b1, w2, s2, b2, out, xq, sx, h, hmax, hq, sh, M, W, H, act,
                      only, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
