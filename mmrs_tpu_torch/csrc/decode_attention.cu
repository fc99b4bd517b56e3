// Attention over the LLaMA KV cache, for Hopper (sm_90a): K10 chunk
// attention (T > 1 query rows a call) and K11 decode attention (T = 1).
//
// Replaces the Pallas TPU kernels of mmrs_tpu/ops/decode_attention.py:
// chunk_attention (body `_chunk_attn_kernel`) and decode_attention (body
// `_decode_attn_kernel`). Both read one layer's [B, KVH, S, HD] view of the
// stacked cache through its strides (the batch and head strides of the
// layer slice cache[li], with S cut to the caller's kv_limit: nothing is
// sliced out or copied), in bf16 or int8 with f32 per-position scales
// [B, KVH, S]. q is bf16; int8 K/V widen exactly to bf16; every product
// is summed in f32. The arithmetic is the Pallas bodies', in their order:
//   logits = (q . k) [* k_scale] * hd_scale    (a product, not a division)
//   mask key_pos <= q_pos, f32 softmax: m = max, e = exp(l - m), p = e / sum
//   p [* v_scale] in f32, rounded to bf16, then p @ V with f32 sums.
// A masked key contributes an exact zero (exp(-inf) = 0), so neither kernel
// reads the keys past the last query's position at all: slots past a row's
// frontier (stale speculative drafts, zeros) are never touched.
//
// What bounds them on the H100: bytes. Decode reads the live cache once
// per step (at 7B, batch 8 and ~700 slots, ~92 MB of bf16 K/V per layer
// call against 0.4 MFLOP per key row); a prefill chunk of 64 rows reads
// its cache prefix once per 16-row tile. K11 gives one block to each
// (batch row, kv head): K rows are streamed warp by warp with a 32-lane
// dot product per key and query head, the [G, S] f32 logits stay in shared
// memory, and V is streamed once more for the [G, HD] output, each warp
// summing its own keys, the warps' partials added in a fixed order. K10
// gives one block to each (batch row, kv head, 16 query rows) and runs
// Q K^T and P V on mma.sync m16n8k16 bf16 -> f32 (exact products) over
// 64-key tiles staged in shared memory; its [16, S] f32 scores stay there
// too. Later work: split S across blocks where B * KVH underfills the 132
// SMs (two-pass flash decoding), 16-byte K11 loads, K10 K/V tiles loaded
// once for all query tiles of a head.

#include "common.cuh"

#include <math.h>

namespace {

// One layer's view of the cache. Strides are in elements; a key row is
// HD contiguous elements and the scales' position stride is 1.
struct CacheView {
  const void* k;
  const void* v;
  const float* ks;  // [B, KVH, S] (int8 caches) or null (bf16)
  const float* vs;
  long long sb, sh;    // K/V strides of the batch row and the kv head
  long long ssb, ssh;  // the scales' strides of the batch row and the kv head
  int s;               // slots the call may read
};

// EPL consecutive elements of a row -> floats (one 4- or 8-byte load)
template <typename T, int EPL>
__device__ __forceinline__ void load_lane(const T* p, float (&f)[EPL]) {
  if constexpr (sizeof(T) == 2 && EPL == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    f[0] = mmrs::bf16_lo(w.x); f[1] = mmrs::bf16_hi(w.x);
    f[2] = mmrs::bf16_lo(w.y); f[3] = mmrs::bf16_hi(w.y);
  } else if constexpr (sizeof(T) == 2 && EPL == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    f[0] = mmrs::bf16_lo(w); f[1] = mmrs::bf16_hi(w);
  } else if constexpr (sizeof(T) == 1 && EPL == 4) {
    const int w = *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
  } else {
    static_assert(sizeof(T) == 1 && EPL == 2, "unsupported row load");
    const short w = *reinterpret_cast<const short*>(p);
    f[0] = static_cast<float>(static_cast<int8_t>(w & 0xff));
    f[1] = static_cast<float>(static_cast<int8_t>(w >> 8));
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// softmax over row[0, n) in place, by one warp: p = e / sum, then the V
// scale of keys below nv in f32 (the others are masked: p = 0), then the
// one rounding to bf16 (kept as a float)
__device__ __forceinline__ void softmax_row(float* row, int n, const float* vs, int nv,
                                            int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(row[j] - m);
    row[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += 32) {
    float p = row[j] / sum;
    if (vs && j < nv) p *= vs[j];
    row[j] = __bfloat162float(__float2bfloat16_rn(p));
  }
}

// ---------------------------------------------------------------------------
// K11: T = 1. q [B, KVH, G, HD] bf16, out [B, KVH, G, HD] f32; grid (KVH, B).
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q, CacheView c, const int* __restrict__ pos,
              int pos0, float hd_scale, float* __restrict__ out) {
  constexpr int EPL = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* L = smem;              // [G][S] logits, then bf16-rounded probabilities
  float* red = L + G * c.s;     // [warps][G][HD] partial outputs
  const int h = blockIdx.x, b = blockIdx.y, kvh = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = (size_t)b * kvh + h;
  float* o = out + head * G * HD;
  const int n = min(c.s, (pos ? pos[b] : pos0) + 1);   // keys 0 .. pos
  if (n <= 0) {   // every key masked: the reference's softmax is NaN
    for (int e = threadIdx.x; e < G * HD; e += kDecThreads) o[e] = NAN;
    return;
  }
  const T* K = static_cast<const T*>(c.k) + b * c.sb + h * c.sh + lane * EPL;
  const T* V = static_cast<const T*>(c.v) + b * c.sb + h * c.sh + lane * EPL;
  const float* ks = c.ks ? c.ks + b * c.ssb + h * c.ssh : nullptr;
  const float* vs = c.vs ? c.vs + b * c.ssb + h * c.ssh : nullptr;

  float qr[G][EPL];
  const __nv_bfloat16* qb = q + head * G * HD + lane * EPL;
#pragma unroll
  for (int g = 0; g < G; ++g) load_lane<__nv_bfloat16, EPL>(qb + g * HD, qr[g]);

  for (int j = warp; j < n; j += kDecWarps) {
    float kr[EPL];
    load_lane<T, EPL>(K + (size_t)j * HD, kr);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kr[e], d);
      d = warp_sum(d);
      if (lane == 0) {
        if (ks) d *= ks[j];
        L[g * c.s + j] = d * hd_scale;
      }
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += kDecWarps) softmax_row(L + g * c.s, n, vs, n, lane);
  __syncthreads();

  float acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  for (int j = warp; j < n; j += kDecWarps) {
    float vr[EPL];
    load_lane<T, EPL>(V + (size_t)j * HD, vr);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = L[g * c.s + j];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[e], acc[g][e]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) red[(warp * G + g) * HD + lane * EPL + e] = acc[g][e];
  __syncthreads();
  for (int e = threadIdx.x; e < G * HD; e += kDecThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) s += red[w * G * HD + e];
    o[e] = s;
  }
}

// ---------------------------------------------------------------------------
// K10: T = C > 1. q [B, KVH, G, C, HD] bf16 (the G * C rows of a kv head
// are one row axis r = g * C + c, query position pos[b] + c), out f32 of
// the same shape; grid (ceil(G * C / 16), KVH, B).
constexpr int kChunkThreads = 128;
constexpr int kRows = 16;     // query rows per block: one mma M tile
constexpr int kKeys = 64;     // keys per staged K / V tile: 16 per warp

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

// two bf16 values -> one mma operand word, the first in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// eight elements of a row -> eight bf16 (int8 widens exactly)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 load8(const int8_t* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t word = i < 2 ? w.x : w.y;
    const int sh = 16 * (i & 1);
    o[i] = pack2(__float2bfloat16_rn(static_cast<float>(static_cast<int8_t>(word >> sh))),
                 __float2bfloat16_rn(static_cast<float>(static_cast<int8_t>(word >> (sh + 8)))));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// keys k0 .. k0 + 63 of one head into a [64][HD + 8] bf16 tile; keys at
// or past the cache's end are zeros (masked anyway)
template <typename T, int HD>
__device__ __forceinline__ void stage_keys(__nv_bfloat16* tile, const T* src, int k0, int s) {
  constexpr int LD = HD + 8, VPR = HD / 8;
  for (int e = threadIdx.x; e < kKeys * VPR; e += kChunkThreads) {
    const int r = e / VPR, d = (e - r * VPR) * 8;
    const int key = k0 + r;
    const uint4 val = key < s ? load8(src + (size_t)key * HD + d) : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(tile + r * LD + d) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kChunkThreads)
chunk_kernel(const __nv_bfloat16* __restrict__ q, CacheView c, const int* __restrict__ pos,
             int pos0, int G, int C, float hd_scale, int s_pad, float* __restrict__ out) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [16][LD]
  __nv_bfloat16* KV = Qs + kRows * LD;                              // [64][LD]
  float* P = reinterpret_cast<float*>(KV + kKeys * LD);             // [16][s_pad]
  __shared__ int qpos[kRows];

  const int h = blockIdx.y, b = blockIdx.z, kvh = gridDim.y;
  const int R = G * C, r0 = blockIdx.x * kRows;
  const int rows = min(kRows, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)b * kvh + h;
  const int p0 = pos ? pos[b] : pos0;

  // the tile's largest query position bounds the keys it reads
  const int rl = r0 + rows - 1;
  const int cmax = (r0 / C != rl / C) ? C - 1 : rl % C;
  const int nk = min(c.s, p0 + cmax + 1);
  if (threadIdx.x < kRows) {
    const int r = r0 + threadIdx.x;
    qpos[threadIdx.x] = threadIdx.x < rows ? p0 + r % C : p0;
  }
  float* ob = out + head * R * HD;
  if (nk <= 0) {   // every key masked: the reference's softmax is NaN
    for (int e = threadIdx.x; e < rows * HD; e += kChunkThreads) ob[(size_t)r0 * HD + e] = NAN;
    return;
  }
  const __nv_bfloat16* qb = q + (head * R + r0) * HD;
  for (int e = threadIdx.x; e < kRows * (HD / 8); e += kChunkThreads) {
    const int r = e / (HD / 8), d = (e - r * (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + r * LD + d) =
        r < rows ? *reinterpret_cast<const uint4*>(qb + (size_t)r * HD + d)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* r = Qs + g * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld32(r);
    qa[kk][1] = ld32(r + 8 * LD);
    qa[kk][2] = ld32(r + 8);
    qa[kk][3] = ld32(r + 8 * LD + 8);
  }

  const T* K = static_cast<const T*>(c.k) + b * c.sb + h * c.sh;
  const T* V = static_cast<const T*>(c.v) + b * c.sb + h * c.sh;
  const float* ks = c.ks ? c.ks + b * c.ssb + h * c.ssh : nullptr;
  const float* vs = c.vs ? c.vs + b * c.ssb + h * c.ssh : nullptr;
  const int tiles = (nk + kKeys - 1) / kKeys;
  const int span = tiles * kKeys;   // <= s_pad

  // scores: warp w takes keys w * 16 .. + 15 of each tile (two n tiles)
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kKeys;
    stage_keys<T, HD>(KV, K, k0, c.s);
    __syncthreads();
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* r = KV + (warp * 16 + nt * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(r), ld32(r + 8)};
        mma_bf16(acc[nt], qa[kk], bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e >> 1) * 8;
        const int key = k0 + warp * 16 + nt * 8 + 2 * t + (e & 1);
        float l = acc[nt][e];
        if (ks && key < c.s) l *= ks[key];
        l *= hd_scale;
        P[row * s_pad + key] = (key < nk && key <= qpos[row]) ? l : -INFINITY;
      }
    __syncthreads();
  }
  for (int row = warp; row < kRows; row += kChunkThreads / 32)
    softmax_row(P + row * s_pad, span, vs, nk, lane);
  __syncthreads();

  // out: warp w takes output columns w * HD / 4 .. + HD / 4 - 1
  constexpr int NT = HD / 32;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kKeys;
    stage_keys<T, HD>(KV, V, k0, c.s);
    __syncthreads();
#pragma unroll
    for (int ks16 = 0; ks16 < kKeys; ks16 += 16) {
      const float* pr = P + g * s_pad + k0 + ks16 + 2 * t;
      const uint32_t pa[4] = {
          pack2(__float2bfloat16_rn(pr[0]), __float2bfloat16_rn(pr[1])),
          pack2(__float2bfloat16_rn(pr[8 * s_pad]), __float2bfloat16_rn(pr[8 * s_pad + 1])),
          pack2(__float2bfloat16_rn(pr[8]), __float2bfloat16_rn(pr[9])),
          pack2(__float2bfloat16_rn(pr[8 * s_pad + 8]), __float2bfloat16_rn(pr[8 * s_pad + 9]))};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = warp * (HD / 4) + nt * 8 + g;
        const __nv_bfloat16* v0 = KV + (ks16 + 2 * t) * LD + col;
        const uint32_t bf[2] = {pack2(v0[0], v0[LD]), pack2(v0[8 * LD], v0[9 * LD])};
        mma_bf16(acc[nt], pa, bf);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = warp * (HD / 4) + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = g + half * 8;
      if (row < rows) {
        float* o = ob + (size_t)(r0 + row) * HD + col;
        o[0] = acc[nt][2 * half];
        o[1] = acc[nt][2 * half + 1];
      }
    }
  }
}

template <typename T, int HD, int G>
int launch_decode(const void* q, const CacheView& c, const void* pos, int pos0, void* out,
                  int B, int KVH, float hd_scale, int smem, cudaStream_t stream) {
  auto kern = decode_kernel<T, HD, G>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(KVH, B), kDecThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), c, static_cast<const int*>(pos), pos0,
      hd_scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int decode_by_group(int G, const void* q, const CacheView& c, const void* pos, int pos0,
                    void* out, int B, int KVH, float hd_scale, int smem, cudaStream_t s) {
  switch (G) {
    case 1: return launch_decode<T, HD, 1>(q, c, pos, pos0, out, B, KVH, hd_scale, smem, s);
    case 2: return launch_decode<T, HD, 2>(q, c, pos, pos0, out, B, KVH, hd_scale, smem, s);
    case 4: return launch_decode<T, HD, 4>(q, c, pos, pos0, out, B, KVH, hd_scale, smem, s);
    case 8: return launch_decode<T, HD, 8>(q, c, pos, pos0, out, B, KVH, hd_scale, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HD>
int launch_chunk(const void* q, const CacheView& c, const void* pos, int pos0, void* out,
                 int B, int KVH, int G, int C, float hd_scale, int s_pad, int smem,
                 cudaStream_t stream) {
  auto kern = chunk_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((G * C + kRows - 1) / kRows, KVH, B);
  kern<<<grid, kChunkThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), c, static_cast<const int*>(pos), pos0, G, C,
      hd_scale, s_pad, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

CacheView make_view(const void* k, const void* v, const void* ks, const void* vs, long long sb,
                    long long sh, long long ssb, long long ssh, int S) {
  return CacheView{k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                   sb, sh, ssb, ssh, S};
}

}  // namespace

extern "C" {

// quant: 1 = int8 K/V with f32 scales, 0 = bf16 K/V (ks/vs null). HD is 64
// or 128 and G one of 1, 2, 4, 8. pos holds one int32 position per batch
// row, or is null and every row is at pos0. The caller
// (mmrs_tpu_torch/ops/decode_attention.py: _decode_cuda) checks CUDA, the
// dtypes, the shapes, q/out contiguous, K/V rows contiguous with 16-byte
// aligned strides, and picks the shared-memory size with `decode_smem`.
int mmrs_decode_attention(const void* q, const void* k, const void* v, const void* ks,
                          const void* vs, const void* pos, int pos0, void* out, int B,
                          int KVH, int G, int HD, int S, long long sb, long long sh,
                          long long ssb, long long ssh, int quant, float hd_scale, int smem,
                          void* stream) {
  const CacheView c = make_view(k, v, ks, vs, sb, sh, ssb, ssh, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant && HD == 128)
    return decode_by_group<int8_t, 128>(G, q, c, pos, pos0, out, B, KVH, hd_scale, smem, s);
  if (quant && HD == 64)
    return decode_by_group<int8_t, 64>(G, q, c, pos, pos0, out, B, KVH, hd_scale, smem, s);
  if (!quant && HD == 128)
    return decode_by_group<__nv_bfloat16, 128>(G, q, c, pos, pos0, out, B, KVH, hd_scale,
                                               smem, s);
  if (!quant && HD == 64)
    return decode_by_group<__nv_bfloat16, 64>(G, q, c, pos, pos0, out, B, KVH, hd_scale,
                                              smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above, for q [B, KVH, G, C, HD]; s_pad = S rounded up to 64 (the
// score rows' stride), smem from `chunk_smem`.
int mmrs_chunk_attention(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* pos, int pos0, void* out, int B,
                         int KVH, int G, int C, int HD, int S, long long sb, long long sh,
                         long long ssb, long long ssh, int quant, float hd_scale, int s_pad,
                         int smem, void* stream) {
  const CacheView c = make_view(k, v, ks, vs, sb, sh, ssb, ssh, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant && HD == 128)
    return launch_chunk<int8_t, 128>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale, s_pad,
                                     smem, s);
  if (quant && HD == 64)
    return launch_chunk<int8_t, 64>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale, s_pad,
                                    smem, s);
  if (!quant && HD == 128)
    return launch_chunk<__nv_bfloat16, 128>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale,
                                            s_pad, smem, s);
  if (!quant && HD == 64)
    return launch_chunk<__nv_bfloat16, 64>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale,
                                           s_pad, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
