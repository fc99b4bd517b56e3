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
// its cache prefix once. K11 gives one block to each (batch row, kv head):
// K rows are streamed warp by warp with a 32-lane dot product per key and
// query head, the [G, S] f32 logits stay in shared memory, and V is
// streamed once more for the [G, HD] output, each warp summing its own
// keys, the warps' partials added in a fixed order. K10 gives one block to
// each (batch row, kv head, 64 rows of the G * C row axis), 4 warps of 16
// rows, so a 64-row prefill chunk reads its head's prefix in one block:
// K and V tiles of 64 keys stream through a double-buffered cp.async ring
// (int8 tiles staged raw, half the bytes, and widened exactly to bf16 in
// shared memory), Q K^T and P V run on mma.sync m16n8k16 bf16 -> f32, and
// the softmax is attention_mma.cuh's exact two-pass form in registers:
// nothing in shared memory grows with S. Later work: split S across
// blocks where B * KVH underfills the 132 SMs (two-pass flash decoding),
// 16-byte K11 loads.

#include "attention_mma.cuh"
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
// the same shape; grid (ceil(G * C / rows), KVH, B), rows = 16 * warps.
constexpr int kChunkThreads = 128;
constexpr int kKeys = mmrs::kAttnKeys;

// Shared memory of chunk_kernel<T, HD> (ops/decode_attention.py:chunk_plan
// computes the same): the Q tile [64][HD + 8] bf16, the ring of two stages
// of K and V tiles [64][HD + 8] bf16 (int8: [64][HD] raw, plus the widened
// bf16 K and V tiles and two stages of K and V scales [64] f32).
template <typename T, int HD>
constexpr int chunk_smem_bytes() {
  constexpr int tile = kKeys * (HD + 8) * 2;
  return sizeof(T) == 2 ? 5 * tile : 3 * tile + 4 * kKeys * HD + 4 * kKeys * 4;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kChunkThreads)
chunk_kernel(const __nv_bfloat16* __restrict__ q, CacheView c, const int* __restrict__ pos,
             int pos0, int G, int C, float hd_scale, float* __restrict__ out) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int LD = HD + 8, NT = kKeys / 8, TILE = kKeys * LD;
  // the raw stage of one step: K then V, each [kKeys][HD] elements of T
  // (bf16: [kKeys][LD], read in place)
  constexpr int RAW = INT8 ? kKeys * HD : TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);       // [64][LD]
  __nv_bfloat16* wide = Qs + 64 * LD;                // int8: widened K, V [2][TILE]
  T* ring = reinterpret_cast<T*>(wide + (INT8 ? 2 * TILE : 0));         // [2][K, V][RAW]
  float* scl = reinterpret_cast<float*>(ring + 4 * RAW);               // [2][K, V][kKeys]

  const int h = blockIdx.y, b = blockIdx.z, kvh = gridDim.y;
  const int rows = blockDim.x / 2;   // 16 per warp
  const int R = G * C, r0 = blockIdx.x * rows;
  const int nrows = min(rows, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)b * kvh + h;
  const int p0 = pos ? pos[b] : pos0;

  // the tile's largest query position bounds the keys it reads
  const int rl = r0 + nrows - 1;
  const int cmax = (r0 / C != rl / C) ? C - 1 : rl % C;
  const int nk = min(c.s, p0 + cmax + 1);
  float* ob = out + head * R * HD;
  if (nk <= 0) {   // every key masked: the reference's softmax is NaN
    for (int e = threadIdx.x; e < nrows * HD; e += blockDim.x) ob[(size_t)r0 * HD + e] = NAN;
    return;
  }
  // this thread's two rows (g, g + 8 of its warp) and their query positions
  int qpos[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) qpos[hh] = p0 + (r0 + warp * 16 + g + 8 * hh) % C;
  // the keys this warp's live rows may attend: below `wlim` (warp-uniform;
  // 0 for a warp whose rows all lie past R, which only stages tiles)
  int wlim = 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (warp * 16 + g + 8 * hh < nrows) wlim = max(wlim, min(nk, qpos[hh] + 1));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wlim = max(wlim, __shfl_xor_sync(0xffffffffu, wlim, off));
  const bool active = warp * 16 < nrows;

  const T* K = static_cast<const T*>(c.k) + b * c.sb + h * c.sh;
  const T* V = static_cast<const T*>(c.v) + b * c.sb + h * c.sh;
  const float* ks = c.ks ? c.ks + b * c.ssb + h * c.ssh : nullptr;
  const float* vs = c.vs ? c.vs + b * c.ssb + h * c.ssh : nullptr;
  const int ntiles = (nk + kKeys - 1) / kKeys;
  const bool single = ntiles == 1;   // one tile: pass 2 reuses pass 1's scores
  const int steps = single ? 1 : 2 * ntiles;

  // keys k0 .. k0 + 63 of K or V into a stage (16-byte cp.async, zeros at
  // and past nk: those keys are never read) and their scales
  auto stage = [&](T* dst, float* sdst, const T* src, const float* ssrc, int k0) {
    constexpr int EPC = 16 / sizeof(T), CPR = HD / EPC;   // elements, chunks a row
    constexpr int STRIDE = INT8 ? HD : LD;
    for (int e = threadIdx.x; e < kKeys * CPR; e += blockDim.x) {
      const int r = e / CPR, d = (e - r * CPR) * EPC;
      const bool ok = k0 + r < nk;
      mmrs::cp_async<16>(dst + r * STRIDE + d, ok ? src + (size_t)(k0 + r) * HD + d : src, ok);
    }
    if (ssrc != nullptr) {
      for (int i = threadIdx.x; i < kKeys; i += blockDim.x) {
        const bool ok = k0 + i < nk;
        mmrs::cp_async<4>(sdst + i, ok ? ssrc + k0 + i : ssrc, ok);
      }
    }
  };
  // step st < ntiles: K tile st (pass 1); st >= ntiles: K and V tile
  // st - ntiles (pass 2); stage st & 1
  auto prefetch = [&](int st) {
    const int k0 = (st < ntiles ? st : st - ntiles) * kKeys;
    T* buf = ring + (st & 1) * 2 * RAW;
    float* sbuf = scl + (st & 1) * 2 * kKeys;
    stage(buf, sbuf, K, ks, k0);
    if (st >= ntiles || single) stage(buf + RAW, sbuf + kKeys, V, vs, k0);
  };

  {  // the Q tile; rows past R are zeros and are never stored
    const __nv_bfloat16* qb = q + (head * R + r0) * HD;
    for (int e = threadIdx.x; e < rows * (HD / 8); e += blockDim.x) {
      const int r = e / (HD / 8), d = (e - r * (HD / 8)) * 8;
      const bool ok = r < nrows;
      mmrs::cp_async<16>(Qs + r * LD + d, ok ? qb + (size_t)r * HD + d : qb, ok);
    }
  }
  prefetch(0);
  mmrs::cp_async_commit();

  uint32_t qa[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      prefetch(st + 1);
      mmrs::cp_async_commit();
      mmrs::cp_async_wait<1>();
    } else {
      mmrs::cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = st >= ntiles || single;   // P V in this step
    const T* buf = ring + (st & 1) * 2 * RAW;
    const float* sk = scl + (st & 1) * 2 * kKeys;
    const __nv_bfloat16* Kt;
    const __nv_bfloat16* Vt;
    if constexpr (INT8) {   // widen the raw tiles, 4 codes a thread at a time
      const int n = (pass2 ? 2 : 1) * kKeys * HD / 4;
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int which = e / (kKeys * HD / 4), x = e - which * (kKeys * HD / 4);
        const int r = x / (HD / 4), d = (x - r * (HD / 4)) * 4;
        const int w = *reinterpret_cast<const int*>(buf + which * RAW + r * HD + d);
        uint2 pk;
        pk.x = mmrs::pack_bf16((float)(int8_t)(w & 0xff), (float)(int8_t)((w >> 8) & 0xff));
        pk.y = mmrs::pack_bf16((float)(int8_t)((w >> 16) & 0xff), (float)(int8_t)(w >> 24));
        *reinterpret_cast<uint2*>(wide + which * TILE + r * LD + d) = pk;
      }
      __syncthreads();
      Kt = wide;
      Vt = wide + TILE;
    } else {
      Kt = reinterpret_cast<const __nv_bfloat16*>(buf);
      Vt = reinterpret_cast<const __nv_bfloat16*>(buf + RAW);
    }
    if (!active) {   // rows past R: stage (and widen) tiles, compute nothing
      __syncthreads();
      continue;
    }
    if (st == 0) mmrs::q_fragments<HD, LD>(qa, Qs, warp, lane);
    const int k0 = (st >= ntiles ? st - ntiles : st) * kKeys;
    const int live = wlim - k0;   // keys past it are masked for every row
    float s[NT][4];
    mmrs::scores_tile<HD, LD>(s, qa, Kt, live, lane);
    // logits = (q . k) [* k_scale] * hd_scale, then the causal mask
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * t + (e & 1), key = k0 + j;
        float x = s[nt][e];
        if (ks) x *= sk[j];
        x *= hd_scale;
        s[nt][e] = (key < nk && key <= qpos[e >> 1]) ? x : -INFINITY;
      }
    if (st < ntiles) {
      mmrs::running_stats(s, m, l);
      if (st == ntiles - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l[hh] = mmrs::quad_sum(l[hh]);
          inv_l[hh] = __frcp_rn(l[hh]);
        }
      }
    }
    if (pass2) {
      // p = e / sum [* v_scale] in f32 (a row with every key masked has
      // l = 0: 0 / 0 = NaN, the reference's answer)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = mmrs::div_by(mmrs::exp_shift(s[nt][e], m[e >> 1]), l[e >> 1], inv_l[e >> 1]);
          if (vs) p *= sk[kKeys + nt * 8 + 2 * t + (e & 1)];
          s[nt][e] = p;
        }
      mmrs::pv_tile<HD, LD>(o, s, Vt, live, lane);
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = warp * 16 + g + 8 * hh;
      if (row < nrows)
        *reinterpret_cast<float2*>(ob + (size_t)(r0 + row) * HD + col) =
            make_float2(o[nt][2 * hh], o[nt][2 * hh + 1]);
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
                 int B, int KVH, int G, int C, float hd_scale, int warps, int smem,
                 cudaStream_t stream) {
  if (warps < 1 || warps > 4 || smem != chunk_smem_bytes<T, HD>())
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = chunk_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 16 * warps;
  const dim3 grid((G * C + rows - 1) / rows, KVH, B);
  kern<<<grid, 32 * warps, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), c,
                                           static_cast<const int*>(pos), pos0, G, C, hd_scale,
                                           static_cast<float*>(out));
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

// As above, for q [B, KVH, G, C, HD]; warps (1-4: rows per block / 16) and
// smem (checked against chunk_smem_bytes) from `chunk_plan`.
int mmrs_chunk_attention(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* pos, int pos0, void* out, int B,
                         int KVH, int G, int C, int HD, int S, long long sb, long long sh,
                         long long ssb, long long ssh, int quant, float hd_scale, int warps,
                         int smem, void* stream) {
  const CacheView c = make_view(k, v, ks, vs, sb, sh, ssb, ssh, S);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant && HD == 128)
    return launch_chunk<int8_t, 128>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale, warps,
                                     smem, s);
  if (quant && HD == 64)
    return launch_chunk<int8_t, 64>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale, warps,
                                    smem, s);
  if (!quant && HD == 128)
    return launch_chunk<__nv_bfloat16, 128>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale,
                                            warps, smem, s);
  if (!quant && HD == 64)
    return launch_chunk<__nv_bfloat16, 64>(q, c, pos, pos0, out, B, KVH, G, C, hd_scale,
                                           warps, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
