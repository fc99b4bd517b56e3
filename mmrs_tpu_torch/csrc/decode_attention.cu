// Attention over the LLaMA KV cache, for Hopper (sm_90a): K10 chunk
// attention (T > 1 query rows a call) and K11 decode attention (T = 1).
//
// Replaces the Pallas TPU kernels of mmrs_tpu/ops/decode_attention.py:
// chunk_attention (body `_chunk_attn_kernel`) and decode_attention (body
// `_decode_attn_kernel`). Both read one layer's [B, KVH, S, hd] view of the
// stacked cache through its strides (the batch and head strides of the
// layer slice cache[li], with S cut to the caller's kv_limit: nothing is
// sliced out or copied), in bf16 or int8 with f32 per-position scales
// [B, KVH, S]. q is bf16; int8 K/V widen exactly to bf16; every product
// is summed in f32. Head dims: any hd % 8 == 0 up to 256 (K11: 1024) runs
// on the smallest compiled instance HDP in {64, 128, 256, 512, 1024} that
// holds it (ops/decode_attention.py pads a ragged hd to a multiple of 8,
// and runs K10's rows past 256 as K11 calls, one a query row); cache
// rows stay hd elements with stride hd (read as they are: the staged rows
// are zero past hd, nothing is read there, and no padded copy of the cache
// is made), the staged q is zero past hd, and only hd output dims are
// written. The arithmetic is the Pallas bodies', in their order:
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
// its cache prefix once. K11 splits each (batch row, kv head)'s keys
// across a thread-block cluster (up to 8 blocks, one launch): each block
// streams its span of K and V through a cp.async ring, and the softmax's
// max, sum and the P.V partials are exchanged through distributed shared
// memory, so a 32-head draft still fills the card and no block's shared
// memory grows with S past a fixed budget (any S runs). K10 gives one block to
// each (batch row, kv head, 64 rows of the G * C row axis), 4 warps of 16
// rows, so a 64-row prefill chunk reads its head's prefix in one block:
// K and V tiles of 64 keys stream through a double-buffered cp.async ring
// (int8 tiles staged raw, half the bytes, and widened exactly to bf16 in
// shared memory), Q K^T and P V run on mma.sync m16n8k16 bf16 -> f32, and
// the softmax is attention_mma.cuh's exact two-pass form in registers:
// nothing in shared memory grows with S.

#include "attention_mma.cuh"
#include "common.cuh"

#include <cooperative_groups.h>
#include <math.h>

namespace {

// One layer's view of the cache. Strides are in elements; a key row is
// hd contiguous elements and the scales' position stride is 1.
struct CacheView {
  const void* k;
  const void* v;
  const float* ks;  // [B, KVH, S] (int8 caches) or null (bf16)
  const float* vs;
  long long sb, sh;    // K/V strides of the batch row and the kv head
  long long ssb, ssh;  // the scales' strides of the batch row and the kv head
  int s;               // slots the call may read
};

// Rows [0, COUNT) of a staged tile of DST-byte rows, each padded to ROW
// bytes, from `src` rows of `src_row` bytes (src_row <= ROW, a multiple of
// 8; the cache row of the call's hd): 16-byte cp.async pieces, or 8-byte
// ones where src_row % 16 == 8 (int8 rows of hd % 16 == 8, 8-byte
// aligned). Bytes at and past src_row, and rows at and past n, are
// zero-filled and nothing is read there.
template <int COUNT, int ROW, int DST>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const unsigned char* src,
                                           int src_row, int n) {
  if (src_row % 16 == 0) {
    for (int e = threadIdx.x; e < COUNT * (ROW / 16); e += blockDim.x) {
      const int r = e / (ROW / 16), off = (e - r * (ROW / 16)) * 16;
      const bool ok = r < n && off < src_row;
      mmrs::cp_async<16>(dst + r * DST + off, ok ? src + (size_t)r * src_row + off : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < COUNT * (ROW / 8); e += blockDim.x) {
      const int r = e / (ROW / 8), off = (e - r * (ROW / 8)) * 8;
      const bool ok = r < n && off < src_row;
      mmrs::cp_async<8>(dst + r * DST + off, ok ? src + (size_t)r * src_row + off : src, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// K11: T = 1. q [B, KVH, G, hd] bf16, out [B, KVH, G, hd] f32; the
// instance HDP >= hd (the lanes and tiles below are HDP's).
//
// One cluster of `cs` blocks for each (kv head, batch row): grid (cs * KVH,
// B), cluster (cs, 1, 1), cs from the shapes alone (decode_plan in
// ops/decode_attention.py: enough blocks to fill the card in one launch,
// at most 8). Block rank r owns keys [r * span, (r + 1) * span) of the
// view, and only those below the row's frontier n = min(S, pos + 1): a
// block whose span lies past it loads nothing and contributes (max -inf,
// sum 0, output 0). Its keys stream as 16 KB tiles of rows through a ring
// of kDecStages stages (cp.async, int8 tiles raw, scales beside them):
// the K tiles, then the V tiles, so the V tiles are in flight while the
// softmax is exchanged. A key row is scored by a segment of LPR = min(32,
// HDP / 8) lanes, EPL = HDP / LPR elements a lane (8; 16 at HDP = 512, 32
// at 1024), a segmented shuffle sum (lanes past hd add exact zeros), so a
// warp scores 32 / LPR keys a step. HDP = 512 runs G <= 4 and HDP = 1024
// G <= 2 (the warps' [G, HDP] partials must fit the ring, and a lane's
// [G, EPL] q and accumulators its registers).
//
// The softmax is the reference's, exchanged through distributed shared
// memory: (1) each block's max, combined (exact in any order); (2) each
// block's sum of exp(x - m) under the row's global m, in f64, added in
// rank order and rounded once to f32 (the plain version's l, in any
// order); (3) p = e / l in f32, times the V scale, rounded to bf16 once;
// (4) the blocks' P.V partials [G, hd], added in rank order, each rank
// writing a slice of the output. The logits are summed in the order the
// plain version repeats, so the two round the same probabilities. When a
// span's [G, span] f32 logits fit the budget (`cached`), pass 1 keeps
// them in shared memory; otherwise K is streamed three times (max, sum,
// then K and V together) and nothing grows with S.
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecStages = 4;    // ring depth: tiles in flight
constexpr int kDecMaxCluster = 8;

// keys a staged tile: 16 KB of rows, at most 128 keys (64 bf16 rows of
// HDP = 128, 32 of 256, 8 of 1024; 128 rows otherwise)
template <typename T, int HDP>
__host__ __device__ constexpr int dec_keys() {
  return 16384 / (HDP * (int)sizeof(T)) < 128 ? 16384 / (HDP * (int)sizeof(T)) : 128;
}

template <typename T, int HDP>
__host__ __device__ constexpr int dec_stage_bytes() {
  return dec_keys<T, HDP>() * (HDP * (int)sizeof(T) + 4);
}

// Dynamic shared memory of decode_kernel<T, HDP, G> (decode_plan computes
// the same): the ring, the logits (cached: [G][span], else [G][keys]),
// the block reductions [warps][G] f64, the exchanged sum [G] f64 and max
// [G] f32.
template <typename T, int HDP, int G>
int decode_smem_bytes(int span, bool cached) {
  return kDecStages * dec_stage_bytes<T, HDP>() + 4 * G * (cached ? span : dec_keys<T, HDP>()) +
         8 * kDecWarps * G + 12 * G;
}

// eight consecutive elements of a staged row -> floats (exact)
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f) {
  if constexpr (sizeof(T) == 2) {
    mmrs::unpack8(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    mmrs::s8x4_to_float(w.x, f);
    mmrs::s8x4_to_float(w.y, f + 4);
  }
}

// K11's elements a lane of instance HDP: 8, or HDP / 32 past 256
template <int HDP>
__host__ __device__ constexpr int dec_lane_elems() {
  return HDP > 256 ? HDP / 32 : 8;
}

// per-g block reduction (max or sum) of one value per thread, in a fixed
// order: xor trees within warps, then warps in order; thread g < G
// writes the result for g to out[g]
template <int G, bool MAX, typename F>
__device__ __forceinline__ void block_reduce(const F (&x)[G], F* scratch, F* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    F v = x[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const F o = __shfl_xor_sync(0xffffffffu, v, off);
      v = MAX ? fmax(v, o) : v + o;
    }
    if (lane == 0) scratch[warp * G + g] = v;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    F v = scratch[threadIdx.x];
    for (int w = 1; w < kDecWarps; ++w)
      v = MAX ? fmax(v, scratch[w * G + threadIdx.x]) : v + scratch[w * G + threadIdx.x];
    out[threadIdx.x] = v;
  }
}

// three blocks an SM at G = 1 up to HDP = 512; at 1024 a lane's 32-wide q,
// accumulator and key row need more registers than that leaves
template <typename T, int HDP, int G>
__global__ void __launch_bounds__(kDecThreads, G == 1 && HDP <= 512 ? 3 : 1)
decode_kernel(const __nv_bfloat16* __restrict__ q, CacheView c, const int* __restrict__ pos,
              int pos0, int hd, float hd_scale, int span, int cached, float* __restrict__ out) {
  constexpr int EPL = dec_lane_elems<HDP>();   // elements a lane
  constexpr int LPR = HDP / EPL;          // lanes a key row
  constexpr int KPW = 32 / LPR;           // keys a warp step
  constexpr int TK = dec_keys<T, HDP>();  // keys a tile
  constexpr int ITERS = TK / (kDecWarps * KPW);
  constexpr int ROW = HDP * (int)sizeof(T);   // a staged row (zero past hd)
  constexpr int STAGE = dec_stage_bytes<T, HDP>();
  constexpr int NST = kDecStages;
  static_assert(ITERS >= 1 && TK % (kDecWarps * KPW) == 0, "tile shape");
  static_assert(NST * STAGE >= kDecWarps * G * HDP * 4, "the ring holds the warps' partials");
  const int grow = hd * (int)sizeof(T);   // a cache row's bytes
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                   // [NST][STAGE]
  float* L = reinterpret_cast<float*>(smem + NST * STAGE);      // logits / p
  const int lstride = cached ? span : TK;
  double* scratch = reinterpret_cast<double*>(L + G * lstride); // [warps][G]
  double* xl = scratch + kDecWarps * G;                         // [G] block sum
  float* xm = reinterpret_cast<float*>(xl + G);                 // [G] block max

  const int h = blockIdx.x / cs, b = blockIdx.y, kvh = gridDim.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane % LPR, kg = lane / LPR;
  const size_t head = (size_t)b * kvh + h;
  float* o = out + head * G * hd;
  const int n = min(c.s, (pos ? pos[b] : pos0) + 1);   // keys 0 .. pos
  if (n <= 0) {   // every key masked (the whole cluster): the reference gives NaN
    if (rank == 0)
      for (int e = threadIdx.x; e < G * hd; e += kDecThreads) o[e] = NAN;
    return;
  }
  const int lo = rank * span, hi = min(lo + span, n);
  const int nt = hi > lo ? (hi - lo + TK - 1) / TK : 0;   // live tiles
  const int total = cached ? 2 * nt : 4 * nt;                           // ring steps
  const unsigned char* K = static_cast<const unsigned char*>(c.k) + (b * c.sb + h * c.sh) * (long long)sizeof(T);
  const unsigned char* V = static_cast<const unsigned char*>(c.v) + (b * c.sb + h * c.sh) * (long long)sizeof(T);
  const float* ks = c.ks ? c.ks + b * c.ssb + h * c.ssh : nullptr;
  const float* vs = c.vs ? c.vs + b * c.ssb + h * c.ssh : nullptr;

  // step st -> (tile, V?): cached: K tiles, then V tiles; else K tiles
  // (max), K tiles (sum), then K, V of each tile (p, then P.V)
  auto step_of = [&](int st, int& tile, bool& isv) {
    if (st < nt) { tile = st; isv = false; }
    else if (cached) { tile = st - nt; isv = true; }
    else if (st < 2 * nt) { tile = st - nt; isv = false; }
    else { tile = (st - 2 * nt) >> 1; isv = (st - 2 * nt) & 1; }
  };
  // stage step st (zeros at and past hi: those keys are never read), and
  // commit a group even when there is nothing to stage
  auto issue = [&](int st) {
    if (st < total) {
      int tile; bool isv;
      step_of(st, tile, isv);
      const int k0 = lo + tile * TK;
      unsigned char* dst = ring + (st % NST) * STAGE;
      stage_rows<TK, ROW, ROW>(dst, (isv ? V : K) + (size_t)k0 * grow, grow, hi - k0);
      const float* sc = isv ? vs : ks;
      if (sc != nullptr) {
        float* sdst = reinterpret_cast<float*>(dst + TK * ROW);
        for (int i = threadIdx.x; i < TK; i += kDecThreads) {
          const bool ok = k0 + i < hi;
          mmrs::cp_async<4>(sdst + i, ok ? sc + k0 + i : sc, ok);
        }
      }
    }
    mmrs::cp_async_commit();
  };
  int st = 0;
  // wait for step st's stage (keeping NST - 1 later steps in flight)
  auto begin_step = [&]() -> const unsigned char* {
    issue(st + NST - 1);
    mmrs::cp_async_wait<NST - 1>();
    __syncthreads();
    return ring + (st % NST) * STAGE;
  };
  auto end_step = [&]() {
    __syncthreads();
    ++st;
  };

  float qr[G][EPL];   // this lane's EPL dims of each head's q, zero past hd
  {
    const __nv_bfloat16* qb = q + head * G * hd + seg * EPL;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int p = 0; p < EPL; p += 8) {
        if (seg * EPL + p < hd) {
          load8(qb + g * hd + p, qr[g] + p);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) qr[g][p + e] = 0.f;
        }
      }
  }
  // the logits x[g] of key jl of a staged K tile (all lanes of its
  // segment): each lane's 8 products in turn, then the lanes by halves,
  // the order the plain version repeats (ops/decode_attention.py:
  // _lane_logits; a bf16 product is exact in f32, so its bits match)
  auto score = [&](const unsigned char* buf, int jl, int key, float (&x)[G]) {
    float kf[EPL];
#pragma unroll
    for (int p = 0; p < EPL; p += 8)
      load8(reinterpret_cast<const T*>(buf + jl * ROW) + seg * EPL + p, kf + p);
    const float sk = ks ? reinterpret_cast<const float*>(buf + TK * ROW)[jl] : 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (ks) d *= sk;
      x[g] = key < hi ? d * hd_scale : -INFINITY;
    }
  };

  for (int i = 0; i < NST - 1; ++i) issue(i);

  // pass 1: the block's max (cached: the logits kept)
  float part[G];
#pragma unroll
  for (int g = 0; g < G; ++g) part[g] = -INFINITY;
  for (int t = 0; t < nt; ++t) {
    const unsigned char* buf = begin_step();
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int jl = (it * kDecWarps + warp) * KPW + kg;
      float x[G];
      score(buf, jl, lo + t * TK + jl, x);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] = fmaxf(part[g], x[g]);
        if (cached && seg == 0) L[g * lstride + t * TK + jl] = x[g];
      }
    }
    end_step();
  }
  block_reduce<G, true>(part, reinterpret_cast<float*>(scratch), xm);
  cluster.sync();
  float* mg = reinterpret_cast<float*>(scratch);   // [G] the row's max, then sum
  if (threadIdx.x < G) {
    float m = -INFINITY;
    for (int r = 0; r < cs; ++r) m = fmaxf(m, cluster.map_shared_rank(xm, r)[threadIdx.x]);
    mg[threadIdx.x] = m;
  }
  __syncthreads();
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = mg[g];
  __syncthreads();   // scratch is reused by the next reduction

  // pass 2: the block's sum of exp(x - m), in f64 (rounded once to f32
  // after the cluster's sum: the same l in any order, as plain's)
  double lsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) lsum[g] = 0.0;
  if (cached) {
    for (int j = threadIdx.x; j < hi - lo; j += kDecThreads)
#pragma unroll
      for (int g = 0; g < G; ++g) lsum[g] += expf(L[g * lstride + j] - m[g]);
  } else {
    for (int t = 0; t < nt; ++t) {
      const unsigned char* buf = begin_step();
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int jl = (it * kDecWarps + warp) * KPW + kg;
        const int key = lo + t * TK + jl;
        float x[G];
        score(buf, jl, key, x);
        if (seg == 0 && key < hi)
#pragma unroll
          for (int g = 0; g < G; ++g) lsum[g] += expf(x[g] - m[g]);
      }
      end_step();
    }
  }
  block_reduce<G, false>(lsum, scratch, xl);
  cluster.sync();
  if (threadIdx.x < G) {
    double l = 0.0;
    for (int r = 0; r < cs; ++r) l += cluster.map_shared_rank(xl, r)[threadIdx.x];
    mg[threadIdx.x] = __double2float_rn(l);
  }
  __syncthreads();
  float l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) l[g] = mg[g];

  // pass 3: p = e / l (f32) into L, then P.V; the V scale and the one
  // bf16 rounding are applied as each p is used
  if (cached) {
    for (int j = threadIdx.x; j < nt * TK; j += kDecThreads)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float* p = L + g * lstride + j;
        *p = __fdiv_rn(mmrs::exp_shift(*p, m[g]), l[g]);
      }
    __syncthreads();
  }
  float acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  for (int t = 0; t < nt; ++t) {
    if (!cached) {   // this tile's K: its probabilities into L [G][TK]
      const unsigned char* buf = begin_step();
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int jl = (it * kDecWarps + warp) * KPW + kg;
        float x[G];
        score(buf, jl, lo + t * TK + jl, x);
        if (seg == 0)
#pragma unroll
          for (int g = 0; g < G; ++g)
            L[g * lstride + jl] = __fdiv_rn(mmrs::exp_shift(x[g], m[g]), l[g]);
      }
      end_step();
    }
    const unsigned char* buf = begin_step();
    const float* pt = L + (cached ? t * TK : 0);
    const float* sv = reinterpret_cast<const float*>(buf + TK * ROW);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int jl = (it * kDecWarps + warp) * KPW + kg;
      float vf[EPL];
#pragma unroll
      for (int p = 0; p < EPL; p += 8)
        load8(reinterpret_cast<const T*>(buf + jl * ROW) + seg * EPL + p, vf + p);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float p = pt[g * lstride + jl];
        if (vs) p *= sv[jl];
        p = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    end_step();
  }
  mmrs::cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' partials [warps][G][HDP]
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float v = acc[g][e];
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (kg == 0) red[(warp * G + g) * HDP + seg * EPL + e] = v;
    }
  __syncthreads();
  for (int e = threadIdx.x; e < G * HDP; e += kDecThreads) {
    float s = red[e];
    for (int w = 1; w < kDecWarps; ++w) s += red[w * G * HDP + e];
    red[e] = s;
  }
  cluster.sync();
  // each rank writes a slice of the [G][hd] output (the dims past hd sum
  // staged zeros and are not written)
  const int per = (G * hd + cs - 1) / cs;
  for (int e = rank * per + threadIdx.x; e < min(G * hd, (rank + 1) * per); e += kDecThreads) {
    const int g = e / hd, x = g * HDP + (e - g * hd);
    float s = 0.f;
    for (int r = 0; r < cs; ++r) s += cluster.map_shared_rank(red, r)[x];
    o[e] = s;
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// K10: T = C > 1. q [B, KVH, G, C, hd] bf16 (the G * C rows of a kv head
// are one row axis r = g * C + c, query position pos[b] + c), out f32 of
// the same shape; grid (ceil(G * C / rows), KVH, B), rows = 16 * warps.
// The instance HDP >= hd: tiles are HDP wide, zero past hd.
constexpr int kChunkThreads = 128;
constexpr int kKeys = mmrs::kAttnKeys;

// Shared memory of chunk_kernel<T, HDP> (ops/decode_attention.py:chunk_plan
// computes the same): the Q tile [64][HDP + 8] bf16, the ring of two stages
// of K and V tiles [64][HDP + 8] bf16 (int8: [64][HDP] raw, plus the widened
// bf16 K and V tiles and two stages of K and V scales [64] f32).
template <typename T, int HDP>
constexpr int chunk_smem_bytes() {
  constexpr int tile = kKeys * (HDP + 8) * 2;
  return sizeof(T) == 2 ? 5 * tile : 3 * tile + 4 * kKeys * HDP + 4 * kKeys * 4;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kChunkThreads)
chunk_kernel(const __nv_bfloat16* __restrict__ q, CacheView c, const int* __restrict__ pos,
             int pos0, int G, int C, int hd, float hd_scale, float* __restrict__ out) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int LD = HDP + 8, NT = kKeys / 8, TILE = kKeys * LD;
  // the Q fragments stay in registers up to HDP = 128; at 256 they are
  // read from the Q tile at each k step, so that the [16, 256] f32 output
  // accumulators fit in registers beside the scores
  constexpr bool QREG = HDP <= 128;
  // the raw stage of one step: K then V, each [kKeys][HDP] elements of T
  // (bf16: [kKeys][LD], read in place)
  constexpr int RAW = INT8 ? kKeys * HDP : TILE;
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
  float* ob = out + head * R * hd;
  if (nk <= 0) {   // every key masked: the reference's softmax is NaN
    for (int e = threadIdx.x; e < nrows * hd; e += blockDim.x) ob[(size_t)r0 * hd + e] = NAN;
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
  const int grow = hd * (int)sizeof(T);   // a cache row's bytes

  // keys k0 .. k0 + 63 of K or V into a stage (zeros past hd, and at and
  // past nk: those keys are never read) and their scales
  auto stage = [&](T* dst, float* sdst, const T* src, const float* ssrc, int k0) {
    constexpr int STRIDE = INT8 ? HDP : LD;
    stage_rows<kKeys, HDP * (int)sizeof(T), STRIDE * (int)sizeof(T)>(
        reinterpret_cast<unsigned char*>(dst),
        reinterpret_cast<const unsigned char*>(src + (size_t)k0 * hd), grow, nk - k0);
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

  // the Q tile; zero past hd, and rows past R are zeros and are never
  // stored
  stage_rows<64, HDP * 2, LD * 2>(reinterpret_cast<unsigned char*>(Qs),
                                  reinterpret_cast<const unsigned char*>(q + (head * R + r0) * hd),
                                  hd * 2, nrows);
  prefetch(0);
  mmrs::cp_async_commit();

  uint32_t qa[QREG ? HDP / 16 : 1][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2];
  float o[HDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt)
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
      const int n = (pass2 ? 2 : 1) * kKeys * HDP / 4;
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int which = e / (kKeys * HDP / 4), x = e - which * (kKeys * HDP / 4);
        const int r = x / (HDP / 4), d = (x - r * (HDP / 4)) * 4;
        const int w = *reinterpret_cast<const int*>(buf + which * RAW + r * HDP + d);
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
    const int k0 = (st >= ntiles ? st - ntiles : st) * kKeys;
    const int live = wlim - k0;   // keys past it are masked for every row
    float s[NT][4];
    if constexpr (QREG) {
      if (st == 0) mmrs::q_fragments<HDP, LD>(qa, Qs, warp, lane);
      mmrs::scores_tile<HDP, LD>(s, qa, Kt, live, lane);
    } else {
      const __nv_bfloat16* qrow = Qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
      mmrs::scores_tile_by<HDP, LD>(
          s, [&](int kk, uint32_t (&a)[4]) { mmrs::ldmatrix_x4(a, qrow + kk * 16); }, Kt, live,
          lane);
    }
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
      mmrs::pv_tile<HDP, LD>(o, s, Vt, live, lane);
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col >= hd) break;   // hd % 8 == 0: the pair lies wholly inside or past it
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = warp * 16 + g + 8 * hh;
      if (row < nrows)
        *reinterpret_cast<float2*>(ob + (size_t)(r0 + row) * hd + col) =
            make_float2(o[nt][2 * hh], o[nt][2 * hh + 1]);
    }
  }
}

// the largest dynamic shared memory given to this instantiation, per
// device: the attribute is set once, not at every decode step
template <typename T, int HDP, int G>
int allow_smem(int smem) {
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(decode_kernel<T, HDP, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = smem;
  }
  return 0;
}

// blocks of decode_kernel<T, HDP, G> with `smem` bytes the card holds at once
template <typename T, int HDP, int G>
int decode_slots(int smem) {
  if (allow_smem<T, HDP, G>(smem) != 0) return -1;
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel<T, HDP, G>,
                                                    kDecThreads, smem) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

struct DecodeArgs {   // one K11 launch's arguments past the cache view
  const void* q;
  const void* pos;
  int pos0;
  void* out;
  int B, KVH, hd;
  float hd_scale;
  int cs, span, cached, smem;
};

template <typename T, int HDP, int G>
int launch_decode(const CacheView& c, const DecodeArgs& a, cudaStream_t stream) {
  constexpr int K = dec_keys<T, HDP>();
  if (a.cs < 1 || a.cs > kDecMaxCluster || a.span < K || a.span % K ||
      (long long)a.cs * a.span < c.s || (long long)(a.cs - 1) * a.span >= c.s ||
      a.smem != decode_smem_bytes<T, HDP, G>(a.span, a.cached != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decode_kernel<T, HDP, G>;
  const int set = allow_smem<T, HDP, G>(a.smem);
  if (set != 0) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cs * a.KVH, a.B, 1);
  cfg.blockDim = dim3(kDecThreads, 1, 1);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(a.q), c, static_cast<const int*>(a.pos),
      a.pos0, a.hd, a.hd_scale, a.span, a.cached, static_cast<float*>(a.out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDP>
int decode_by_group(int G, const CacheView& c, const DecodeArgs& a, cudaStream_t s) {
  switch (G) {
    case 1: return launch_decode<T, HDP, 1>(c, a, s);
    case 2: return launch_decode<T, HDP, 2>(c, a, s);
    case 4:
      if constexpr (HDP <= 512) return launch_decode<T, HDP, 4>(c, a, s);
      else return static_cast<int>(cudaErrorInvalidValue);
    case 8:
      if constexpr (HDP <= 256) return launch_decode<T, HDP, 8>(c, a, s);
      else return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HDP>
int launch_chunk(const void* q, const CacheView& c, const void* pos, int pos0, void* out,
                 int B, int KVH, int G, int C, int hd, float hd_scale, int warps, int smem,
                 cudaStream_t stream) {
  if (warps < 1 || warps > 4 || smem != chunk_smem_bytes<T, HDP>())
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = chunk_kernel<T, HDP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 16 * warps;
  const dim3 grid((G * C + rows - 1) / rows, KVH, B);
  kern<<<grid, 32 * warps, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), c,
                                           static_cast<const int*>(pos), pos0, G, C, hd,
                                           hd_scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

CacheView make_view(const void* k, const void* v, const void* ks, const void* vs, long long sb,
                    long long sh, long long ssb, long long ssh, int S) {
  return CacheView{k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                   sb, sh, ssb, ssh, S};
}

// The instance that runs head dim hd: the smallest of 64, 128, 256, 512,
// 1024 that holds it, for hd % 8 == 0 (cache rows in whole 8-byte pieces);
// 0 when there is none. 512 and 1024 are K11's only (K10's rows past 256
// run as K11 calls).
int padded_head_dim(int hd) {
  if (hd < 8 || hd % 8) return 0;
  return hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= 256 ? 256 : hd <= 512 ? 512
                                                            : hd <= 1024 ? 1024 : 0;
}

// f.run<T, HDP>() for the instance of (quant, hd); `none` when there is
// no instance.
template <typename F>
int by_instance(int quant, int hd, const F& f, int none) {
  switch (padded_head_dim(hd) * (quant ? -1 : 1)) {
    case 64: return f.template run<__nv_bfloat16, 64>();
    case 128: return f.template run<__nv_bfloat16, 128>();
    case 256: return f.template run<__nv_bfloat16, 256>();
    case 512: return f.template run<__nv_bfloat16, 512>();
    case 1024: return f.template run<__nv_bfloat16, 1024>();
    case -64: return f.template run<int8_t, 64>();
    case -128: return f.template run<int8_t, 128>();
    case -256: return f.template run<int8_t, 256>();
    case -512: return f.template run<int8_t, 512>();
    case -1024: return f.template run<int8_t, 1024>();
    default: return none;
  }
}

struct DecodeCall {
  const CacheView& c;
  const DecodeArgs& a;
  int G;
  cudaStream_t s;
  template <typename T, int HDP> int run() const { return decode_by_group<T, HDP>(G, c, a, s); }
};

struct SlotsCall {
  int G, smem;
  template <typename T, int HDP> int run() const {
    switch (G) {
      case 1: return decode_slots<T, HDP, 1>(smem);
      case 2: return decode_slots<T, HDP, 2>(smem);
      case 4:
        if constexpr (HDP <= 512) return decode_slots<T, HDP, 4>(smem);
        else return -1;
      case 8:
        if constexpr (HDP <= 256) return decode_slots<T, HDP, 8>(smem);
        else return -1;
      default: return -1;
    }
  }
};

struct ChunkCall {
  const void* q;
  const CacheView& c;
  const void* pos;
  int pos0;
  void* out;
  int B, KVH, G, C, hd;
  float hd_scale;
  int warps, smem;
  cudaStream_t s;
  template <typename T, int HDP> int run() const {
    if constexpr (HDP > 256) return static_cast<int>(cudaErrorInvalidValue);
    else
      return launch_chunk<T, HDP>(q, c, pos, pos0, out, B, KVH, G, C, hd, hd_scale, warps,
                                  smem, s);
  }
};

}  // namespace

extern "C" {

// quant: 1 = int8 K/V with f32 scales, 0 = bf16 K/V (ks/vs null). HD % 8
// == 0 and HD <= 1024 (run on the instance of padded_head_dim), G one of
// 1, 2, 4, 8 (1, 2, 4 past HD = 256; 1, 2 past 512); B and KVH <= 65535 (the caller
// slices larger grids into launches). pos holds one int32 position per batch row, or is null and
// every row is at pos0. The caller (mmrs_tpu_torch/ops/decode_attention.py:
// _decode_cuda) checks CUDA, the dtypes, the shapes, q/out contiguous and
// 16-byte aligned, K/V rows contiguous with 16-byte aligned batch and head
// strides, and takes the cluster size, the span, the cached flag and the
// shared-memory size from `decode_plan` (checked here against the
// kernel's own arithmetic).
int mmrs_decode_attention(const void* q, const void* k, const void* v, const void* ks,
                          const void* vs, const void* pos, int pos0, void* out, int B,
                          int KVH, int G, int HD, int S, long long sb, long long sh,
                          long long ssb, long long ssh, int quant, float hd_scale, int cs,
                          int span, int cached, int smem, void* stream) {
  const CacheView c = make_view(k, v, ks, vs, sb, sh, ssb, ssh, S);
  const DecodeArgs a{q, pos, pos0, out, B, KVH, HD, hd_scale, cs, span, cached, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_instance(quant, HD, DecodeCall{c, a, G, s},
                     static_cast<int>(cudaErrorInvalidValue));
}

// K11 blocks of one launch's kind (quant, the instance of HD, G) with
// `smem` bytes of shared memory that the current card holds at once (-1
// on an error): `decode_plan` sizes its clusters so that one launch fills
// the card.
int mmrs_decode_slots(int quant, int HD, int G, int smem) {
  return by_instance(quant, HD, SlotsCall{G, smem}, -1);
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
  return by_instance(quant, HD,
                     ChunkCall{q, c, pos, pos0, out, B, KVH, G, C, HD, hd_scale, warps, smem, s},
                     static_cast<int>(cudaErrorInvalidValue));
}

}  // extern "C"
