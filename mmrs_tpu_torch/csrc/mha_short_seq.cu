// Fused multi-head attention for short sequences, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels mmrs_tpu/ops/attention.py:_mha_pallas
// (body `_mha_kernel`) and _mha_pallas_bd (`_mha_bd_kernel`, the same math
// laid out block-diagonally for the TPU's matrix unit). q, k, v and the
// output are [B, T, W] with heads as column slices of width hd = W / heads
// and 1/sqrt(hd) already folded into q; there is no mask. Logits and the
// softmax are f32, the probabilities are rounded to the input type before
// the AV product (as `_mha_kernel` casts p to v's dtype), AV accumulates in
// f32 and the output is rounded to the input type.
//
// What bounds it on the H100: at the vision towers' T (50 for B/32, 257 for
// L/14, 577 for the 336-px L/14, 729 for SigLIP at 384 px) the products
// are 4 T^2 hd flops a head against 8 T hd bytes, so the bound is bytes
// below T ~ 600 and a generic
// implementation loses to the [B, H, T, T] logits' traffic and to head
// transposes in device memory. Every route here moves only the four
// [B, T, W] tensors: a block reads its head's column slice straight from
// [B, T, W] (each key row of a head is hd contiguous elements) and the
// scores never leave the chip.
//
// bf16, hd <= 128 (every shipped tower): `mha_mma_kernel`, on tensor
// cores. One block per (image, head, up to 128 query rows), up to 8 warps
// of 16 rows (ops/attention.py:mha_plan), each warp's Q fragments in
// registers; a warp whose rows all lie past T only helps stage the tiles; K and V tiles of 64 keys staged by
// cp.async into a double-buffered ring and read with ldmatrix (.trans for
// V); QK^T and PV on mma.sync m16n8k16 with f32 accumulators; the exact
// two-pass softmax of attention_mma.cuh (pass 1: running max and sum;
// pass 2: recomputed scores, p = exp(s - m) / l rounded to bf16 once, PV).
// Keys past T score -inf (a zero score would take probability mass); a
// head width that is not a multiple of 16 is zero-padded in shared memory.
// Shared memory does not grow with T (55 KB at hd 64 and 8 warps).
//
// f32 inputs (held to 1e-5) and bf16 with hd > 128: `mha_kernel`, exact
// f32 FMAs on CUDA cores (never TF32), one block per (image, head, 64
// rows). Keys stream through shared memory in tiles of 64 and heads in
// chunks of 64 dims, so shared memory is 68 KB whatever T and hd are: the
// same exact two-pass softmax (pass 1: running max and sum over the key
// tiles, in registers; pass 2, once per 64-dim chunk of the output: the
// logits again, p = exp(s - m) / l rounded to the input type once, P.V in
// f32 registers), each thread 16 logits or outputs of a 64 x 64 tile.

#include "attention_mma.cuh"
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

// The CUDA-core route's tiles: 64 query rows x 64 keys, 64 head dims at a
// time. Thread (rg, kg) = (tid / 16, tid % 16) owns rows rg + 16 i and keys
// kg + 16 j (i, j < 4) of the logits, and rows rg + 16 i by dims 4 kg ..
// 4 kg + 3 of the output: every operand is read as float4 along its
// contiguous axis (two float4 loads per 16 FMAs, no bank conflicts), and
// the tiles are staged row-major as they lie in device memory. Shared
// memory: the Q chunk, the K chunk, the V chunk ([row or key][dim]) and
// the probabilities [row][key], each [64][68] f32: 69,632 bytes whatever T
// and hd are.
constexpr int kFmaTile = 64;
constexpr int kFmaLd = kFmaTile + 4;
constexpr int kFmaSmem = 4 * kFmaTile * kFmaLd * 4;

// rows [r0, r0 + n) of a [*, W] input at the head's dims [dc, dc + 64) ->
// dst[row][dim] f32, zero past n rows and past hd
template <typename T>
__device__ __forceinline__ void stage_rows_f32(float* dst, const T* src, int r0, int n, int W,
                                               int dc, int hd) {
  for (int e = threadIdx.x; e < kFmaTile * kFmaTile; e += kThreads) {
    const int r = e / kFmaTile, d = e - r * kFmaTile;
    dst[r * kFmaLd + d] =
        (r < n && dc + d < hd) ? mmrs::to_float(src[(size_t)(r0 + r) * W + dc + d]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ out, int Tn, int W, int hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [64 rows][68]
  float* Ks = Qs + kFmaTile * kFmaLd;           // [64 keys][68]
  float* Vs = Ks + kFmaTile * kFmaLd;           // [64 keys][68]
  float* Ps = Vs + kFmaTile * kFmaLd;           // [64 rows][68]: keys

  const int q0 = blockIdx.x * kFmaTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(kFmaTile, Tn - q0);
  const size_t img = (size_t)b * Tn * W + (size_t)h * hd;
  const T* qh = q + img;
  const T* kh = k + img;
  const T* vh = v + img;
  const int rg = threadIdx.x >> 4, kg = threadIdx.x & 15;
  const int ntiles = (Tn + kFmaTile - 1) / kFmaTile;
  const int nd = (hd + kFmaTile - 1) / kFmaTile;   // 64-dim chunks of the head
  if (nd == 1) stage_rows_f32(Qs, qh, q0, rows, W, 0, hd);   // staged once

  // s[i][j]: the logit of row rg + 16 i and key k0 + kg + 16 j (-inf past
  // the tile's nk keys); with_v: the tile's V chunk `oc` is staged too
  float s[4][4];
  auto scores = [&](int k0, int nk, bool with_v, int oc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < nd; ++c) {
      __syncthreads();   // the previous chunk's (or tile's) tiles are consumed
      if (nd > 1) stage_rows_f32(Qs, qh, q0, rows, W, c * kFmaTile, hd);
      stage_rows_f32(Ks, kh, k0, nk, W, c * kFmaTile, hd);
      if (with_v && c == 0) stage_rows_f32(Vs, vh, k0, nk, W, oc * kFmaTile, hd);
      __syncthreads();
      const int dn = min(kFmaTile, hd - c * kFmaTile);
      for (int d = 0; d < dn; d += 4) {
        float4 qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = ld4(Qs + (rg + 16 * i) * kFmaLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = ld4(Ks + (kg + 16 * j) * kFmaLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kg + 16 * j >= nk)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
  };
  // a value of each row reduced over the 16 threads of its row group
  // (lanes 0-15 or 16-31 of a warp)
  auto row_max = [](float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
  };
  auto row_sum = [](float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  };

  // pass 1: each row's max and sum of exp(s - max), running over the key
  // tiles (every thread of a row group holds the same values)
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kFmaTile;
    scores(k0, min(kFmaTile, Tn - k0), false, 0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mt = row_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mt);
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - m_new);
      e = row_sum(e);
      l[i] = (m[i] == -INFINITY ? 0.f : l[i] * expf(m[i] - m_new)) + e;
      m[i] = m_new;
    }
  }

  // pass 2, for each 64-dim chunk of the output: the logits again, p =
  // exp(s - m) / l rounded to the input type once, then P.V in f32
  for (int oc = 0; oc < nd; ++oc) {
    float acc[4][4] = {};
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * kFmaTile, nk = min(kFmaTile, Tn - k0);
      scores(k0, nk, true, oc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(rg + 16 * i) * kFmaLd + kg + 16 * j] =
              kg + 16 * j < nk
                  ? mmrs::to_float(mmrs::from_float<T>(expf(s[i][j] - m[i]) / l[i]))
                  : 0.f;
      __syncthreads();
      for (int j = 0; j < nk; j += 4) {   // keys past nk: p = 0, V zero-filled
        float4 pa[4], va[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = ld4(Ps + (rg + 16 * i) * kFmaLd + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) va[u] = ld4(Vs + (j + u) * kFmaLd + 4 * kg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p4[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i][0] = fmaf(p4[u], va[u].x, acc[i][0]);
            acc[i][1] = fmaf(p4[u], va[u].y, acc[i][1]);
            acc[i][2] = fmaf(p4[u], va[u].z, acc[i][2]);
            acc[i][3] = fmaf(p4[u], va[u].w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg + 16 * i;
      if (row >= rows) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = oc * kFmaTile + 4 * kg + c;
        if (d < hd) out[img + (size_t)(q0 + row) * W + d] = mmrs::from_float<T>(acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores. HDP: hd padded to 32, 64, 80 or 128 (80: SigLIP's
// heads of 72, ViT-H/14's of 80; its rows of 88 bf16, 176 bytes, keep
// ldmatrix's eight row addresses on distinct banks). VEC: 16-byte
// cp.async rows (hd % 8 == 0, W % 8 == 0, 16-byte aligned pointers); else
// element loads. Grid (ceil(T / rows), heads, B), rows = 16 * warps.
constexpr int kMmaThreads = 256;   // 8 warps at most

template <int HDP, bool VEC>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int nrows, int Tn, int W, int hd) {
  constexpr int LD = HDP + 8, CPR = HDP / 8;
  for (int e = threadIdx.x; e < nrows * CPR; e += blockDim.x) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    const int row = r0 + r;
    __nv_bfloat16* d = dst + r * LD + c;
    if constexpr (VEC) {
      const bool ok = row < Tn && c < hd;
      mmrs::cp_async<16>(d, ok ? src + (size_t)row * W + c : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (row < Tn && c + j < hd) ? src[(size_t)row * W + c + j] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int HDP, bool VEC>
__global__ void __launch_bounds__(kMmaThreads)
mha_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Tn,
               int W, int hd) {
  constexpr int LD = HDP + 8, KEYS = mmrs::kAttnKeys, NT = KEYS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = blockDim.x / 2;             // 16 per warp
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [rows][LD]
  __nv_bfloat16* ring = Qs + rows * LD;        // [2][K, V][KEYS][LD]

  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * Tn * W + (size_t)h * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (Tn + KEYS - 1) / KEYS;
  const bool single = ntiles == 1;             // T <= 64: one pass does both
  const int steps = single ? 1 : 2 * ntiles;
  const bool active = q0 + warp * 16 < Tn;     // warp-uniform

  // step st < ntiles: K tile st (pass 1); st >= ntiles: K and V tile
  // st - ntiles (pass 2); buffer st & 1. One tile: K and V in one step.
  auto prefetch = [&](int st) {
    const int kt = st < ntiles ? st : st - ntiles;
    __nv_bfloat16* buf = ring + (st & 1) * 2 * KEYS * LD;
    stage_rows<HDP, VEC>(buf, k + head, kt * KEYS, KEYS, Tn, W, hd);
    if (st >= ntiles || single)
      stage_rows<HDP, VEC>(buf + KEYS * LD, v + head, kt * KEYS, KEYS, Tn, W, hd);
  };
  stage_rows<HDP, VEC>(Qs, q + head, q0, rows, Tn, W, hd);
  prefetch(0);
  mmrs::cp_async_commit();

  uint32_t qa[HDP / 16][4];
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
    if (!active) {   // rows past T: stage tiles, compute nothing
      __syncthreads();
      continue;
    }
    if (st == 0) mmrs::q_fragments<HDP, LD>(qa, Qs, warp, lane);
    const __nv_bfloat16* Ks = ring + (st & 1) * 2 * KEYS * LD;
    const int k0 = (st < ntiles ? st : st - ntiles) * KEYS;
    const int live = Tn - k0;
    float s[NT][4];
    mmrs::scores_tile<HDP, LD>(s, qa, Ks, live, lane);
    if (live < KEYS) {   // the last tile: keys past T score -inf
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + 2 * t + (e & 1) >= live) s[nt][e] = -INFINITY;
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
    if (st >= ntiles || single) {   // p = e / sum, rounded to bf16 in pv_tile
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = mmrs::div_by(mmrs::exp_shift(s[nt][e], m[e >> 1]), l[e >> 1], inv_l[e >> 1]);
      mmrs::pv_tile<HDP, LD>(o, s, Ks + KEYS * LD, live, lane);
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + warp * 16 + g + 8 * half;
      if (row >= Tn) continue;
      __nv_bfloat16* dst = out + head + (size_t)row * W + col;
      if constexpr (VEC) {
        if (col < hd)
          *reinterpret_cast<uint32_t*>(dst) = mmrs::pack_bf16(o[nt][2 * half], o[nt][2 * half + 1]);
      } else {
        if (col < hd) dst[0] = __float2bfloat16_rn(o[nt][2 * half]);
        if (col + 1 < hd) dst[1] = __float2bfloat16_rn(o[nt][2 * half + 1]);
      }
    }
  }
}

template <int HDP, bool VEC>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Tn, int W,
               int heads, int warps, int smem, cudaStream_t stream) {
  auto kern = mha_mma_kernel<HDP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = 16 * warps;
  const dim3 grid((Tn + rows - 1) / rows, heads, B);
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Tn, W, W / heads);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int launch_mma_vec(int vec, const void* q, const void* k, const void* v, void* out, int B,
                   int Tn, int W, int heads, int warps, int smem, cudaStream_t s) {
  return vec ? launch_mma<HDP, true>(q, k, v, out, B, Tn, W, heads, warps, smem, s)
             : launch_mma<HDP, false>(q, k, v, out, B, Tn, W, heads, warps, smem, s);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Tn, int W,
           int heads, int smem, cudaStream_t stream) {
  if (smem != kFmaSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = W / heads;
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tn + kFmaTile - 1) / kFmaTile, heads, B);
  mha_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Tn, W, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The CUDA-core route. dtype: 0 = bf16, 1 = f32. The caller
// (mmrs_tpu_torch/ops/attention.py: _mha_cuda) takes the shared-memory size
// from `mha_plan` (kFmaSmem, checked here) and checks: CUDA, contiguous,
// q/k/v of one [B, T, W] shape and one dtype, W % heads == 0, 1 <= B <=
// 65535 (larger batches are sliced into launches), heads <= 65535.
int mmrs_mha_short_seq(const void* q, const void* k, const void* v, void* out, int B,
                       int Tn, int W, int heads, int dtype, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(q, k, v, out, B, Tn, W, heads, smem, s);
  if (dtype == 1) return launch<float>(q, k, v, out, B, Tn, W, heads, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 on tensor cores, hd = W / heads <= 128. The caller
// (mmrs_tpu_torch/ops/attention.py: _mha_cuda) picks warps (1-8: query rows
// per block / 16) and the shared-memory size with `mha_plan`, sets vec = 1
// when hd % 8 == 0, W % 8 == 0 and the pointers are 16-byte aligned, and
// checks the rest as above.
int mmrs_mha_short_seq_mma(const void* q, const void* k, const void* v, void* out, int B,
                           int Tn, int W, int heads, int vec, int warps, int smem,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = W / heads;
  if (warps < 1 || warps > kMmaThreads / 32) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 32) return launch_mma_vec<32>(vec, q, k, v, out, B, Tn, W, heads, warps, smem, s);
  if (hd <= 64) return launch_mma_vec<64>(vec, q, k, v, out, B, Tn, W, heads, warps, smem, s);
  if (hd <= 80) return launch_mma_vec<80>(vec, q, k, v, out, B, Tn, W, heads, warps, smem, s);
  if (hd <= 128) return launch_mma_vec<128>(vec, q, k, v, out, B, Tn, W, heads, warps, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
