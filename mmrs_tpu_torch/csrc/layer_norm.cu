// E2: the towers' LayerNorm in one pass (mmrs_tpu_torch/ops/layer_norm.py):
// bf16 rows in, f32 statistics, bf16 rows out.
//
// Replaces the Pallas TPU kernel: none. The JAX package's `layer_norm`
// (mmrs_tpu/models/layers.py) is plain jnp, which XLA fuses into one pass;
// the port ran it as three PyTorch launches (the bf16 -> f32 copy,
// F.layer_norm in f32, the f32 -> bf16 copy), 20 bytes an element.
//
// The pass is bound by bytes: 2 read and 2 written an element (the gains
// and offsets, f32 or bf16 as the layer stores them, are read once a
// block and widened to f32 there). So each byte moves once. A warp takes
// a whole row and keeps it in registers as packed bf16 (16-byte loads, lane
// l holding vectors l, l + 32, ...; VPL vectors at most, zero past the
// row's end), so the row is read from device memory once for its three
// uses. The warps stride over the rows; the grid is what the card holds at
// once (`layer_norm_plan`). Each block stages the gains and offsets in
// shared memory once, widened to f32, as two planes of float4 (columns
// 8v..8v+3 and 8v+4..8v+7 of vector v), so a lane's reads of its 8
// columns fall in distinct banks.
//
// Arithmetic, the JAX reference's order, with f32 statistics:
//   mean = f32(sum(x) / W)
//   var  = f32(sum((x - mean)^2) / W)     (a second pass over the registers,
//                                          not E[x^2] - mean^2)
//   rstd = 1 / sqrt(var + eps)            f32, correctly rounded (__frsqrt_rn)
//   out  = bf16_rn(fma((x - mean) * rstd, gamma, beta))   f32, one rounding
// The sums are what an f32 sum would be without its rounding drift: a
// vector's 8 terms are added in f32 as a tree (bf16 values within 2^13 of
// each other add exactly), the vectors' sums in f64, then a butterfly over
// the warp in f64, which leaves every lane the same sum. So the mean is the
// f32 nearest the row's true mean even for rows far from zero mean, where
// a running f32 sum (or Welford's update) drifts by several f32 ulps of the
// mean; the f64 work is one conversion and one add a vector.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpl = 8;        // 16-byte vectors a lane: W <= 2048

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The sum of 8 values as a tree in f32.
__device__ __forceinline__ float tree8(const float* t) {
  return __fadd_rn(__fadd_rn(__fadd_rn(t[0], t[1]), __fadd_rn(t[2], t[3])),
                   __fadd_rn(__fadd_rn(t[4], t[5]), __fadd_rn(t[6], t[7])));
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 o = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&o);
}

template <int VPL, typename P>
__global__ void __launch_bounds__(kThreads)
    e2_layer_norm_kernel(const uint4* __restrict__ x, long long ldv,
                         const P* __restrict__ gamma, const P* __restrict__ beta,
                         uint4* __restrict__ out, long long rows, int vecs, float eps) {
  constexpr int kV = VPL * 32;
  __shared__ float4 g_lo[kV], g_hi[kV], b_lo[kV], b_hi[kV];
  for (int v = threadIdx.x; v < kV; v += kThreads) {
    float g[8], b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[j] = v < vecs ? mmrs::to_float(gamma[8 * v + j]) : 0.0f;
      b[j] = v < vecs ? mmrs::to_float(beta[8 * v + j]) : 0.0f;
    }
    g_lo[v] = make_float4(g[0], g[1], g[2], g[3]);
    g_hi[v] = make_float4(g[4], g[5], g[6], g[7]);
    b_lo[v] = make_float4(b[0], b[1], b[2], b[3]);
    b_hi[v] = make_float4(b[4], b[5], b[6], b[7]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const double width = static_cast<double>(vecs * 8);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32; r < rows;
       r += stride) {
    const uint4* row = x + r * ldv;
    uint4 v[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < vecs ? __ldcs(row + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      float f[8];
      mmrs::unpack8(v[i], f);
      s += static_cast<double>(tree8(f));     // zero past the row's end
    }
    const float mean = __double2float_rn(warp_sum(s) / width);
    double q = 0.0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + 32 * i < vecs) {
        float f[8], d2[8];
        mmrs::unpack8(v[i], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = __fsub_rn(f[j], mean);
          d2[j] = __fmul_rn(d, d);
        }
        q += static_cast<double>(tree8(d2));
      }
    }
    const float var = __double2float_rn(warp_sum(q) / width);
    const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
    uint4* dst = out + r * vecs;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < vecs) {
        float f[8];
        mmrs::unpack8(v[i], f);
        const float4 gl = g_lo[c], gh = g_hi[c], bl = b_lo[c], bh = b_hi[c];
        const float g[8] = {gl.x, gl.y, gl.z, gl.w, gh.x, gh.y, gh.z, gh.w};
        const float b[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          y[j] = __fmaf_rn(__fmul_rn(__fsub_rn(f[j], mean), rstd), g[j], b[j]);
        uint4 o;
        o.x = pack2(y[0], y[1]);
        o.y = pack2(y[2], y[3]);
        o.z = pack2(y[4], y[5]);
        o.w = pack2(y[6], y[7]);
        dst[c] = o;
      }
    }
  }
}

template <int VPL, typename P>
int slots() {
  int dev = 0, per_sm = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, e2_layer_norm_kernel<VPL, P>,
                                                    kThreads, 0) != cudaSuccess)
    return -1;
  return per_sm * sms;
}

template <int VPL, typename P>
int launch(const void* x, long long ldx, const void* gamma, const void* beta, void* out,
           long long rows, int width, float eps, int blocks, cudaStream_t s) {
  e2_layer_norm_kernel<VPL, P><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(x), ldx / 8, static_cast<const P*>(gamma),
      static_cast<const P*>(beta), static_cast<uint4*>(out), rows, width / 8, eps);
  return static_cast<int>(cudaGetLastError());
}

// The instance for rows of `width` (1..8 16-byte vectors a lane), or -1.
template <typename P>
int slots_for(int width) {
  switch ((width / 8 + 31) / 32) {
    case 1: return slots<1, P>();
    case 2: return slots<2, P>();
    case 3: return slots<3, P>();
    case 4: return slots<4, P>();
    case 5: return slots<5, P>();
    case 6: return slots<6, P>();
    case 7: return slots<7, P>();
    case 8: return slots<8, P>();
  }
  return -1;
}

template <typename P>
int launch_for(const void* x, long long ldx, const void* gamma, const void* beta, void* out,
               long long rows, int width, float eps, int blocks, cudaStream_t s) {
  switch ((width / 8 + 31) / 32) {
    case 1: return launch<1, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
    case 2: return launch<2, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
    case 3: return launch<3, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
    case 4: return launch<4, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
    case 5: return launch<5, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
    case 6: return launch<6, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
    case 7: return launch<7, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
    case 8: return launch<8, P>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Blocks of kThreads the card holds at once for the instance that runs
// rows of `width` with f32 (bf16_params 0) or bf16 (1) gains and offsets,
// or -1.
int mmrs_layer_norm_slots(int width, int bf16_params) {
  if (width < 8 || width % 8 || width > kMaxVpl * 32 * 8) return -1;
  return bf16_params ? slots_for<__nv_bfloat16>(width) : slots_for<float>(width);
}

// x bf16 rows [rows, width] at a row stride of `ldx` elements, gamma and
// beta [width] (f32, or bf16 where bf16_params), out bf16 [rows, width]
// contiguous, all on `device`, whose `stream` the launch takes. The caller
// (ops/layer_norm.py: _layer_norm_cuda) checks: CUDA, width % 8 == 0 and
// width <= 2048, ldx % 8 == 0, 16-byte aligned x and out, rows >= 1, and
// takes `blocks` from `layer_norm_plan`. `device` is made current for the
// launch where it is not, and the caller's device is restored.
int mmrs_layer_norm(const void* x, long long ldx, const void* gamma, const void* beta,
                    int bf16_params, void* out, long long rows, int width, float eps,
                    int blocks, int device, void* stream) {
  if (width < 8 || width % 8 || width > kMaxVpl * 32 * 8 || ldx < width || ldx % 8 ||
      rows < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err == cudaSuccess && caller != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      bf16_params
          ? launch_for<__nv_bfloat16>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s)
          : launch_for<float>(x, ldx, gamma, beta, out, rows, width, eps, blocks, s);
  if (caller != device) cudaSetDevice(caller);
  return rc;
}

}  // extern "C"
