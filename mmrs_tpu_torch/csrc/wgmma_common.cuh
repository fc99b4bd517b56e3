// Hopper building blocks of the warpgroup tensor-core kernels (sm_90a):
// K6's s8 GEMM (mlp_int8.cu) and K9's bf16 first match (first_match.cu).
//
// Operand tiles are K-major rows of 128 bytes (128 int8 or 64 bf16 values
// of K; or of 64 bytes) in shared memory, in the swizzle of that width
// that wgmma reads: row r of a tile sits at byte r * ROW of it, and its
// 16-byte chunk c at chunk position c ^ (r % 8) (128 bytes) or
// c ^ ((r / 2) % 4) (64 bytes). Tiles start on 1024-byte boundaries, so
// the swizzle phase is the row's own. Every thread of the block copies its
// share of each tile with cp.async (16 bytes a copy, zero-filled where the
// row or the K chunk lies past the operand's end), into a ring of stages;
// the copies are made visible to wgmma (the async proxy) with
// fence.proxy.async before the barrier that publishes a stage.
//
// A stage is refilled only after a barrier that every warpgroup reaches
// once the products that read it are done (wgmma.wait_group).
//
// One wgmma m64nN reads 64 rows of A and N rows of B from such tiles and
// adds their product into N / 2 registers a thread, laid out as mma.sync's
// C fragments side by side: register 4j + 2h + e of thread (warp w of the
// warpgroup, lane l) is row 16w + l/4 + 8h, column 8j + 2(l%4) + e of the
// 64 x N product.
#pragma once

#include <stdint.h>

namespace mmrs {

constexpr int kRowBytes = 128;      // K bytes of one staged tile row
constexpr int kTileAlign = 1024;    // 8 rows: one swizzle period

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset of byte chunk `c` of row `r` in a swizzled tile of ROW-byte rows.
template <int ROW = kRowBytes>
__device__ __forceinline__ int swizzled(int r, int c) {
  static_assert(ROW == 128 || ROW == 64, "128- or 64-byte rows");
  return r * ROW + ((ROW == 128 ? c ^ (r & 7) : c ^ ((r >> 1) & 3)) << 4);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's cp.async writes, visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major tile of ROW-byte rows in the ROW-byte
// swizzle: start address, leading offset 16 bytes (unused by these
// layouts), 8 rows from one 8-row group to the next, the swizzle mode.
// Adding 2 moves it 32 bytes along K.
template <int ROW = kRowBytes>
__device__ __forceinline__ uint64_t sw_desc(uint32_t saddr) {
  static_assert(ROW == 128 || ROW == 64, "128- or 64-byte rows");
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * ROW / 16) << 32) | ((ROW == 128 ? 1ull : 2ull) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MMRS_WG_D64                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define MMRS_WG_D128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
#define MMRS_WG_8(c, d, i)                                                              \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])
#define MMRS_WG_64_AT(c, d, o)                                                      \
  MMRS_WG_8(c, d, o), MMRS_WG_8(c, d, o + 8), MMRS_WG_8(c, d, o + 16),                \
      MMRS_WG_8(c, d, o + 24), MMRS_WG_8(c, d, o + 32), MMRS_WG_8(c, d, o + 40),      \
      MMRS_WG_8(c, d, o + 48), MMRS_WG_8(c, d, o + 56)
#define MMRS_WG_64(c, d) MMRS_WG_64_AT(c, d, 0)

// d += A[64 x 32] . B[128 x 32]^T, int8 operands, exact int32 sums
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " MMRS_WG_D64
      ", %64, %65, p;\n}\n"
      : MMRS_WG_64("+r", d)
      : "l"(a), "l"(b), "r"(1));
}

// d += A[64 x 16] . B[256 x 16]^T, bf16 operands, f32 sums
__device__ __forceinline__ void wgmma_bf16_m64n256k16(float (&d)[128], uint64_t a,
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MMRS_WG_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MMRS_WG_64("+f", d), MMRS_WG_64_AT("+f", d, 64)
      : "l"(a), "l"(b), "r"(1));
}

#undef MMRS_WG_64
#undef MMRS_WG_64_AT
#undef MMRS_WG_8
#undef MMRS_WG_D128
#undef MMRS_WG_D64

}  // namespace mmrs
