// Gallery top-k scans over int8 and int4 galleries, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels mmrs_tpu/ops/quant.py:_topk_quant_pallas
// (body `_kernel_q8`) and mmrs_tpu/ops/quant4.py:_topk_int4_pallas (body
// `_kernel_q4`). Queries are int8 codes [Q, D] with f32 row scales; the
// gallery is int8 rows [N, D] or packed int4 rows [N, D/2] (uint8), with
// f32 row scales. Dot products are exact int32 sums; the f32 epilogue is the
// reference's, operation by operation and with no contraction into FMAs, so
// the scores are bit-identical to the plain PyTorch versions
// (mmrs_tpu_torch/ops/quant.py, quant4.py) and to the JAX package's:
//   int8: (float)acc * q_scale * row_scale
//   int4: ((float)dlo - 8 * rs_q + (float)dhi / 16) * q_scale * row_scale
// (`_score_f32`: dlo is the low half's dot with codes offset by 8, rs_q the
// rowsum of the query's low half, dhi the high half's dot with 16x codes).
//
// The int4 layout is the port's own, row-major: byte j of a row holds dim j
// offset by 8 in its low nibble and dim D/2 + j (signed) in its high nibble.
// A 32-bit word w of a row gives four low-half dims as `w & 0x0F0F0F0F` and
// four high-half dims as `w & 0xF0F0F0F0` read as signed bytes (16x the
// code): exact s8 operands against the query codes of each half. The JAX
// package stores the same nibbles transposed as [D/8, N] words, a TPU
// sublane artefact.
//
// What bounds them on the H100: bytes. At Q <= 64 a query does at most 64
// multiply-adds per gallery byte, far below the card's int8 ridge, so the
// floor is one read of the gallery: 512 MiB (int8) or 256 MiB (int4) at
// N=2^20, D=512, i.e. 0.16 / 0.08 ms at 3.35 TB/s. Both are instances of
// span_scan.cuh, shared with the bf16 scan: spans of rows through a
// cp.async ring of 128-byte row slices into mma.sync m16n8k32 s8 against a
// tile of 8 queries (int8: the row bytes as the A fragment; int4: its two
// nibble planes by masking, as above), and a running threshold with a warp
// arg-max in place of a per-chunk sort.

#include "span_scan.cuh"

extern "C" {

// The int8 scan: partials [Q, ceil(N / span), k] for `mmrs_topk_merge`, span
// as for mmrs_topk_scan (a multiple of 256; 256 when k > kSelectMax). The
// callers (mmrs_tpu_torch/ops/quant.py, quant4.py) check: CUDA, contiguous,
// 16-byte aligned, dtypes, D % 16 == 0 (int8: a ragged D is padded with
// zero codes), D whose query planes fit (scan_stages; int4: D <= 2048
// as the IVF probes), 1 <= k <= 256 (the
// partial list length, min(k, 256) of the call), 1 <= Q <= 65535.
int mmrs_topk_scan_q8(const void* q, const void* q_scale, const void* g, const void* g_scale,
                      int Q, int N, int D, int k, int span, void* part_v, void* part_i,
                      void* stream) {
  return launch_span_scan<kRowS8>(q, q_scale, nullptr, g, g_scale, Q, N, D, k, span, part_v,
                                  part_i, static_cast<cudaStream_t>(stream));
}

// The int4 scan: as above, with the queries' low-half rowsums.
int mmrs_topk_scan_q4(const void* q, const void* q_scale, const void* q_rowsum,
                      const void* g, const void* g_scale, int Q, int N, int D, int k, int span,
                      void* part_v, void* part_i, void* stream) {
  return launch_span_scan<kRowS4>(q, q_scale, q_rowsum, g, g_scale, Q, N, D, k, span, part_v,
                                  part_i, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
