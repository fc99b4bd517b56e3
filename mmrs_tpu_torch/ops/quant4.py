"""Int4 packed gallery top-k — Hopper CUDA kernel + plain PyTorch version.

Counterpart of mmrs_tpu/ops/quant4.py, the next rung of the residency
ladder: symmetric per-row int4 codes in [-7, 7], two dims per byte, a
quarter of the bf16 gallery's device memory (4x rows per card).

Layout (the port's own; it lives only in device memory): row-major
[N, D/2] uint8. Byte j of row i holds dim j offset by 8 in its low nibble
and dim D/2 + j, signed, in its high nibble. Masking gives the exact int8
operands of the two dots, as in the JAX package:

    byte & 0x0F == g_lo + 8            byte & 0xF0 (as int8) == 16 * g_hi
    q . g == (dot_lo - 8 * rowsum(q_lo)) + dot_hi / 16    (exact)

The JAX package stores the same nibbles transposed as [D/8, N] int32 words,
a TPU sublane artefact; the unpacked codes and the scales are bit-identical.
The f32 epilogue `_score_f32` is one expression for the kernel
(`csrc/quant_topk.cu`), the plain version and `similarities_int4`, so
scores are bit-identical across all three and the JAX package.

`cosine_topk_int4(..., impl=)`: "auto" (the kernel for CUDA tensors, the
plain version for CPU tensors) or "torch" (the plain version anywhere).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmrs_tpu_torch.ops import _cuda, topk
from mmrs_tpu_torch.ops.int8 import int_mm
from mmrs_tpu_torch.ops.quant import MAX_DIM, quantize_rows


def quantize_rows_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float -> ([N, D/2] uint8 packed rows, [N] f32 scales).

    D must be a multiple of 8 (serving dims 512/768 are). Codes are
    round(x / scale) half to even, clipped to +-7, scale = max|x| / 7."""
    n, d = x.shape
    if d % 8:
        raise ValueError(f"D={d} must be a multiple of 8 for int4 packing")
    x32 = x.float()
    # x * f32(1/7), as XLA computes x / 7 (see ops/int8.INV_127)
    scale = torch.clamp(x32.abs().amax(-1), min=1e-12) * (1.0 / 7.0)
    q = torch.clamp(torch.round(x32 / scale[:, None]), -7, 7).to(torch.int32)
    h = d // 2
    lo = (q[:, :h] + 8) & 0xF                 # 1..15
    hi = q[:, h:] & 0xF                       # signed nibble
    return (lo | (hi << 4)).to(torch.uint8), scale


def planes(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D/2] packed -> (g_lo + 8, 16 * g_hi), both int8 [N, D/2]: the
    exact operands of the two dots."""
    lo = (packed & 0x0F).view(torch.int8)
    hi = (packed & 0xF0).view(torch.int8)
    return lo, hi


def _score_f32(dlo, dhi, rs_q, q_scale, scales):
    """The shared f32 epilogue (mmrs_tpu ops/quant4._score_f32)."""
    s = (dlo.float() - 8.0 * rs_q) + dhi.float() * (1.0 / 16.0)
    return s * q_scale * scales


def prep_queries(queries: torch.Tensor):
    """Per-row int8 query codes and scales, and the rowsum of the low
    half's codes the offset correction needs. Queries must already be
    L2-normalized."""
    q_q, q_scale = quantize_rows(queries.float())
    h = q_q.shape[1] // 2
    rs_q = q_q[:, :h].sum(1, dtype=torch.int32).float()
    return q_q, q_scale, rs_q


def scores_int4(q_q, q_scale, rs_q, packed, scales) -> torch.Tensor:
    """Unscaled cosine approximations [Q, N] against a packed gallery."""
    lo, hi = planes(packed)
    h = lo.shape[1]
    dlo = int_mm(lo, q_q[:, :h].contiguous()).T
    dhi = int_mm(hi, q_q[:, h:].contiguous()).T
    return _score_f32(dlo, dhi, rs_q[:, None], q_scale[:, None],
                      scales[None, :])


def similarities_int4(queries: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """Unscaled [Q, N] cosine approximations against the packed gallery
    (SearchEngine.device_similarities for quantize="int4")."""
    return scores_int4(*prep_queries(queries), packed, scales)


def _check_kernel_inputs(q_q, q_scale, rs_q, packed, scales, k: int) -> None:
    _cuda.require_cuda("cosine_topk_int4", q_q, q_scale, rs_q, packed,
                       scales)
    if q_q.dim() != 2 or packed.dim() != 2:
        raise ValueError("cosine_topk_int4 takes queries [Q, D] and a packed "
                         "gallery [N, D/2]")
    (q, d), (n, dp) = q_q.shape, packed.shape
    if q_q.dtype != torch.int8 or packed.dtype != torch.uint8 or any(
            t.dtype != torch.float32 for t in (q_scale, rs_q, scales)):
        raise ValueError("cosine_topk_int4 kernel takes int8 query codes, a "
                         "uint8 packed gallery and f32 scales")
    if (2 * dp != d or q_scale.shape != (q,) or rs_q.shape != (q,)
            or scales.shape != (n,)):
        raise ValueError(f"cosine_topk_int4: queries [{q}, {d}], packed "
                         f"gallery [{n}, {dp}] and scales do not match")
    if d % 16 or d > MAX_DIM:
        raise ValueError(f"cosine_topk_int4 kernel needs D % 16 == 0 and "
                         f"D <= {MAX_DIM}, got D={d}")
    topk.check_scan_shapes("cosine_topk_int4", q, n, k)
    if q_q.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("cosine_topk_int4 kernel needs 16-byte aligned rows")


def _topk_int4_cuda(q_q, q_scale, rs_q, packed, scales, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(q_q, q_scale, rs_q, packed, scales, k)
    (q, d), n = q_q.shape, packed.shape[0]
    out = topk.scan_and_merge(
        q, n, k, q_q.device,
        lambda qt, pv, pi, stream: _cuda.library().mmrs_topk_scan_q4(
            q_q.data_ptr(), q_scale.data_ptr(), rs_q.data_ptr(),
            packed.data_ptr(), scales.data_ptr(), q, n, d, k, qt, pv, pi,
            stream),
        "cosine_topk_int4")
    cosine_topk_int4.launches += 1
    return out


def cosine_topk_int4(
    queries: torch.Tensor,   # [Q, D] float, L2-normalized
    packed: torch.Tensor,    # [N, D/2] uint8 (quantize_rows_int4)
    scales: torch.Tensor,    # [N] f32
    k: int = 10,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int4 packed gallery. Returns (values [Q, k] f32, ids
    [Q, k] int32), best first, equal scores lowest row first. On a CUDA
    tensor the kernel runs, or this raises."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    q_q, q_scale, rs_q = prep_queries(queries)
    if impl == "torch" or queries.device.type == "cpu":
        return topk.sorted_topk(
            scores_int4(q_q, q_scale, rs_q, packed, scales), k)
    return _topk_int4_cuda(q_q, q_scale, rs_q, packed, scales, k)


cosine_topk_int4.launches = 0   # kernel launches, for showing the path ran it
