"""Int8 gallery top-k — Hopper CUDA kernel + plain PyTorch version.

Counterpart of mmrs_tpu/ops/quant.py. Symmetric per-row int8 quantization
halves the gallery's device memory against bf16 (2x rows per card):

    scale[i] = max|g[i]| / 127,  g_q[i] = round(g[i] / scale[i]) in +-127
    score(q, i) = (q_q . g_q[i]) * q_scale * scale[i]

The dot products are exact int32 sums and the epilogue is the same f32
operations in the same order in the kernel (`csrc/quant_topk.cu`), the
plain version and the JAX package, so scores are bit-identical and ids
follow the tie rule of ops/topk.py (equal scores: lowest row first). Ties
are common here: rows with the same codes and scale score alike.

`cosine_topk_quantized(..., impl=)`: "auto" (the kernel for CUDA tensors,
the plain version for CPU tensors) or "torch" (the plain version anywhere).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmrs_tpu_torch.ops import _cuda, topk
from mmrs_tpu_torch.ops.int8 import int_mm, quantize_act

MAX_DIM = 2048   # staged query codes must fit the scan block's shared memory


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D] float -> ([N, D] int8 codes, [N] f32 scales); round half to
    even (mmrs_tpu ops/quant.quantize_rows). Its clip to +-127 cannot bind
    (|x| <= max|x| = 127 * scale up to one rounding), so this is the
    activation quantizer with the scales' trailing axis dropped."""
    q, scale = quantize_act(x)
    return q, scale[:, 0]


def scores_q8(q_q: torch.Tensor, q_scale: torch.Tensor,
              gallery_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Unscaled cosine approximations [Q, N]: acc * q_scale * row_scale in
    f32, the epilogue of `_topk_quant_xla`."""
    acc = int_mm(gallery_q, q_q).T
    return acc.float() * q_scale[:, None] * scales[None, :]


def _check_kernel_inputs(q_q, q_scale, gallery_q, scales, k: int) -> None:
    _cuda.require_cuda("cosine_topk_quantized", q_q, q_scale, gallery_q,
                       scales)
    if q_q.dim() != 2 or gallery_q.dim() != 2:
        raise ValueError("cosine_topk_quantized takes queries [Q, D] and "
                         "gallery [N, D]")
    (q, d), (n, dg) = q_q.shape, gallery_q.shape
    if (q_q.dtype, gallery_q.dtype) != (torch.int8, torch.int8) or (
            q_scale.dtype, scales.dtype) != (torch.float32, torch.float32):
        raise ValueError("cosine_topk_quantized kernel takes int8 codes and "
                         "f32 scales")
    if d != dg or q_scale.shape != (q,) or scales.shape != (n,):
        raise ValueError(f"cosine_topk_quantized: queries [{q}, {d}], "
                         f"gallery [{n}, {dg}], scales {tuple(q_scale.shape)}"
                         f" and {tuple(scales.shape)} do not match")
    if d % 16 or d > MAX_DIM:
        raise ValueError(f"cosine_topk_quantized kernel needs D % 16 == 0 "
                         f"and D <= {MAX_DIM}, got D={d}")
    topk.check_scan_shapes("cosine_topk_quantized", q, n, k)
    if q_q.data_ptr() % 16 or gallery_q.data_ptr() % 16:
        raise ValueError("cosine_topk_quantized kernel needs 16-byte "
                         "aligned rows")


def _topk_quant_cuda(q_q, q_scale, gallery_q, scales, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(q_q, q_scale, gallery_q, scales, k)
    (q, d), n = q_q.shape, gallery_q.shape[0]
    out = topk.scan_and_merge(
        q, n, k, q_q.device,
        lambda qt, pv, pi, stream: _cuda.library().mmrs_topk_scan_q8(
            q_q.data_ptr(), q_scale.data_ptr(), gallery_q.data_ptr(),
            scales.data_ptr(), q, n, d, k, qt, pv, pi, stream),
        "cosine_topk_quantized")
    cosine_topk_quantized.launches += 1
    return out


def cosine_topk_quantized(
    queries: torch.Tensor,     # [Q, D] float, L2-normalized
    gallery_q: torch.Tensor,   # [N, D] int8
    scales: torch.Tensor,      # [N] f32
    k: int = 10,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an int8 gallery: the queries are quantized per row, then
    scored with exact int8 products. Returns (values [Q, k] f32, ids [Q, k]
    int32), best first. On a CUDA tensor the kernel runs, or this raises."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    q_q, q_scale = quantize_rows(queries)
    if impl == "torch" or queries.device.type == "cpu":
        return topk.sorted_topk(scores_q8(q_q, q_scale, gallery_q, scales), k)
    return _topk_quant_cuda(q_q, q_scale, gallery_q, scales, k)


cosine_topk_quantized.launches = 0   # kernel launches (shows a path ran it)
