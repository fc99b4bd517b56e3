"""Fused int8 transformer MLP — Hopper CUDA kernel + plain PyTorch version.

Counterpart of mmrs_tpu/ops/mlp_int8.py: one int8 MLP block, quantize ->
int8 w1 -> bias, GELU -> quantize -> int8 w2 -> bias, for the int8 serving
tower. The kernel (`csrc/mlp_int8.cu`) keeps the f32 hidden activations in
shared memory; the plain version is `mlp_int8_reference`'s math in
PyTorch: per-row int8 activation quantization (half to even), exact int8
products, f32 rescale and bias, the activation in f32 (h is never rounded
to bf16), and the output rounded once to x's dtype.

Weights are in the port's [out, in] layout: w1_q [H, W], w2_q [W, H], with
per-output-channel f32 scales and biases.

`mlp_int8_fused(..., impl=)`: "auto" (the kernel for CUDA tensors, the
plain version for CPU tensors) or "torch" (the plain version anywhere).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mmrs_tpu_torch.ops import _cuda
from mmrs_tpu_torch.ops.int8 import int8_linear, quantize_act

SMEM_LIMIT = 232448     # shared memory one block may use on Hopper
_STATIC_SMEM = 256      # the kernel's static row scales and maxima
_ACT_CODE = {"quick_gelu": 0, "gelu": 1}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _activation(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    return F.gelu(h)


def _mlp_int8_torch(x, w1_q, s1, b1, w2_q, s2, b2, act: str) -> torch.Tensor:
    xq, sx = quantize_act(x)
    h = _activation(int8_linear(xq, sx, w1_q, s1, b1, torch.float32), act)
    hq, sh = quantize_act(h)
    return int8_linear(hq, sh, w2_q, s2, b2, x.dtype)


def mlp_tile(w: int, h: int) -> Tuple[int, int, int, int, int]:
    """(rows per block, x-code stride, f32 h stride, int8 h stride, dynamic
    shared-memory bytes) for the kernel. Strides are padded so the MMA
    operand loads and the f32 h stores hit distinct shared-memory banks;
    the int8 h row fits inside the f32 one (the kernel quantizes h in
    place). 16 rows (one MMA tile) where they fit, else 8."""
    xs = _round_up(w, 128) + 32
    hs = _round_up(h, 32) + 8
    hqs = _round_up(h, 128) + 32
    for rows in (16, 8):
        smem = rows * (4 * hs + xs)
        if smem + _STATIC_SMEM <= SMEM_LIMIT:
            return rows, xs, hs, hqs, smem
    raise ValueError(f"mlp_int8 kernel: W={w}, H={h} needs {smem} bytes of "
                     f"shared memory at 8 rows (limit {SMEM_LIMIT})")


def _mlp_int8_cuda(x, w1_q, s1, b1, w2_q, s2, b2, act: str) -> torch.Tensor:
    _cuda.require_cuda("mlp_int8", x, w1_q, s1, b1, w2_q, s2, b2)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"mlp_int8 kernel takes bf16 or f32 x, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"mlp_int8 takes x [M, W], got {tuple(x.shape)}")
    m, w = x.shape
    h = w1_q.shape[0]
    if (w1_q.shape != (h, w) or w2_q.shape != (w, h) or s1.shape != (h,)
            or b1.shape != (h,) or s2.shape != (w,) or b2.shape != (w,)):
        raise ValueError(
            f"mlp_int8: x [{m}, {w}] needs w1 [H, {w}], w2 [{w}, H] and "
            f"per-channel scales/biases, got w1 {tuple(w1_q.shape)}, w2 "
            f"{tuple(w2_q.shape)}")
    if w1_q.dtype != torch.int8 or w2_q.dtype != torch.int8 or any(
            t.dtype != torch.float32 for t in (s1, b1, s2, b2)):
        raise ValueError("mlp_int8 kernel takes int8 weights and f32 "
                         "scales and biases")
    if w % 32 or h % 32:
        raise ValueError(f"mlp_int8 kernel needs W % 32 == 0 and H % 32 == "
                         f"0 (32-wide MMA steps), got W={w}, H={h}")
    if not 1 <= m < 2 ** 31 // 16:
        raise ValueError(f"mlp_int8 kernel needs 1 <= M < 2^27, got M={m}")
    if w1_q.data_ptr() % 16 or w2_q.data_ptr() % 16:
        raise ValueError("mlp_int8 kernel needs 16-byte aligned weights")
    rows, xs, hs, hqs, smem = mlp_tile(w, h)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _cuda.check(_cuda.library().mmrs_mlp_int8(
            x.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2_q.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            m, w, h, rows, xs, hs, hqs, smem, _DTYPE_CODE[x.dtype],
            _ACT_CODE[act], _cuda.stream_of(x)), "mlp_int8")
    mlp_int8_fused.launches += 1
    return out


def mlp_int8_fused(
    x: torch.Tensor,       # [M, W] bf16/f32
    w1_q: torch.Tensor,    # [H, W] int8
    s1: torch.Tensor,      # [H] f32 per-output-channel scales
    b1: torch.Tensor,      # [H] f32
    w2_q: torch.Tensor,    # [W, H] int8
    s2: torch.Tensor,      # [W] f32
    b2: torch.Tensor,      # [W] f32
    act: str = "quick_gelu",
    impl: str = "auto",
) -> torch.Tensor:         # [M, W] in x.dtype
    """One transformer MLP block on int8 weights. On a CUDA tensor the
    kernel runs, or this raises: there is no fallback."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")
    if impl == "torch" or x.device.type == "cpu":
        return _mlp_int8_torch(x, w1_q, s1, b1, w2_q, s2, b2, act)
    return _mlp_int8_cuda(x, w1_q, s1, b1, w2_q, s2, b2, act)


mlp_int8_fused.launches = 0   # kernel launches, for showing the path ran it
