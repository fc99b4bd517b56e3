"""Fused multi-head attention for short sequences — Hopper CUDA kernel +
plain PyTorch version.

Counterpart of mmrs_tpu/ops/attention.py. The vision towers' attention is
unmasked over short sequences (T = 50 for B/32, 257 for L/14, 577 for the
336-px L/14). The kernel (`csrc/mha_short_seq.cu`) reads each head's column
slice straight from the [B, T, W] projections and keeps the [T, T] logits
in shared memory; the plain version splits heads with views and runs the
same math in f32.

Math (both versions, as the Pallas `_mha_kernel`): q already carries
1/sqrt(hd); logits and softmax in f32; the probabilities are rounded to
v's dtype before the AV product, which accumulates in f32; the output is
in q's dtype.

`impl`: "auto" (the kernel for CUDA tensors, the plain version for CPU
tensors) or "torch" (the plain version anywhere).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mmrs_tpu_torch.ops import _cuda

SMEM_LIMIT = 232448   # shared memory one block may use on Hopper
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _mha_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
               ) -> torch.Tensor:
    b, t, w = q.shape
    hd = w // heads

    def split(x):                                 # [B, H, T, hd] f32
        return x.reshape(b, t, heads, hd).transpose(1, 2).float()

    logits = split(q) @ split(k).transpose(-1, -2)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = probs.float() @ split(v)
    return out.transpose(1, 2).reshape(b, t, w).to(q.dtype)


def mha_tile(t: int, hd: int, itemsize: int) -> Tuple[int, int]:
    """(query rows per block, dynamic shared-memory bytes) for the kernel:
    f32 logits [tq, T] and queries [tq, hd], plus K (rows padded by one
    32-bit word) and V [T, hd] in the input type. Tiles shrink until the
    block fits in Hopper's 227 KB."""
    tq = min(t, 64) if t <= 64 else 32
    while True:
        smem = 4 * tq * (t + hd) + itemsize * t * (2 * hd + 4 // itemsize)
        if smem <= SMEM_LIMIT:
            return tq, smem
        if tq <= 8:
            raise ValueError(
                f"mha_short_seq kernel: T={t}, hd={hd} needs {smem} bytes of "
                f"shared memory at the smallest tile (limit {SMEM_LIMIT})")
        tq //= 2


def _mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
              ) -> torch.Tensor:
    _cuda.require_cuda("mha_short_seq", q, k, v)
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"mha_short_seq takes q, k, v of one [B, T, W] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"mha_short_seq kernel takes bf16 or f32 (one "
                         f"type), got {q.dtype}, {k.dtype}, {v.dtype}")
    b, t, w = q.shape
    if heads < 1 or w % heads:
        raise ValueError(f"width {w} is not a multiple of heads={heads}")
    if not (1 <= b <= 65535 and heads <= 65535):
        raise ValueError(f"mha_short_seq kernel needs B <= 65535, got {b}")
    tq, smem = mha_tile(t, w // heads, q.element_size())
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _cuda.check(_cuda.library().mmrs_mha_short_seq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, w, heads, _DTYPE_CODE[q.dtype], tq, smem,
            _cuda.stream_of(q)), "mha_short_seq")
    mha_short_seq.launches += 1
    return out


def mha_short_seq(
    q: torch.Tensor,        # [B, T, W], scale already folded into q
    k: torch.Tensor,        # [B, T, W]
    v: torch.Tensor,        # [B, T, W]
    heads: int,
    impl: str = "auto",
) -> torch.Tensor:          # [B, T, W]
    """Fused MHA for short sequences; softmax in f32, no head transposes in
    device memory. On a CUDA tensor the kernel runs, or this raises."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or q.device.type == "cpu":
        return _mha_torch(q, k, v, heads)
    return _mha_cuda(q, k, v, heads)


mha_short_seq.launches = 0   # kernel launches, for showing the path ran it
