"""Exact int8 products and dynamic per-row activation quantization.

Shared by the int8/int4 galleries (ops/quant.py, ops/quant4.py), the int8
tower layers (models/layers.py) and the plain version of the fused int8
MLP (ops/mlp_int8.py). These are the int8 products outside the port's
hand-written kernels: mmrs_tpu leaves them to XLA's int8 `dot_general`
with int32 accumulation; here they go to `torch._int_mm` (cuBLAS on the
GPU), whose int32 sums are exact, so the order of summation cannot change
a result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# XLA rewrites a division by a constant as a product with the constant's
# f32 reciprocal (x / 127 -> x * 0.00787401572), which rounds differently
# in a few percent of cases; the scales here take the same product so that
# they are bit-identical to the JAX package's. Divisions by a tensor stay
# true divisions in both.
INV_127 = 1.0 / 127.0


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times b [N, K] int8, transposed -> [M, N] int32.

    On the GPU `torch._int_mm` needs M > 16 and K, N multiples of 8; zero
    rows and columns are padded where a shape falls short and cut off
    after (zeros add nothing to an integer sum). Pass the larger operand
    as `a`: only `b` is copied when N is ragged."""
    m, kd = a.shape
    n = b.shape[0]
    if a.is_cuda:
        pad_m, pad_k, pad_n = max(17 - m, 0), -kd % 8, -n % 8
        if pad_m or pad_k:
            a = F.pad(a, (0, pad_k, 0, pad_m))
        if pad_k or pad_n:
            b = F.pad(b, (0, pad_k, 0, pad_n))
        return torch._int_mm(a, b.T)[:m, :n]
    return torch._int_mm(a, b.T)


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization (mmrs_tpu
    layers._quantize_act): s = max(|x|, 1e-12) / 127 per row of the last
    axis, codes round(x / s) half to even, no clip. Returns (int8 codes,
    f32 scales with a trailing axis of 1)."""
    x32 = x.float()
    sx = torch.clamp(x32.abs().amax(-1, keepdim=True), min=1e-12) * INV_127
    return torch.round(x32 / sx).to(torch.int8), sx


def int8_linear(xq: torch.Tensor, sx: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor, bias: Optional[torch.Tensor],
                out_dtype: torch.dtype) -> torch.Tensor:
    """(xq @ q.T) * sx * s + bias in f32, rounded once to `out_dtype`
    (mmrs_tpu layers._int8_matmul). xq [..., K] int8 with its row scales
    sx [..., 1]; q [N, K] int8 weights with per-output-channel scales s
    [N]; bias [N] f32 or None."""
    lead = xq.shape[:-1]
    acc = int_mm(xq.reshape(-1, xq.shape[-1]), q).reshape(*lead, -1)
    y = torch.mul(acc, sx) * s          # int32 -> f32 on the way in
    if bias is None:
        return y.to(out_dtype)
    # one pass: the f32 sum, rounded as it is stored
    return torch.add(y, bias, out=torch.empty_like(y, dtype=out_dtype))
