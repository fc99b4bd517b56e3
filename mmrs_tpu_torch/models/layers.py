"""Shared transformer building blocks for the CLIP towers.

Counterpart of mmrs_tpu/models/layers.py, restricted to what the CLIP
towers use. Numerics follow the JAX package:
  - matmuls take the compute dtype (bf16 by default); the products are
    summed in f32, the f32 bias is added to the f32 sums and the result
    is rounded once to the compute dtype;
  - int8 layers (`QLinear`, the int8 serving tower) quantize their input
    per row (round half to even), multiply int8 by int8 into exact int32
    sums, and rescale and add the bias in f32 before the one rounding;
  - LayerNorm runs in f32 regardless of the compute dtype;
  - unmasked (vision) attention is the fused short-sequence MHA
    (ops/attention.py: the CUDA kernel on a GPU), with f32 softmax;
  - masked (text) attention is plain PyTorch with the softmax in the
    compute dtype, as the JAX package's XLA form;
  - the int8 MLP is the fused int8 MLP (ops/mlp_int8.py: the CUDA kernel
    on a GPU), with f32 hidden activations.

Weights live in `nn.Linear` modules ([out, in] layout; matmul weights in
the compute dtype, biases f32) or `QLinear` modules; the layer stack is a
plain list of per-layer modules (the JAX package stacks layers for
`lax.scan`; models/convert_jax.py splits that stack).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.ops.attention import mha_short_seq
from mmrs_tpu_torch.ops.int8 import int8_linear, quantize_act
from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused


class LayerNorm(nn.Module):
    """LayerNorm computed in f32; output in the input's dtype."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class QLinear(nn.Module):
    """int8 linear layer (mmrs_tpu layers.QTensor): per-output-channel
    symmetric int8 weights, w ~= q * s, and an f32 bias. Buffers: q int8
    [out, in], s f32 [out], bias f32 [out] or None."""

    def __init__(self, out_features: int, in_features: int,
                 bias: bool = True):
        super().__init__()
        self.register_buffer(
            "q", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("s", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias
                             else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QLinear":
        """Quantize a float layer as mmrs_tpu layers.quantize_weight does:
        s = max(|w|, 1e-12) / 127 over each output channel's inputs, codes
        round(w / s) half to even (no clip: |w / s| <= 127). The JAX
        package runs this op by op, outside `jit`, so its / 127 is a true
        division (under `jit` XLA makes it a product: ops/int8.INV_127)."""
        w32 = lin.weight.detach().float()
        layer = cls(*w32.shape, bias=lin.bias is not None).to(w32.device)
        layer.s = torch.clamp(w32.abs().amax(1), min=1e-12) / 127.0
        layer.q = torch.round(w32 / layer.s[:, None]).to(torch.int8)
        if lin.bias is not None:
            layer.bias = lin.bias.detach().float()
        return layer


def _mm_f32(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2d @ w.T as f32 sums of the compute-dtype operands' products (exact
    in f32). cuBLAS returns them directly for bf16 operands (`out_dtype`,
    CUDA only); elsewhere the operands are widened to f32 first."""
    if x2d.is_cuda and x2d.dtype != torch.float32:
        return torch.mm(x2d, w.T, out_dtype=torch.float32)
    return x2d.float() @ w.float().T


def dense(x: torch.Tensor, layer, compute_dtype: torch.dtype
          ) -> torch.Tensor:
    """x @ W^T + b in the compute dtype: f32 sums plus the f32 bias,
    rounded once (mmrs_tpu layers.dense). A `QLinear` quantizes x per row
    first, in x's own dtype (layers._dense_int8)."""
    if isinstance(layer, QLinear):
        xq, sx = quantize_act(x)
        return int8_linear(xq, sx, layer.q, layer.s, layer.bias,
                           compute_dtype)
    x = x.to(compute_dtype)
    y = _mm_f32(x.reshape(-1, x.shape[-1]), layer.weight.to(compute_dtype))
    y = y.reshape(*x.shape[:-1], -1)
    if layer.bias is None:
        return y.to(compute_dtype)
    # one pass: the f32 sum, rounded as it is stored
    return torch.add(y, layer.bias.float(),
                     out=torch.empty_like(y, dtype=compute_dtype))


def project(x: torch.Tensor, layer: nn.Linear, compute_dtype: torch.dtype
            ) -> torch.Tensor:
    """Final embedding projection: compute-dtype operands, f32 result (the
    JAX towers keep the projected features in f32)."""
    return F.linear(x.to(compute_dtype).float(),
                    layer.weight.to(compute_dtype).float())


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float()).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.wq = nn.Linear(width, width)
        self.wk = nn.Linear(width, width)
        self.wv = nn.Linear(width, width)
        self.wo = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                compute_dtype: torch.dtype, attn_impl: str = "auto"
                ) -> torch.Tensor:
        b, t, w = x.shape
        hd = w // self.heads
        cd = compute_dtype
        # 1/sqrt(hd) folded into q, rounded to the compute dtype first (a
        # host scalar: no device tensor is made per call)
        scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=cd))
        if isinstance(self.wq, QLinear):
            # the int8 tower quantizes the layer input once for all three
            xq, sx = quantize_act(x)
            q, k, v = (int8_linear(xq, sx, p.q, p.s, p.bias, cd)
                       for p in (self.wq, self.wk, self.wv))
        else:
            q, k, v = (dense(x, p, cd) for p in (self.wq, self.wk, self.wv))
        q = q * scale
        if mask is None:
            out = mha_short_seq(q, k, v, self.heads, impl=attn_impl)
            return dense(out, self.wo, cd)

        def split(y):                              # [B, H, T, hd]
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        logits = split(q).float() @ split(k).float().transpose(-1, -2)
        probs = torch.softmax((logits + mask).to(cd), dim=-1)
        out = (probs.float() @ split(v).float()).to(cd)
        return dense(out.transpose(1, 2).reshape(b, t, w), self.wo, cd)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int, act: Callable):
        super().__init__()
        self.w1 = nn.Linear(width, hidden)
        self.w2 = nn.Linear(hidden, width)
        self.act = act

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                mlp_impl: str = "auto") -> torch.Tensor:
        if isinstance(self.w1, QLinear):
            w1, w2 = self.w1, self.w2
            y = mlp_int8_fused(
                x.reshape(-1, x.shape[-1]).to(compute_dtype), w1.q, w1.s,
                w1.bias, w2.q, w2.s, w2.bias,
                act="quick_gelu" if self.act is quick_gelu else "gelu",
                impl=mlp_impl)
            return y.reshape(x.shape)
        h = self.act(dense(x, self.w1, compute_dtype))
        return dense(h, self.w2, compute_dtype)


class Block(nn.Module):
    """CLIP-style pre-LayerNorm residual block."""

    def __init__(self, width: int, heads: int, act: Callable,
                 mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ln2 = LayerNorm(width)
        self.mlp = MLP(width, width * mlp_ratio, act)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                compute_dtype: torch.dtype, attn_impl: str = "auto",
                mlp_impl: str = "auto") -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask, compute_dtype, attn_impl)
        return x + self.mlp(self.ln2(x), compute_dtype, mlp_impl)


def init_blocks(blocks: nn.ModuleList, generator: torch.Generator) -> None:
    """Random init matching mmrs_tpu's init_block_params distributions:
    N(0, 0.02) weights, zero biases, unit LayerNorm scales."""
    for blk in blocks:
        for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                    blk.mlp.w1, blk.mlp.w2):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
            nn.init.zeros_(lin.bias)
