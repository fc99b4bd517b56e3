"""Shared transformer building blocks for the CLIP towers.

Counterpart of mmrs_tpu/models/layers.py, restricted to what the CLIP
towers use. Numerics follow the JAX package:
  - matmuls take the compute dtype (bf16 by default); the products
    accumulate in f32 inside the matmul;
  - LayerNorm runs in f32 regardless of the compute dtype;
  - unmasked (vision) attention is the fused short-sequence MHA
    (ops/attention.py: the CUDA kernel on a GPU), with f32 softmax;
  - masked (text) attention is plain PyTorch with the softmax in the
    compute dtype, as the JAX package's XLA form.

Weights live in `nn.Linear` modules ([out, in] layout); the layer stack is
a plain list of per-layer modules (the JAX package stacks layers for
`lax.scan`; models/convert_jax.py splits that stack).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.ops.attention import mha_short_seq


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


def dense(x: torch.Tensor, layer: nn.Linear, compute_dtype: torch.dtype
          ) -> torch.Tensor:
    """x @ W^T + b in the compute dtype (products accumulate in f32)."""
    bias = None if layer.bias is None else layer.bias.to(compute_dtype)
    return F.linear(x.to(compute_dtype), layer.weight.to(compute_dtype), bias)


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
        q = dense(x, self.wq, cd) * scale
        k = dense(x, self.wk, cd)
        v = dense(x, self.wv, cd)
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

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype
                ) -> torch.Tensor:
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
                compute_dtype: torch.dtype, attn_impl: str = "auto"
                ) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), mask, compute_dtype, attn_impl)
        return x + self.mlp(self.ln2(x), compute_dtype)


def init_blocks(blocks: nn.ModuleList, generator: torch.Generator) -> None:
    """Random init matching mmrs_tpu's init_block_params distributions:
    N(0, 0.02) weights, zero biases, unit LayerNorm scales."""
    for blk in blocks:
        for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                    blk.mlp.w1, blk.mlp.w2):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
            nn.init.zeros_(lin.bias)
