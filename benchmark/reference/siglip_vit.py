"""SigLIP's vision transformer (so400m/14 at 384 px) in plain float32.

Zhai et al. 2023, "Sigmoid Loss for Language Image Pre-Training", with the
SoViT-400m/14 shape of Alabdulmohsin et al. 2023, "Getting ViT in Shape",
as HF transformers' `SiglipVisionTransformer` computes it: the image
normalized by the configuration's mean and std (0.5, 0.5), cut into
patches by a biased linear map of each patch's (row, column, channel)
pixels (the published conv with "valid" padding: 384 px at patch 14
keeps the first 378 rows and columns), learned positions and no class
token, no LayerNorm before the blocks, pre-LN residual blocks with GELU's
tanh approximation, LayerNorm over every token, then the multihead
attention pooling head: a learned probe attends over the tokens
(`nn.MultiheadAttention`'s in-projection as three biased maps q, k, v,
its out-projection o), h + MLP(LayerNorm(h)), the probe's row; then L2
normalization (the gallery's rows).

Departures: the patch map is the conv's weight as a [width, P*P*3]
matrix over (row, column, channel) pixels, the layout the system under
test loads; parameters are named as the system's state dict names them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.common import (Weights, l2_normalize, layer_norm,
                                        linear, pre_ln_block)
from benchmark.reference.vit import block_shapes


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`gelu_pytorch_tanh`."""
    return F.gelu(x, approximate="tanh")


def grid(spec: Dict) -> int:
    return spec["image_size"] // spec["patch_size"]


def head_shapes(prefix: str, width: int, hidden: int) -> List[Tuple]:
    """(name, shape, init) of the MAP head's parameters."""
    out = [(f"{prefix}.probe", (1, 1, width), "embedding_wide")]
    for p in ("q", "k", "v", "o"):
        out += [(f"{prefix}.attn.w{p}.weight", (width, width), "weight"),
                (f"{prefix}.attn.w{p}.bias", (width,), "bias")]
    out += [(f"{prefix}.ln.weight", (width,), "ln_weight"),
            (f"{prefix}.ln.bias", (width,), "bias"),
            (f"{prefix}.mlp.w1.weight", (hidden, width), "weight"),
            (f"{prefix}.mlp.w1.bias", (hidden,), "bias"),
            (f"{prefix}.mlp.w2.weight", (width, hidden), "weight"),
            (f"{prefix}.mlp.w2.bias", (width,), "bias")]
    return out


def weight_shapes(spec: Dict, prefix: str = "visual") -> List[Tuple]:
    """(name, shape, init) of every parameter; init names a distribution
    (benchmark/weights.py)."""
    w, p, hidden = spec["width"], spec["patch_size"], spec["mlp_width"]
    out = [(f"{prefix}.patch_embed.weight", (w, p * p * 3), "weight"),
           (f"{prefix}.patch_embed.bias", (w,), "bias"),
           (f"{prefix}.positional_embedding", (grid(spec) ** 2, w),
            "embedding_wide")]
    for i in range(spec["layers"]):
        out += block_shapes(f"{prefix}.blocks.{i}", w, hidden)
    out += [(f"{prefix}.ln_post.weight", (w,), "ln_weight"),
            (f"{prefix}.ln_post.bias", (w,), "bias")]
    return out + head_shapes(f"{prefix}.head", w, hidden)


def preprocess(images_u8: torch.Tensor, spec: Dict) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> (x / 255 - mean) / std, float32."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(spec["image_mean"], device=x.device)
    std = torch.tensor(spec["image_std"], device=x.device)
    return (x - mean) / std


def map_head(x: torch.Tensor, w: Weights, name: str, heads: int, eps: float,
             int8: bool) -> torch.Tensor:
    """The probe's attention over x [B, T, W], then h + MLP(LN(h)): [B, W]."""
    b, t, width = x.shape
    hd = width // heads
    probe = w[f"{name}.probe"].float().expand(b, 1, width)

    def proj(p, rows, n):
        y = linear(rows, w[f"{name}.attn.w{p}.weight"],
                   w[f"{name}.attn.w{p}.bias"], int8)
        return y.reshape(b, n, heads, hd).transpose(1, 2)

    q, k, v = proj("q", probe, 1), proj("k", x, t), proj("v", x, t)
    probs = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    h = linear((probs @ v).transpose(1, 2).reshape(b, 1, width),
               w[f"{name}.attn.wo.weight"], w[f"{name}.attn.wo.bias"], int8)
    m = layer_norm(h, w, f"{name}.ln", eps)
    m = gelu_tanh(linear(m, w[f"{name}.mlp.w1.weight"],
                         w[f"{name}.mlp.w1.bias"], int8))
    h = h + linear(m, w[f"{name}.mlp.w2.weight"], w[f"{name}.mlp.w2.bias"],
                   int8)
    return h[:, 0]


def encode(w: Weights, spec: Dict, images_u8: torch.Tensor,
           int8: bool = False, prefix: str = "visual") -> torch.Tensor:
    """uint8 images [B, H, W, 3] -> L2-normalized embeddings [B, W]."""
    x = preprocess(images_u8, spec)
    b, _, _, c = x.shape
    p, g = spec["patch_size"], grid(spec)
    x = x[:, :g * p, :g * p]
    x = x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5)
    x = linear(x.reshape(b, g * g, p * p * c),
               w[f"{prefix}.patch_embed.weight"],
               w[f"{prefix}.patch_embed.bias"], int8)
    x = x + w[f"{prefix}.positional_embedding"].float()
    eps = spec["layer_norm_eps"]
    for i in range(spec["layers"]):
        x = pre_ln_block(x, w, f"{prefix}.blocks.{i}", spec["heads"], None,
                         gelu_tanh, eps, int8)
    x = layer_norm(x, w, f"{prefix}.ln_post", eps)
    return l2_normalize(map_head(x, w, f"{prefix}.head", spec["heads"], eps,
                                 int8))
