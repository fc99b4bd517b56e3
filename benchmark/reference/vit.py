"""OpenAI CLIP's vision transformer (ViT-B/32, ViT-L/14) in plain float32.

Radford et al. 2021, "Learning Transferable Visual Models From Natural
Language Supervision", and openai/CLIP's `VisionTransformer`: the image
normalized by CLIP's mean and std, cut into patches (a bias-free linear
map of each patch's (row, column, channel) pixels), a class token and
learned positions, LayerNorm, pre-LN residual blocks with QuickGELU,
LayerNorm of the class token, a bias-free projection, then L2
normalization (the gallery's rows).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.common import (ACTIVATIONS, Weights, l2_normalize,
                                        layer_norm, linear, pre_ln_block)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def block_shapes(prefix: str, width: int, hidden: int) -> List[Tuple]:
    """(name, shape, init) of one pre-LN block's parameters."""
    out = []
    for ln in ("ln1", "ln2"):
        out += [(f"{prefix}.{ln}.weight", (width,), "ln_weight"),
                (f"{prefix}.{ln}.bias", (width,), "bias")]
    for p in ("q", "k", "v", "o"):
        out += [(f"{prefix}.attn.w{p}.weight", (width, width), "weight"),
                (f"{prefix}.attn.w{p}.bias", (width,), "bias")]
    out += [(f"{prefix}.mlp.w1.weight", (hidden, width), "weight"),
            (f"{prefix}.mlp.w1.bias", (hidden,), "bias"),
            (f"{prefix}.mlp.w2.weight", (width, hidden), "weight"),
            (f"{prefix}.mlp.w2.bias", (width,), "bias")]
    return out


def weight_shapes(spec: Dict, prefix: str = "visual") -> List[Tuple]:
    """(name, shape, init) of every parameter; init names a distribution
    (benchmark/weights.py)."""
    w, p = spec["width"], spec["patch_size"]
    tokens = (spec["image_size"] // p) ** 2 + 1
    out = [(f"{prefix}.patch_embed.weight", (w, p * p * 3), "weight"),
           (f"{prefix}.class_embedding", (w,), "embedding_wide"),
           (f"{prefix}.positional_embedding", (tokens, w), "embedding_wide"),
           (f"{prefix}.ln_pre.weight", (w,), "ln_weight"),
           (f"{prefix}.ln_pre.bias", (w,), "bias")]
    for i in range(spec["layers"]):
        out += block_shapes(f"{prefix}.blocks.{i}", w, spec["mlp_ratio"] * w)
    out += [(f"{prefix}.ln_post.weight", (w,), "ln_weight"),
            (f"{prefix}.ln_post.bias", (w,), "bias"),
            (f"{prefix}.proj.weight", (spec["embed_dim"], w), "projection")]
    return out


def preprocess(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> (x / 255 - mean) / std, float32."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


def encode(w: Weights, spec: Dict, images_u8: torch.Tensor,
           int8: bool = False, prefix: str = "visual") -> torch.Tensor:
    """uint8 images [B, H, W, 3] -> L2-normalized embeddings [B, E]."""
    x = preprocess(images_u8)
    b, h, _, c = x.shape
    p = spec["patch_size"]
    g = h // p
    x = x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5)
    x = linear(x.reshape(b, g * g, p * p * c),
               w[f"{prefix}.patch_embed.weight"], None, int8)
    cls = w[f"{prefix}.class_embedding"].float().expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + w[f"{prefix}.positional_embedding"].float()
    eps = spec["layer_norm_eps"]
    x = layer_norm(x, w, f"{prefix}.ln_pre", eps)
    act = ACTIVATIONS[spec["activation"]]
    for i in range(spec["layers"]):
        x = pre_ln_block(x, w, f"{prefix}.blocks.{i}", spec["heads"], None,
                         act, eps, int8)
    cls_tok = layer_norm(x[:, 0], w, f"{prefix}.ln_post", eps)
    return l2_normalize(linear(cls_tok, w[f"{prefix}.proj.weight"], None,
                               int8))

