"""OpenAI CLIP's text transformer in plain float32.

Radford et al. 2021 and openai/CLIP's `encode_text`: token embeddings plus
learned positions over the fixed 77-token context, causally masked pre-LN
residual blocks with QuickGELU, a final LayerNorm, the hidden state at the
end-of-text token (the largest id in the row), a bias-free projection,
then L2 normalization.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.common import (ACTIVATIONS, Weights, l2_normalize,
                                        layer_norm, linear, pre_ln_block)
from benchmark.reference.vit import block_shapes


def weight_shapes(spec: Dict, prefix: str = "text") -> List[Tuple]:
    w = spec["width"]
    out = [(f"{prefix}.token_embedding.weight", (spec["vocab_size"], w),
            "embedding"),
           (f"{prefix}.positional_embedding", (spec["context_length"], w),
            "embedding_small")]
    for i in range(spec["layers"]):
        out += block_shapes(f"{prefix}.blocks.{i}", w, spec["mlp_ratio"] * w)
    out += [(f"{prefix}.ln_final.weight", (w,), "ln_weight"),
            (f"{prefix}.ln_final.bias", (w,), "bias"),
            (f"{prefix}.text_projection.weight", (spec["embed_dim"], w),
             "projection")]
    return out


def encode(w: Weights, spec: Dict, tokens: torch.Tensor, mask=None,
           int8: bool = False, prefix: str = "text") -> torch.Tensor:
    """int token ids [B, T] -> L2-normalized embeddings [B, E]. `mask` is
    unused: the causal mask and the end-of-text position bound each row."""
    del mask
    b, t = tokens.shape
    tokens = tokens.long()
    x = (w[f"{prefix}.token_embedding.weight"].float()[tokens]
         + w[f"{prefix}.positional_embedding"].float()[:t])
    causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    eps = spec["layer_norm_eps"]
    act = ACTIVATIONS[spec["activation"]]
    for i in range(spec["layers"]):
        x = pre_ln_block(x, w, f"{prefix}.blocks.{i}", spec["heads"], causal,
                         act, eps, int8)
    x = layer_norm(x, w, f"{prefix}.ln_final", eps)
    pooled = x[torch.arange(b, device=x.device), tokens.argmax(-1)]
    return l2_normalize(linear(pooled, w[f"{prefix}.text_projection.weight"],
                               None, int8))
