"""SigLIP's text transformer (so400m) in plain float32.

Zhai et al. 2023 and HF transformers' `SiglipTextTransformer`: token
embeddings plus learned positions over the fixed 64-token context,
bidirectional (unmasked) pre-LN residual blocks with GELU's tanh
approximation, a final LayerNorm, the hidden state at the last position,
a biased linear head, then L2 normalization.

Departure: ids come in as the benchmark made them (no SentencePiece
vocabulary is in the repository); parameters are named as the system's
state dict names them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.common import (Weights, l2_normalize, layer_norm,
                                        linear, pre_ln_block)
from benchmark.reference.siglip_vit import gelu_tanh
from benchmark.reference.vit import block_shapes


def weight_shapes(spec: Dict, prefix: str = "text") -> List[Tuple]:
    w = spec["width"]
    out = [(f"{prefix}.token_embedding.weight", (spec["vocab_size"], w),
            "embedding"),
           (f"{prefix}.positional_embedding", (spec["context_length"], w),
            "embedding_small")]
    for i in range(spec["layers"]):
        out += block_shapes(f"{prefix}.blocks.{i}", w, spec["mlp_width"])
    out += [(f"{prefix}.ln_final.weight", (w,), "ln_weight"),
            (f"{prefix}.ln_final.bias", (w,), "bias"),
            (f"{prefix}.text_projection.weight", (spec["embed_dim"], w),
             "projection"),
            (f"{prefix}.text_projection.bias", (spec["embed_dim"],), "bias")]
    return out


def encode(w: Weights, spec: Dict, tokens: torch.Tensor, mask=None,
           int8: bool = False, prefix: str = "text") -> torch.Tensor:
    """int token ids [B, T] -> L2-normalized embeddings [B, E]. `mask` is
    unused: every position attends to every other (SigLIP pads to the
    context length and pools the last position)."""
    del mask
    t = tokens.shape[1]
    x = (w[f"{prefix}.token_embedding.weight"].float()[tokens.long()]
         + w[f"{prefix}.positional_embedding"].float()[:t])
    eps = spec["layer_norm_eps"]
    for i in range(spec["layers"]):
        x = pre_ln_block(x, w, f"{prefix}.blocks.{i}", spec["heads"], None,
                         gelu_tanh, eps, int8)
    x = layer_norm(x, w, f"{prefix}.ln_final", eps)
    return l2_normalize(linear(x[:, -1], w[f"{prefix}.text_projection.weight"],
                               w[f"{prefix}.text_projection.bias"], int8))
