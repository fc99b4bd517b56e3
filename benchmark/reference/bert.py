"""Taiyi-CLIP's Chinese text tower (RoBERTa-large) in plain float32.

IDEA-CCNL/Taiyi-CLIP-Roberta-large-326M-Chinese: a BERT encoder (word,
position and token-type embeddings, LayerNorm; post-LN residual blocks
with exact GELU; padding masked out of attention) under a sequence
classification head whose `logits` are the text embedding: the [CLS]
state through the pooler (dense, tanh), then the classifier (dense to
the image tower's 768 dims), then L2 normalization.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference.common import (Weights, attention, gelu,
                                        l2_normalize, layer_norm, linear, mlp)


def weight_shapes(spec: Dict, prefix: str = "text") -> List[Tuple]:
    h, f = spec["hidden_size"], spec["intermediate_size"]
    out = [(f"{prefix}.word_embeddings", (spec["vocab_size"], h),
            "embedding"),
           (f"{prefix}.position_embeddings",
            (spec["max_position_embeddings"], h), "embedding"),
           (f"{prefix}.token_type_embeddings", (spec["type_vocab_size"], h),
            "embedding"),
           (f"{prefix}.emb_ln.weight", (h,), "ln_weight"),
           (f"{prefix}.emb_ln.bias", (h,), "bias")]
    for i in range(spec["layers"]):
        p = f"{prefix}.blocks.{i}"
        for name in ("q", "k", "v", "o"):
            out += [(f"{p}.attn.w{name}.weight", (h, h), "weight"),
                    (f"{p}.attn.w{name}.bias", (h,), "bias")]
        out += [(f"{p}.attn_ln.weight", (h,), "ln_weight"),
                (f"{p}.attn_ln.bias", (h,), "bias"),
                (f"{p}.mlp.w1.weight", (f, h), "weight"),
                (f"{p}.mlp.w1.bias", (f,), "bias"),
                (f"{p}.mlp.w2.weight", (h, f), "weight"),
                (f"{p}.mlp.w2.bias", (h,), "bias"),
                (f"{p}.out_ln.weight", (h,), "ln_weight"),
                (f"{p}.out_ln.bias", (h,), "bias")]
    out += [(f"{prefix}.pooler.weight", (h, h), "weight"),
            (f"{prefix}.pooler.bias", (h,), "bias"),
            (f"{prefix}.classifier.weight", (spec["num_labels"], h),
             "weight"),
            (f"{prefix}.classifier.bias", (spec["num_labels"],), "bias")]
    return out


def encode(w: Weights, spec: Dict, tokens: torch.Tensor,
           mask: torch.Tensor, int8: bool = False, prefix: str = "text"
           ) -> torch.Tensor:
    """WordPiece ids [B, T] and their 1/0 attention mask -> L2-normalized
    embeddings [B, num_labels]."""
    t = tokens.shape[1]
    x = (w[f"{prefix}.word_embeddings"].float()[tokens.long()]
         + w[f"{prefix}.position_embeddings"].float()[:t]
         + w[f"{prefix}.token_type_embeddings"].float()[0])
    eps = spec["layer_norm_eps"]
    x = layer_norm(x, w, f"{prefix}.emb_ln", eps)
    keep = mask.to(torch.bool)[:, None, None, :]
    additive = torch.zeros(keep.shape, device=x.device).masked_fill(
        ~keep, float("-inf"))
    for i in range(spec["layers"]):
        p = f"{prefix}.blocks.{i}"
        x = layer_norm(x + attention(x, w, f"{p}.attn", spec["heads"],
                                     additive, int8), w, f"{p}.attn_ln", eps)
        x = layer_norm(x + mlp(x, w, f"{p}.mlp", gelu, int8), w,
                       f"{p}.out_ln", eps)
    pooled = torch.tanh(linear(x[:, 0], w[f"{prefix}.pooler.weight"],
                               w[f"{prefix}.pooler.bias"], int8))
    return l2_normalize(linear(pooled, w[f"{prefix}.classifier.weight"],
                               w[f"{prefix}.classifier.bias"], int8))
