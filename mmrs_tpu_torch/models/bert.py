"""Taiyi RoBERTa text tower — BERT encoder + sequence-classification head.

Counterpart of mmrs_tpu/models/bert.py. Replaces
`BertForSequenceClassification.from_pretrained(
"IDEA-CCNL/Taiyi-CLIP-Roberta-large-326M-Chinese")`, whose `.logits` are
the Chinese text embedding (code/test_taiyi.py:11-13,24):

    embedding = classifier(tanh(pooler_dense(hidden[CLS])))

a `num_labels`-dim classification head acting as the projection (768 =
the ViT-L/14 image embedding dim).

Post-LN BERT blocks (absolute position embeddings from 0, token type 0),
the additive [B, 1, 1, T] padding mask, exact GELU. Numerics follow the
JAX package: compute-dtype matmuls with f32 sums and f32 biases, f32
LayerNorm, and the masked attention of models/layers.py (plain PyTorch,
as the JAX package's `attn_impl="xla"`: no kernel). The classifier's
output stays f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.models.configs import BertConfig
from mmrs_tpu_torch.models.layers import (MLP, Attention, LayerNorm, _mm_f32,
                                          dense, gelu)


class BertBlock(nn.Module):
    """Post-LN BERT block: LN(h + attn(h)), then LN(h + mlp(h))."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        w = cfg.hidden_size
        self.attn = Attention(w, cfg.heads)
        self.attn_ln = LayerNorm(w, cfg.layer_norm_eps)
        self.mlp = MLP(w, cfg.intermediate_size, gelu)
        self.out_ln = LayerNorm(w, cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                compute_dtype: torch.dtype) -> torch.Tensor:
        h = self.attn_ln(h + self.attn(h, mask, compute_dtype))
        return self.out_ln(h + self.mlp(h, compute_dtype))


class Bert(nn.Module):
    """The Taiyi text tower. With a generator the weights are
    random-initialized from it (the JAX init's distributions); without one
    they are placeholders for models/convert_jax.py to fill."""

    def __init__(self, cfg: BertConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.zeros(cfg.vocab_size, w))
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, w))
        self.token_type_embeddings = nn.Parameter(
            torch.zeros(cfg.type_vocab_size, w))
        self.emb_ln = LayerNorm(w, cfg.layer_norm_eps)
        self.blocks = nn.ModuleList(BertBlock(cfg) for _ in range(cfg.layers))
        self.pooler = nn.Linear(w, w)
        self.classifier = nn.Linear(w, cfg.num_labels)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 0.02) weights and embeddings, zero biases, unit LayerNorm
        scales (mmrs_tpu bert.init)."""
        for p in (self.word_embeddings, self.position_embeddings,
                  self.token_type_embeddings):
            nn.init.normal_(p, std=0.02, generator=generator)
        lins = [self.pooler, self.classifier]
        for blk in self.blocks:
            lins += [blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                     blk.mlp.w1, blk.mlp.w2]
        for lin in lins:
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
            nn.init.zeros_(lin.bias)

    def forward(self, tokens: torch.Tensor,              # [B, T] int
                attention_mask: Optional[torch.Tensor],  # [B, T] 1 keep, 0 pad
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:                       # [B, num_labels] f32
        cd = compute_dtype
        t = tokens.shape[1]
        emb = (F.embedding(tokens.long(), self.word_embeddings)
               + self.position_embeddings[:t][None]
               + self.token_type_embeddings[0][None, None])
        h = self.emb_ln(emb.to(cd))
        mask = None
        if attention_mask is not None:
            keep = attention_mask.to(torch.bool)
            mask = torch.where(keep, 0.0, float("-inf")).to(
                torch.float32)[:, None, None, :]          # [B, 1, 1, T]
        for blk in self.blocks:
            h = blk(h, mask, cd)
        pooled = torch.tanh(dense(h[:, 0], self.pooler, cd).float())
        return (_mm_f32(pooled.to(cd), self.classifier.weight.to(cd))
                + self.classifier.bias.float())
