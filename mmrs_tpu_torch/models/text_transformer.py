"""CLIP text tower — causal transformer with EOT-token pooling — and
SigLIP's.

Counterpart of mmrs_tpu/models/text_transformer.py: token + positional
embedding, causally-masked pre-LN blocks, ln_final, the hidden state at the
EOT position (the argmax token id — EOT has the highest id in the CLIP
vocab), `text_projection` -> [B, embed_dim] f32, unnormalized. SigLIP's
tower (`causal=False`, `pool="last"`, `head_bias`) is bidirectional (its
blocks take the unmasked attention kernel, K2), pools the last position
and adds the head's f32 bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.models.configs import TextConfig
from mmrs_tpu_torch.models.layers import (ACTIVATIONS, Block, LayerNorm,
                                          init_blocks, project)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """Additive [T, T] f32 mask: 0 on/below the diagonal, -inf above."""
    full = torch.full((t, t), float("-inf"), dtype=torch.float32,
                      device=device)
    return torch.triu(full, diagonal=1)


class TextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, w))
        if cfg.pool not in ("eot", "last"):
            raise ValueError(f"unknown text pooling {cfg.pool!r}")
        eps = cfg.layer_norm_eps
        self.blocks = nn.ModuleList(
            Block(w, cfg.heads, ACTIVATIONS[cfg.act], hidden=cfg.hidden,
                  eps=eps) for _ in range(cfg.layers))
        self.ln_final = LayerNorm(w, eps)
        self.text_projection = nn.Linear(w, cfg.embed_dim,
                                         bias=cfg.head_bias)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init's distributions (text_transformer.init)."""
        nn.init.normal_(self.token_embedding.weight, std=0.02,
                        generator=generator)
        nn.init.normal_(self.positional_embedding, std=0.01,
                        generator=generator)
        init_blocks(self.blocks, generator)
        nn.init.normal_(self.text_projection.weight,
                        std=self.cfg.width ** -0.5, generator=generator)
        if self.cfg.head_bias:
            nn.init.zeros_(self.text_projection.bias)

    def forward(self, tokens: torch.Tensor,          # [B, T] int
                compute_dtype: torch.dtype = torch.bfloat16,
                pieces=None, devices=None) -> torch.Tensor:
        """`pieces[i]` (one layers.BlockPiece a model position, on
        `devices`) runs block i tensor-parallel (Block.forward)."""
        cd = compute_dtype
        b, t = tokens.shape
        tokens = tokens.long()
        x = F.embedding(tokens, self.token_embedding.weight).to(cd)
        x = x + self.positional_embedding[:t].to(cd)[None]
        mask = causal_mask(t, x.device) if self.cfg.causal else None
        for i, blk in enumerate(self.blocks):
            x = blk(x, mask, cd, pieces=None if pieces is None
                    else pieces[i], devices=devices)
        x = self.ln_final(x)
        if self.cfg.pool == "last":
            pooled = x[:, -1]
        else:
            eot = torch.argmax(tokens, dim=-1)                # first max
            pooled = x[torch.arange(b, device=x.device), eot]
        return project(pooled, self.text_projection, cd)      # f32
