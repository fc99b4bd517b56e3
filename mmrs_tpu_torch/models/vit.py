"""ViT image towers: CLIP's (B/32 and L/14) and SigLIP's (so400m/14).

Counterpart of mmrs_tpu/models/vit.py. The patch-embedding convolution is
a patchify reshape plus one matmul, with the same (h, w, c) flatten order
as the JAX package, so its `patch_kernel` [P*P*3, W] loads unchanged (as
the transposed `patch_embed` weight). In the int8 tower the patch
embedding is a `QLinear` (its input quantized per row in the input's own
dtype, as `dense(x, QTensor, None)` in the JAX package); `proj` stays
unquantized. Output contract as OpenAI CLIP:
ln_post over the CLS token, then `proj` -> [B, embed_dim] f32,
unnormalized. With `pool="map"` (SigLIP: a biased patch embedding, no CLS
token, no ln_pre, tanh GELU) ln_post runs over every token and the MAP
head (layers.MapHead) pools them to the [B, width] f32 embedding, inside
a `towers.pool` span.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmrs_tpu_torch.models.configs import VITConfig
from mmrs_tpu_torch.models.layers import (ACTIVATIONS, Block, LayerNorm,
                                          MapHead, dense, init_blocks,
                                          project)
from mmrs_tpu_torch.utils.profiling import trace


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, G*G, P*P*3] (channel-last input, (h, w, c)
    flatten order within a patch), G = H // P: a remainder of H is cropped
    at the bottom and right, as a conv with "valid" padding drops it
    (SigLIP: 384 px at patch 14 keeps 378)."""
    b, h, w, c = images.shape
    g = h // patch
    if h != g * patch:
        images = images[:, :g * patch, :g * patch]
    x = images.reshape(b, g, patch, g, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)              # [B, G, G, P, P, C]
    return x.reshape(b, g * g, patch * patch * c)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VITConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w, eps = cfg.width, cfg.layer_norm_eps
        self.patch_embed = nn.Linear(cfg.patch_size * cfg.patch_size * 3, w,
                                     bias=cfg.patch_bias)
        if cfg.class_token:
            self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.seq_len, w))
        if cfg.pre_norm:
            self.ln_pre = LayerNorm(w, eps)
        act = ACTIVATIONS[cfg.act]
        self.blocks = nn.ModuleList(
            Block(w, cfg.heads, act, hidden=cfg.hidden, eps=eps)
            for _ in range(cfg.layers))
        self.ln_post = LayerNorm(w, eps)
        if cfg.pool == "map":
            if cfg.embed_dim != w:
                raise ValueError(f"MAP pooling embeds {w}-d (the width), "
                                 f"not embed_dim={cfg.embed_dim}")
            self.head = MapHead(w, cfg.heads, cfg.hidden, act, eps)
        elif cfg.pool == "cls" and cfg.class_token:
            self.proj = nn.Linear(w, cfg.embed_dim, bias=False)
        else:
            raise ValueError(f"unknown pooling {cfg.pool!r} (class token: "
                             f"{cfg.class_token})")
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init's distributions (vit.init), from a torch generator."""
        s = self.cfg.width ** -0.5
        nn.init.normal_(self.patch_embed.weight, std=0.02, generator=generator)
        if self.cfg.class_token:
            nn.init.normal_(self.class_embedding, std=s, generator=generator)
        nn.init.normal_(self.positional_embedding, std=s, generator=generator)
        init_blocks(self.blocks, generator)
        if self.cfg.pool == "map":
            head = self.head
            nn.init.normal_(head.probe, std=s, generator=generator)
            for lin in (head.attn.wq, head.attn.wk, head.attn.wv,
                        head.attn.wo, head.mlp.w1, head.mlp.w2):
                nn.init.normal_(lin.weight, std=0.02, generator=generator)
                nn.init.zeros_(lin.bias)
        else:
            nn.init.normal_(self.proj.weight, std=s, generator=generator)

    def hidden_states(self, images: torch.Tensor,   # [B, H, W, 3]
                      compute_dtype: torch.dtype = torch.bfloat16,
                      n_blocks: Optional[int] = None, impl: str = "auto",
                      pieces=None, devices=None) -> torch.Tensor:
        """[B, N+1, W] tokens (CLS first; [B, N, W] without a class token)
        after the first `n_blocks` blocks (default: all), before ln_post;
        LLaVA reads block -2's output. `impl` routes every kernel of the
        tower (layers.Block): "auto" or "torch" (the plain ops).
        `pieces[i]` (one layers.BlockPiece a model position, on
        `devices`) runs block i tensor-parallel (Block.forward)."""
        cd = compute_dtype
        x = dense(patchify(images, self.cfg.patch_size), self.patch_embed, cd,
                  impl=impl)
        if self.cfg.class_token:
            cls = self.class_embedding.to(cd).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)                    # [B, N+1, W]
        x = x + self.positional_embedding.to(cd)[None]
        if self.cfg.pre_norm:
            x = self.ln_pre(x, impl)
        for i, blk in enumerate(self.blocks[:n_blocks]):
            x = blk(x, None, cd, impl, None if pieces is None else pieces[i],
                    devices)
        return x

    def forward(self, images: torch.Tensor,     # [B, H, W, 3], normalized
                compute_dtype: torch.dtype = torch.bfloat16,
                impl: str = "auto", pieces=None, devices=None
                ) -> torch.Tensor:
        x = self.hidden_states(images, compute_dtype, None, impl, pieces,
                               devices)
        if self.cfg.pool == "map":
            with trace("towers.pool", items=x.shape[0]):
                return self.head(self.ln_post(x, impl), compute_dtype,
                                 impl).float()
        cls_tok = self.ln_post(x[:, 0, :], impl)
        return project(cls_tok, self.proj, compute_dtype)      # f32
