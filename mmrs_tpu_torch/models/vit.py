"""CLIP ViT image tower (B/32 and L/14).

Counterpart of mmrs_tpu/models/vit.py. The patch-embedding convolution is
a patchify reshape plus one matmul, with the same (h, w, c) flatten order
as the JAX package, so its `patch_kernel` [P*P*3, W] loads unchanged (as
the transposed `patch_embed` weight). In the int8 tower the patch
embedding is a `QLinear` (its input quantized per row in the input's own
dtype, as `dense(x, QTensor, None)` in the JAX package); `proj` stays
unquantized. Output contract as OpenAI CLIP:
ln_post over the CLS token, then `proj` -> [B, embed_dim] f32,
unnormalized.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmrs_tpu_torch.models.configs import VITConfig
from mmrs_tpu_torch.models.layers import (Block, LayerNorm, dense, gelu,
                                          init_blocks, project, quick_gelu)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, G*G, P*P*3] (channel-last input, (h, w, c)
    flatten order within a patch)."""
    b, h, w, c = images.shape
    g = h // patch
    x = images.reshape(b, g, patch, g, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)              # [B, G, G, P, P, C]
    return x.reshape(b, g * g, patch * patch * c)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: VITConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embed = nn.Linear(cfg.patch_size * cfg.patch_size * 3, w,
                                     bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.seq_len, w))
        self.ln_pre = LayerNorm(w)
        act = quick_gelu if cfg.quick_gelu else gelu
        self.blocks = nn.ModuleList(
            Block(w, cfg.heads, act) for _ in range(cfg.layers))
        self.ln_post = LayerNorm(w)
        self.proj = nn.Linear(w, cfg.embed_dim, bias=False)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init's distributions (vit.init), from a torch generator."""
        s = self.cfg.width ** -0.5
        nn.init.normal_(self.patch_embed.weight, std=0.02, generator=generator)
        nn.init.normal_(self.class_embedding, std=s, generator=generator)
        nn.init.normal_(self.positional_embedding, std=s, generator=generator)
        init_blocks(self.blocks, generator)
        nn.init.normal_(self.proj.weight, std=s, generator=generator)

    def hidden_states(self, images: torch.Tensor,   # [B, H, W, 3]
                      compute_dtype: torch.dtype = torch.bfloat16,
                      n_blocks: Optional[int] = None,
                      attn_impl: str = "auto", mlp_impl: str = "auto",
                      pieces=None, devices=None) -> torch.Tensor:
        """[B, N+1, W] tokens (CLS first) after the first `n_blocks` blocks
        (default: all), before ln_post; LLaVA reads block -2's output.
        `pieces[i]` (one layers.BlockPiece a model position, on
        `devices`) runs block i tensor-parallel (Block.forward)."""
        cd = compute_dtype
        x = dense(patchify(images, self.cfg.patch_size), self.patch_embed, cd)
        cls = self.class_embedding.to(cd).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)                        # [B, N+1, W]
        x = x + self.positional_embedding.to(cd)[None]
        x = self.ln_pre(x)
        for i, blk in enumerate(self.blocks[:n_blocks]):
            x = blk(x, None, cd, attn_impl, mlp_impl,
                    None if pieces is None else pieces[i], devices)
        return x

    def forward(self, images: torch.Tensor,     # [B, H, W, 3], normalized
                compute_dtype: torch.dtype = torch.bfloat16,
                attn_impl: str = "auto", mlp_impl: str = "auto",
                pieces=None, devices=None) -> torch.Tensor:
        x = self.hidden_states(images, compute_dtype, None, attn_impl,
                               mlp_impl, pieces, devices)
        cls_tok = self.ln_post(x[:, 0, :])
        return project(cls_tok, self.proj, compute_dtype)      # f32
