"""Dual-tower CLIP: encode_image / encode_text / similarity logits.

Counterpart of mmrs_tpu/models/clip.py (the CLIP pair; the Taiyi pair
waits for ROADMAP A.5). The scoring contracts are the reference's:
softmax over `100 * image @ text.T` (CLIP/lab1.py:90-91) and the
logit-scaled cosine (code/merge_dataset.py:275-279). logit_scale stays f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from mmrs_tpu_torch.models.configs import TextConfig, VITConfig
from mmrs_tpu_torch.models.text_transformer import TextTransformer
from mmrs_tpu_torch.models.vit import VisionTransformer
from mmrs_tpu_torch.ops.normalize import l2_normalize


@dataclass(frozen=True)
class CLIPConfig:
    vision: VITConfig
    text: TextConfig
    logit_scale_init: float = float(np.log(1.0 / 0.07))  # OpenAI default


class CLIP(nn.Module):
    """The tower pair. With a generator the weights are random-initialized
    from it (bring-up mode); without one they are placeholders for
    models/convert_jax.py to fill."""

    def __init__(self, cfg: CLIPConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg.vision, generator)
        self.text = TextTransformer(cfg.text, generator)
        self.logit_scale = nn.Parameter(
            torch.tensor(cfg.logit_scale_init, dtype=torch.float32))


@torch.inference_mode()
def encode_image(model: CLIP, images: torch.Tensor,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 normalize: bool = True, attn_impl: str = "auto",
                 mlp_impl: str = "auto") -> torch.Tensor:
    """[B, H, W, 3] CLIP-normalized images -> [B, embed_dim] f32.
    `attn_impl` / `mlp_impl` select the attention and int8-MLP kernels'
    implementation ("auto" or "torch", as in ops/)."""
    feats = model.visual(images, compute_dtype, attn_impl, mlp_impl)
    return l2_normalize(feats) if normalize else feats


@torch.inference_mode()
def encode_text(model: CLIP, tokens: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16,
                normalize: bool = True) -> torch.Tensor:
    """[B, T] token ids -> [B, embed_dim] f32."""
    feats = model.text(tokens, compute_dtype)
    return l2_normalize(feats) if normalize else feats


def similarity_logits(image_feats: torch.Tensor, text_feats: torch.Tensor,
                      logit_scale: Optional[torch.Tensor] = None,
                      scale: float = 100.0) -> torch.Tensor:
    """Scaled cosine logits [B, C] in f32."""
    s = torch.exp(logit_scale) if logit_scale is not None else scale
    return s * (image_feats.float() @ text_feats.float().T)


def zeroshot_probs(image_feats: torch.Tensor, text_feats: torch.Tensor,
                   scale: float = 100.0) -> torch.Tensor:
    """The test_clip.py contract: softmax over `100 * cosine` per image."""
    return torch.softmax(similarity_logits(image_feats, text_feats,
                                           scale=scale), dim=-1)
