"""Dual-tower CLIP: encode_image / encode_text / similarity logits, and
`pair_config`, the one rule that picks a pair from its towers' names.

Counterpart of mmrs_tpu/models/clip.py: the CLIP pair and the Chinese
Taiyi pair (a ViT image tower with the Taiyi RoBERTa text tower,
models/bert.py), and the SigLIP pair (its ViT with a MAP head and its
bidirectional text tower; it holds the sigmoid loss's logit_scale and
logit_bias). The scoring contracts are the reference's: softmax over
`100 * image @ text.T` (CLIP/lab1.py:90-91) and the logit-scaled cosine
(code/merge_dataset.py:275-279). logit_scale stays f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from mmrs_tpu_torch.models.bert import Bert
from mmrs_tpu_torch.models.configs import (CLIP_TEXT_B32, CLIP_TEXT_L14,
                                           CLIP_TEXT_TINY, IMAGE_TOWERS,
                                           TAIYI_ROBERTA_LARGE, TAIYI_TINY,
                                           TEXT_TOWERS, BertConfig,
                                           TextConfig, VITConfig)
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
                 normalize: bool = True, impl: str = "auto"
                 ) -> torch.Tensor:
    """[B, H, W, 3] CLIP-normalized images -> [B, embed_dim] f32. `impl`
    routes every kernel of the tower ("auto" or "torch", as in ops/):
    with "torch" the tower runs the plain ops."""
    feats = model.visual(images, compute_dtype, impl)
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


# --- Chinese (Taiyi) pair -------------------------------------------------

@dataclass(frozen=True)
class TaiyiCLIPConfig:
    vision: VITConfig
    text: BertConfig
    logit_scale_init: float = float(np.log(1.0 / 0.07))


class TaiyiCLIP(nn.Module):
    """The Taiyi pair: a ViT image tower (as CLIP's) and the Taiyi RoBERTa
    text tower. With a generator the weights are random-initialized from
    it; without one they are placeholders for models/convert_jax.py."""

    def __init__(self, cfg: TaiyiCLIPConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg.vision, generator)
        self.text = Bert(cfg.text, generator)
        self.logit_scale = nn.Parameter(
            torch.tensor(cfg.logit_scale_init, dtype=torch.float32))


@torch.inference_mode()
def taiyi_encode_text(model: TaiyiCLIP, tokens: torch.Tensor,
                      attention_mask: Optional[torch.Tensor],
                      compute_dtype: torch.dtype = torch.bfloat16,
                      normalize: bool = True) -> torch.Tensor:
    """[B, T] WordPiece ids and their [B, T] attention mask -> [B,
    num_labels] f32 (the classifier's logits, L2-normalized)."""
    feats = model.text(tokens, attention_mask, compute_dtype)
    return l2_normalize(feats) if normalize else feats


# --- SigLIP pair -------------------------------------------------------------

@dataclass(frozen=True)
class SigLIPConfig:
    vision: VITConfig
    text: TextConfig
    logit_scale_init: float = float(np.log(10.0))   # the paper's t' init
    logit_bias_init: float = -10.0


class SigLIP(nn.Module):
    """The SigLIP pair: `visual` (pool="map") and `text` (bidirectional,
    last-token pooling, a biased head), with the sigmoid loss's learned
    `logit_scale` and `logit_bias` (f32). `encode_image` / `encode_text`
    take it as they take the CLIP pair. With a generator the weights are
    random-initialized from it; without one they are placeholders."""

    def __init__(self, cfg: SigLIPConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg.vision, generator)
        self.text = TextTransformer(cfg.text, generator)
        self.logit_scale = nn.Parameter(
            torch.tensor(cfg.logit_scale_init, dtype=torch.float32))
        self.logit_bias = nn.Parameter(
            torch.tensor(cfg.logit_bias_init, dtype=torch.float32))



# --- the pair rule -----------------------------------------------------------

def _siglip_text(image_tower: str, text_tower: str,
                 vision: VITConfig) -> TextConfig:
    """The text tower `text_tower` names for a SigLIP image tower: a
    SigLIP one (last-token pooling) of the same embed dim."""
    text = TEXT_TOWERS.get(text_tower)
    if not (isinstance(text, TextConfig) and text.pool == "last"
            and text.embed_dim == vision.embed_dim):
        siglip = sorted(k for k, t in TEXT_TOWERS.items()
                        if isinstance(t, TextConfig) and t.pool == "last")
        raise ValueError(
            f"image tower {image_tower!r} pairs with a SigLIP text tower of "
            f"{vision.embed_dim}-d, one of {siglip}; got text_tower "
            f"{text_tower!r}")
    return text


def pair_config(image_tower: str, text_tower: str) -> Tuple[type, object]:
    """(pair class, pair config) of a configured image and text tower: with
    a MAP-pooled (SigLIP) image tower the SigLIP pair, whose text tower
    `text_tower` names; with `text_tower: taiyi_roberta` the Taiyi pair;
    else CLIP with the image tower's own text tower. Raises ValueError on
    an unknown image tower or a pairing that does not fit."""
    if image_tower not in IMAGE_TOWERS:
        raise ValueError(f"unknown image tower {image_tower!r}; "
                         f"one of {sorted(IMAGE_TOWERS)}")
    vision = IMAGE_TOWERS[image_tower]
    if vision.pool == "map":
        return SigLIP, SigLIPConfig(
            vision=vision, text=_siglip_text(image_tower, text_tower, vision))
    if text_tower == "taiyi_roberta":
        # the text head's projection must match the image embed dim; the
        # tiny pair exists for CI/smoke runs
        taiyi = (TAIYI_TINY if image_tower == "vit_tiny"
                 else TAIYI_ROBERTA_LARGE)
        if taiyi.num_labels != vision.embed_dim:
            raise ValueError(
                f"text tower 'taiyi_roberta' projects to "
                f"{taiyi.num_labels}-d but image tower {image_tower!r} "
                f"embeds {vision.embed_dim}-d; pair Taiyi with vit_l14 (the "
                f"reference's pairing) or vit_tiny")
        return TaiyiCLIP, TaiyiCLIPConfig(vision=vision, text=taiyi)
    text = {"vit_b32": CLIP_TEXT_B32, "vit_l14": CLIP_TEXT_L14,
            "vit_tiny": CLIP_TEXT_TINY}[image_tower]
    return CLIP, CLIPConfig(vision=vision, text=text)
