"""LLaVA-style VLM: CLIP ViT features -> MLP projector -> LLaMA decoder.

Counterpart of mmrs_tpu/models/llava.py (liuhaotian/llava-v1.5-7b, the
cascade's verifier): the image goes through the CLIP ViT up to its
penultimate block (`vision_feature_layer=-2`; at 336 px the L/14 tower's
577 tokens through K2), the CLS token is dropped, a 2-layer GELU projector
maps the 576 patch tokens into the decoder's embedding space, they are
spliced between the prompt's pre-image and post-image text tokens, and the
decoder answers greedily (models/llama.py: K10 prefill chunks, K11 decode
steps; models/speculative.py with a draft VLM). A `TPLLaVA` (one data row
of parallel/vlm.shard_llava_params) runs through the same functions.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mmrs_tpu_torch.models import llama
from mmrs_tpu_torch.models.configs import VITConfig
from mmrs_tpu_torch.models.layers import dense, gelu
from mmrs_tpu_torch.models.llama import Llama, LlamaConfig
from mmrs_tpu_torch.models.vit import VisionTransformer


@dataclass(frozen=True)
class LLaVAConfig:
    vision: VITConfig
    lm: LlamaConfig
    vision_feature_layer: int = -2   # penultimate encoder layer
    drop_cls: bool = True


class LLaVA(nn.Module):
    """Vision tower + projector (`proj1`, `proj2`: f32 biases) + decoder.
    With a generator the weights are random-initialized from it with the
    JAX init's distributions; without one they are placeholders for
    models/convert_jax.py to fill."""

    def __init__(self, cfg: LLaVAConfig,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        w, d = cfg.vision.width, cfg.lm.dim
        with torch.device(device) if device is not None else nullcontext():
            self.visual = VisionTransformer(cfg.vision).to(dtype)
            self.proj1 = nn.Linear(w, d, dtype=dtype)
            self.proj2 = nn.Linear(d, d, dtype=dtype)
        for lin in (self.proj1, self.proj2):
            lin.bias.data = lin.bias.data.float()
        self.lm = Llama(cfg.lm, device=device, dtype=dtype)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.visual.reset_parameters(generator)
        for lin in (self.proj1, self.proj2):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
            nn.init.zeros_(lin.bias)
        self.lm.reset_parameters(generator)


class TPLLaVA(nn.Module):
    """One data row of a tensor-parallel LLaVA (parallel/vlm.py): the
    vision tower and the projector on the row's first model position, the
    decoder a llama.TPLlama over the row's positions. The functions below
    take it where they take a LLaVA: the tower runs once on the row's
    first device (JAX computes the same values on every chip of the row)
    and the decoder's shards take the image embeddings from there."""

    def __init__(self, cfg: LLaVAConfig, visual: nn.Module, proj1: nn.Module,
                 proj2: nn.Module, lm: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.visual, self.proj1, self.proj2, self.lm = visual, proj1, proj2, lm


def vision_tokens(model: LLaVA, images: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  impl: str = "auto") -> torch.Tensor:
    """[B, N, W] hidden states after block (layers + vision_feature_layer
    + 1) — HF's hidden_states[-2] — without the CLS token."""
    cfg = model.cfg
    n_run = cfg.vision.layers + cfg.vision_feature_layer + 1
    x = model.visual.hidden_states(images, compute_dtype, n_run, impl)
    return x[:, 1:, :] if cfg.drop_cls else x


def project(model: LLaVA, feats: torch.Tensor,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    h = dense(feats, model.proj1, compute_dtype, act=gelu)
    return dense(h, model.proj2, compute_dtype)


def encode_images(model: LLaVA, images: torch.Tensor,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  impl: str = "auto") -> torch.Tensor:
    """[B, H, W, 3] CLIP-normalized images -> [B, N, lm_dim]. `impl`
    routes the vision tower's kernels ("auto" or "torch")."""
    feats = vision_tokens(model, images, compute_dtype, impl)
    return project(model, feats, compute_dtype)


def build_multimodal_embeds(model: LLaVA, pre_tokens: torch.Tensor,
                            image_embeds: torch.Tensor,
                            post_tokens: torch.Tensor,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """[pre text, image tokens, post text] embeddings in the compute dtype."""
    emb = model.lm.embed
    return torch.cat([emb[pre_tokens].to(compute_dtype),
                      image_embeds.to(compute_dtype),
                      emb[post_tokens].to(compute_dtype)], dim=1)


@torch.inference_mode()
def generate(model: LLaVA, images: torch.Tensor, pre_tokens: torch.Tensor,
             post_tokens: torch.Tensor, max_new_tokens: int = 32,
             eos_token: int = 2, compute_dtype: torch.dtype = torch.bfloat16,
             impl: str = "auto", kv_dtype=None,
             prefill_chunk: Optional[int] = None,
             decode_window: Optional[int] = None, early_stop: bool = False,
             attn: str = "auto") -> torch.Tensor:
    """Greedy VQA decode (temperature 0), the verifier's contract:
    [B, max_new_tokens] int32, EOS-padded."""
    img = encode_images(model, images, compute_dtype, impl)
    embeds = build_multimodal_embeds(model, pre_tokens, img, post_tokens,
                                     compute_dtype)
    return llama.greedy_generate(
        model.lm, embeds, max_new_tokens, eos_token, compute_dtype,
        kv_dtype=kv_dtype, prefill_chunk=prefill_chunk,
        decode_window=decode_window, early_stop=early_stop, attn=attn)


@torch.inference_mode()
def generate_speculative(model: LLaVA, draft: LLaVA, images: torch.Tensor,
                         pre_tokens: torch.Tensor, post_tokens: torch.Tensor,
                         max_new_tokens: int = 32, draft_tokens: int = 4,
                         eos_token: int = 2,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         impl: str = "auto", kv_dtype=None,
                         prefill_chunk: Optional[int] = None,
                         attn: str = "auto", return_stats: bool = False):
    """Greedy VQA decode accelerated by a smaller draft VLM; the tokens are
    the target's own greedy output (models/speculative.py). Both models
    encode the same image and prompt through their own tower, projector and
    embedding table, so their sequences are position-aligned."""
    from mmrs_tpu_torch.models.speculative import speculative_generate

    emb_t = build_multimodal_embeds(
        model, pre_tokens, encode_images(model, images, compute_dtype, impl),
        post_tokens, compute_dtype)
    emb_d = build_multimodal_embeds(
        draft, pre_tokens, encode_images(draft, images, compute_dtype, impl),
        post_tokens, compute_dtype)
    return speculative_generate(
        model.lm, draft.lm, emb_t, emb_d, max_new_tokens=max_new_tokens,
        draft_tokens=draft_tokens, eos_token=eos_token,
        compute_dtype=compute_dtype, kv_dtype=kv_dtype,
        prefill_chunk=prefill_chunk, attn=attn, return_stats=return_stats)
