"""Glue layer: config -> towers -> encode callables.

Counterpart of mmrs_tpu/pipeline.py for the CLIP pair. Encoders are plain
callables `pixels_u8 [B,S,S,3] -> np.ndarray [B,D]`, so index build, search
and calibration compose as in the JAX package. On a CUDA device the image
path runs the normalize kernel (Triton) and the towers' attention kernel
(CUDA), and with `model.dtype: int8` the fused int8 MLP kernel (CUDA); on
the CPU it runs their plain PyTorch versions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from mmrs_tpu_torch.config import Config
from mmrs_tpu_torch.models import clip
from mmrs_tpu_torch.models.clip import CLIP, CLIPConfig
from mmrs_tpu_torch.models.configs import (CLIP_TEXT_B32, CLIP_TEXT_L14,
                                           CLIP_TEXT_TINY, IMAGE_TOWERS)
from mmrs_tpu_torch.models.quantize import quantize_clip_visual
from mmrs_tpu_torch.ops.preprocess import normalize_images

# "int8": the bf16 compute mix with an int8 vision tower (models/quantize.py)
# and a bf16 text tower, as mmrs_tpu/pipeline.py
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.bfloat16}


@dataclass
class Towers:
    """A ready pair of encode callables + the underlying model/config."""

    image_encode: Callable[[np.ndarray], np.ndarray]
    text_encode: Optional[Callable] = None
    params: Optional[CLIP] = None
    clip_config: Optional[object] = None
    tokenizer: Optional[object] = None
    # device tensors in and out: uint8 [B, S, S, 3] -> f32 [B, D]
    encode_fn: Optional[Callable] = None
    # UNnormalized features — the Tip-Adapter cache contract
    image_encode_raw: Optional[Callable] = None


DEVICE_ENV = "MMRS_TORCH_DEVICE"


def default_device() -> torch.device:
    """The device of every entry point whose caller names none: the GPU.
    Nothing falls back to the CPU on its own; the CPU is asked for with an
    explicit `device="cpu"` or with MMRS_TORCH_DEVICE=cpu (the port's
    JAX_PLATFORMS=cpu, and the CLI's only way onto the CPU)."""
    want = os.environ.get(DEVICE_ENV, "")
    if want:
        return torch.device(want)
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        f"no CUDA device found; to run on the CPU set {DEVICE_ENV}=cpu or "
        f"pass device='cpu'")


def build_towers(cfg: Config, tokenizer=None, device=None) -> Towers:
    """Construct the configured CLIP pair on `device` (default:
    `default_device()`). Weights come from cfg.model.checkpoint_path (an npz
    written by mmrs_tpu's checkpoint.save_npz); without one the towers are
    random-initialized from cfg.seed (bring-up mode)."""
    from mmrs_tpu_torch.models import convert_jax

    if cfg.model.text_tower == "taiyi_roberta":
        raise NotImplementedError(
            "the Taiyi RoBERTa text tower is ported with ROADMAP A.5")
    if cfg.model.dtype not in _DTYPES:
        raise ValueError(f"unknown model dtype {cfg.model.dtype!r}")
    compute_dtype = _DTYPES[cfg.model.dtype]
    device = torch.device(device) if device is not None else default_device()

    vision = IMAGE_TOWERS[cfg.model.image_tower]
    text = {"vit_b32": CLIP_TEXT_B32, "vit_l14": CLIP_TEXT_L14,
            "vit_tiny": CLIP_TEXT_TINY}[cfg.model.image_tower]
    ccfg = CLIPConfig(vision=vision, text=text)
    if cfg.model.checkpoint_path:
        model = convert_jax.load_npz(cfg.model.checkpoint_path, ccfg)
    else:
        model = CLIP(ccfg, generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device).eval().requires_grad_(False)
    if cfg.model.dtype == "int8":     # from the f32 weights, before the cast
        quantize_clip_visual(model)
    # float matmul weights are stored in the compute dtype once; biases,
    # LayerNorm parameters and embeddings stay f32 (a bias is added to the
    # f32 sums before the one rounding, as in the JAX package's `dense`)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.data = m.weight.data.to(compute_dtype)

    def encode_fn(images_u8: torch.Tensor, normalize: bool = True
                  ) -> torch.Tensor:
        x = normalize_images(images_u8, dtype=compute_dtype)
        return clip.encode_image(model, x, compute_dtype, normalize=normalize)

    def _upload(pixels_u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(pixels_u8)).to(device)

    def image_encode(pixels_u8: np.ndarray) -> np.ndarray:
        return encode_fn(_upload(pixels_u8)).cpu().numpy()

    def image_encode_raw(pixels_u8: np.ndarray) -> np.ndarray:
        return encode_fn(_upload(pixels_u8), normalize=False).cpu().numpy()

    text_encode = None
    if tokenizer is not None:
        def text_encode(texts):
            ids = torch.from_numpy(tokenizer(texts)).to(device)
            return clip.encode_text(model, ids, compute_dtype).cpu().numpy()

    return Towers(image_encode=image_encode, text_encode=text_encode,
                  params=model, clip_config=ccfg, tokenizer=tokenizer,
                  encode_fn=encode_fn, image_encode_raw=image_encode_raw)
