"""Glue layer: config -> towers -> encode callables.

Counterpart of mmrs_tpu/pipeline.py for the CLIP pair, the Taiyi pair
(`text_tower: taiyi_roberta`: a ViT with the Chinese RoBERTa text tower,
whose text encoder takes a WordPiece tokenizer's ids and attention
mask) and the SigLIP pair (`image_tower: siglip_so400m_384`, `text_tower:
siglip_text_so400m`: its text tower takes ids; no SentencePiece
vocabulary ships with the port).
Encoders are plain callables `pixels_u8 [B,S,S,3] -> np.ndarray [B,D]`,
so index build, search and calibration compose as in the JAX package. On
a CUDA device the image path runs the normalize kernel (Triton) and the
towers' attention kernel (CUDA), and with `model.dtype: int8` the fused
int8 MLP kernel (CUDA); on the CPU it runs their plain PyTorch versions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from mmrs_tpu_torch.config import Config
from mmrs_tpu_torch.models import clip
from mmrs_tpu_torch.models.clip import CLIP, SigLIP, TaiyiCLIP
from mmrs_tpu_torch.models.quantize import quantize_clip_visual
from mmrs_tpu_torch.ops.preprocess import normalize_images
from mmrs_tpu_torch.utils.profiling import trace

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
    # (model, uint8 [B, S, S, 3] device tensor) -> f32 [B, D]: encode_fn
    # of a given copy of `params` (the JAX package's (params, images)
    # encode_fn; feeds parallel.embed.make_sharded_encoder)
    params_encode_fn: Optional[Callable] = None


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


def build_towers(cfg: Config, tokenizer=None, device=None,
                 impl: str = "auto",
                 weights: Optional[Dict[str, torch.Tensor]] = None) -> Towers:
    """Construct the tower pair that clip.pair_config picks for
    cfg.model's image and text towers on `device` (default:
    `default_device()`). Weights come from
    `weights` (a state dict under the pair's own parameter names, taken
    as they are: `load_state_dict(assign=True)` into a model made on the
    meta device), else from cfg.model.checkpoint_path (an npz written by
    either package's checkpoint.save_npz: the tree of `mmrs-torch weights
    convert`, or for Taiyi {"visual", "text", "logit_scale"}); without
    either the towers are random-initialized from cfg.seed (bring-up
    mode). `impl` is the image path's kernel route: "auto" (the kernels
    on the card), or "torch" (their plain versions)."""
    from mmrs_tpu_torch.models import convert_jax

    if cfg.model.dtype not in _DTYPES:
        raise ValueError(f"unknown model dtype {cfg.model.dtype!r}")
    compute_dtype = _DTYPES[cfg.model.dtype]
    make, ccfg = clip.pair_config(cfg.model.image_tower, cfg.model.text_tower)
    device = torch.device(device) if device is not None else default_device()
    if weights is not None:
        with torch.device("meta"):
            model = make(ccfg)
        model.load_state_dict(weights, strict=True, assign=True)
    elif cfg.model.checkpoint_path:
        if make is SigLIP:
            raise ValueError("no converter reads SigLIP checkpoints yet; "
                             "pass the state dict as weights=")
        model = convert_jax.load_npz(cfg.model.checkpoint_path, ccfg)
    else:
        model = make(ccfg, generator=torch.Generator().manual_seed(cfg.seed))
    model = model.to(device).eval().requires_grad_(False)
    if cfg.model.dtype == "int8":     # from the f32 weights, before the cast
        quantize_clip_visual(model)
    # float matmul weights are stored in the compute dtype once; biases,
    # LayerNorm parameters and embeddings stay f32 (a bias is added to the
    # f32 sums before the one rounding, as in the JAX package's `dense`)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.weight.data = m.weight.data.to(compute_dtype)

    def params_encode_fn(m: nn.Module, images_u8: torch.Tensor,
                         normalize: bool = True) -> torch.Tensor:
        x = normalize_images(images_u8, dtype=compute_dtype, impl=impl,
                             mean=ccfg.vision.mean, std=ccfg.vision.std)
        return clip.encode_image(m, x, compute_dtype, normalize=normalize,
                                 impl=impl)

    # the image path's spans: `towers.upload` (the pageable host-to-device
    # copy), `towers.encode` (K3 and the tower's launches, no sync; inside
    # it a MAP-pooled tower's `towers.pool`, models/vit.py) and
    # `towers.fetch` (the wait for the card and the device-to-host copy)
    def encode_fn(images_u8: torch.Tensor, normalize: bool = True
                  ) -> torch.Tensor:
        with trace("towers.encode", items=images_u8.shape[0]):
            return params_encode_fn(model, images_u8, normalize)

    def _upload(pixels_u8: np.ndarray) -> torch.Tensor:
        with trace("towers.upload", items=len(pixels_u8),
                   nbytes=pixels_u8.nbytes):
            return torch.from_numpy(np.ascontiguousarray(pixels_u8)).to(
                device)

    def _fetch(emb: torch.Tensor) -> np.ndarray:
        with trace("towers.fetch", items=emb.shape[0],
                   nbytes=emb.numel() * emb.element_size()):
            return emb.cpu().numpy()

    def image_encode(pixels_u8: np.ndarray) -> np.ndarray:
        return _fetch(encode_fn(_upload(pixels_u8)))

    def image_encode_raw(pixels_u8: np.ndarray) -> np.ndarray:
        return _fetch(encode_fn(_upload(pixels_u8), normalize=False))

    text_encode = None
    if tokenizer is not None and make is TaiyiCLIP:
        def text_encode(texts):
            ids, mask = (torch.from_numpy(np.asarray(x)).to(device)
                         for x in tokenizer(texts))
            return clip.taiyi_encode_text(model, ids, mask,
                                          compute_dtype).cpu().numpy()
    elif tokenizer is not None:
        def text_encode(texts):
            ids = torch.from_numpy(tokenizer(texts)).to(device)
            return clip.encode_text(model, ids, compute_dtype).cpu().numpy()

    return Towers(image_encode=image_encode, text_encode=text_encode,
                  params=model, clip_config=ccfg, tokenizer=tokenizer,
                  encode_fn=encode_fn, image_encode_raw=image_encode_raw,
                  params_encode_fn=params_encode_fn)
