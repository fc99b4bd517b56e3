"""Image preprocessing: host decode/resize (PIL-parity) + device normalize.

Counterpart of mmrs_tpu/ops/preprocess.py. Decode, BICUBIC resize and
center crop stay on the host with PIL-identical math (rank parity with the
reference depends on it; CLIP/lab1.py:26 `preprocess(img)`); the batch
travels host -> device as uint8 and the per-pixel affine
(x / 255 - mean) / std -> bf16 runs on the device. On a CUDA tensor that
affine is the Triton kernel `csrc/normalize_triton.py`; on a CPU tensor it
is the plain PyTorch version below.

CLIP normalization constants from code/custom.py:28 (the default); a
tower with its own (SigLIP: 0.5 and 0.5) passes them. Host geometry:
`resize_center_crop` (CLIP) or `resize_square` (SigLIP: no crop).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.ops import _cuda

# OpenAI CLIP constants (code/custom.py:28)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_BLOCK = 4096         # elements per Triton program


@lru_cache(maxsize=None)
def _affine32(mean: Tuple[float, ...], std: Tuple[float, ...]):
    """The f32 values both versions use: mean, and 1/std divided in f32."""
    return (tuple(float(np.float32(m)) for m in mean),
            tuple(float(np.float32(1.0) / np.float32(s)) for s in std))


# --------------------------------------------------------------------------
# Host side: PIL-parity resize + center crop (matches clip.load preprocess)
# --------------------------------------------------------------------------

def resize_center_crop(img, size: int = 224):
    """PIL path of OpenAI CLIP preprocess: BICUBIC resize of the SHORT side
    to `size`, then center crop size x size. Returns HWC uint8 ndarray."""
    from PIL import Image

    w, h = img.size
    # torchvision Resize floors the long side (int(), not round()):
    # _compute_resized_output_size -> int(size * long / short).
    if w < h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def hf_resize_center_crop(img, size: int = 224):
    """HF CLIPImageProcessor path (used by the Chinese tower,
    CLIP-Chinese/lab_chinese.py:29). HF's shortest-edge resize + center
    crop coincides with the torchvision stack, so this is an alias, not a
    duplicate implementation."""
    return resize_center_crop(img, size)


def resize_square(img, size: int = 384):
    """HF SiglipImageProcessor's geometry: BICUBIC resize of the whole
    image to size x size, no crop. Returns HWC uint8 ndarray."""
    from PIL import Image

    img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


# --------------------------------------------------------------------------
# Device side: fused uint8 -> normalized bf16
# --------------------------------------------------------------------------

def _normalize_torch(images_u8: torch.Tensor, dtype: torch.dtype,
                     affine=None) -> torch.Tensor:
    mean32, inv_std32 = affine or _affine32(CLIP_MEAN, CLIP_STD)
    x = images_u8.to(torch.float32) * (1.0 / 255.0)
    mean = torch.tensor(mean32, dtype=torch.float32, device=x.device)
    inv_std = torch.tensor(inv_std32, dtype=torch.float32, device=x.device)
    return ((x - mean) * inv_std).to(dtype)


def _normalize_triton(images_u8: torch.Tensor, dtype: torch.dtype,
                      affine=None) -> torch.Tensor:
    _cuda.require_cuda("normalize_images", images_u8)
    if images_u8.dtype != torch.uint8 or images_u8.shape[-1] != 3:
        raise ValueError(f"normalize_images takes uint8 [..., 3], got "
                         f"{images_u8.dtype} {tuple(images_u8.shape)}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"normalize_images writes bf16 or f32, not {dtype}")
    n = images_u8.numel()
    if n >= 2 ** 31:
        raise ValueError(f"normalize_images kernel takes < 2^31 elements, "
                         f"got {n}")
    mean32, inv_std32 = affine or _affine32(CLIP_MEAN, CLIP_STD)
    kernel = _cuda.triton_module("normalize_triton").normalize_kernel
    out = torch.empty(images_u8.shape, dtype=dtype, device=images_u8.device)
    with torch.cuda.device(images_u8.device):
        kernel[(-(-n // _BLOCK),)](images_u8, out, n, *mean32, *inv_std32,
                                  BLOCK=_BLOCK, num_warps=8)
    normalize_images.launches += 1
    return out


def normalize_images(
    images_u8: torch.Tensor,        # [B, H, W, 3] uint8
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
    mean: Sequence[float] = CLIP_MEAN,
    std: Sequence[float] = CLIP_STD,
) -> torch.Tensor:
    """(x/255 - mean) / std per channel, output in the compute dtype. On a
    CUDA tensor the Triton kernel runs, or this raises."""
    kernel = _cuda.takes_kernel(impl, images_u8)
    affine = _affine32(tuple(mean), tuple(std))
    if kernel:
        return _normalize_triton(images_u8, dtype, affine)
    return _normalize_torch(images_u8, dtype, affine)


normalize_images.launches = 0   # kernel launches, for showing the path ran it
