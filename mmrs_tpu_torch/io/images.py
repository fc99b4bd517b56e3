"""Transparency-aware, error-tolerant image loading.

Reference behaviors reproduced:
  - `has_transparency` + `pil_loader` (clip_en.ipynb cell 8,
    code/merge_dataset.py:34-58): images with an alpha channel are
    composited onto a WHITE background before RGB conversion (also the
    tool/Image format conversion.py:49-53 behavior).
  - corrupt images don't crash the pipeline: they are quarantined with an
    error flag and a zero tensor placeholder (CLIP/lab1.py:27-30 returns
    zeros(3,224,224) + "error" label, filtered downstream at :81).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass
from typing import Optional

import numpy as np


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tiff", ".webp")


def has_transparency(img) -> bool:
    """True if the PIL image carries any alpha information.

    P-mode transparency always arrives via img.info['transparency'] (a
    palette index or per-index bytes), which the first check covers —
    there is no separate palette scan to do (an earlier index==
    transparent loop here was unreachable: it only ran when the info
    key was absent)."""
    if img.info.get("transparency", None) is not None:
        return True
    if img.mode in ("RGBA", "LA"):
        extrema = img.getextrema()
        if extrema[-1][0] < 255:
            return True
    return False


def pil_loader(path_or_bytes):
    """Open an image; composite alpha onto white; return RGB PIL image."""
    from PIL import Image

    if isinstance(path_or_bytes, (bytes, bytearray)):
        img = Image.open(_io.BytesIO(path_or_bytes))
    else:
        img = Image.open(path_or_bytes)
    if img.mode in ("RGBA", "LA", "PA") or has_transparency(img):
        img = img.convert("RGBA")
        background = Image.new("RGBA", img.size, (255, 255, 255, 255))
        img = Image.alpha_composite(background, img)
    return img.convert("RGB")


@dataclass
class ImageLoadResult:
    pixels: np.ndarray          # [H, W, 3] uint8 (zeros if error)
    ok: bool
    path: str
    error: Optional[str] = None


def load_image(path: str, size: int = 224, stack: str = "openai") -> ImageLoadResult:
    """Decode + resize (+ center-crop) one image with quarantine-on-error.

    stack: "openai" (clip.load preprocess geometry), "hf" (CLIPProcessor)
    or "siglip" (SiglipImageProcessor: the whole image resized to size x
    size, bicubic, no crop).
    """
    from mmrs_tpu_torch.ops.preprocess import (hf_resize_center_crop,
                                               resize_center_crop,
                                               resize_square)

    fn = {"openai": resize_center_crop, "hf": hf_resize_center_crop,
          "siglip": resize_square}.get(stack)
    if fn is None:
        raise ValueError(f"unknown preprocessing stack {stack!r}")
    try:
        img = pil_loader(path)
        return ImageLoadResult(fn(img, size), True, path)
    except Exception as e:  # noqa: BLE001 — quarantine ANY decode failure
        return ImageLoadResult(
            np.zeros((size, size, 3), np.uint8), False, path, repr(e)
        )
