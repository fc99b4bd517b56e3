"""Train-time augmentation for cache-model building.

Copy of mmrs_tpu/io/augment.py: numpy and PIL only, so a seed gives the
same crops and the same pixels in both packages.

Reference: code/custom.py:24-29 — RandomResizedCrop(224, scale=(0.5, 1.0),
bicubic) + RandomHorizontalFlip + CLIP normalize. The crop-parameter
sampling reproduces torchvision's RandomResizedCrop.get_params (10 tries of
area/ratio sampling, then center fallback); normalize happens on the device via
ops/preprocess.normalize_images (K3 on a GPU).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np


def random_resized_crop_params(
    width: int,
    height: int,
    rng: random.Random,
    scale: Tuple[float, float] = (0.5, 1.0),
    ratio: Tuple[float, float] = (3 / 4, 4 / 3),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: returns (top, left, h, w)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = rng.randint(0, height - h)
            left = rng.randint(0, width - w)
            return top, left, h, w
    # center fallback
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def augment_image(
    img,                      # PIL RGB image
    size: int = 224,
    rng: Optional[random.Random] = None,
    scale: Tuple[float, float] = (0.5, 1.0),
    hflip_prob: float = 0.5,
) -> np.ndarray:
    """One augmented view: RandomResizedCrop(size, scale, bicubic) + HFlip.
    Returns [size, size, 3] uint8 (device normalize comes later)."""
    from PIL import Image

    rng = rng or random.Random()
    w, h = img.size
    top, left, ch, cw = random_resized_crop_params(w, h, rng, scale)
    img = img.resize(
        (size, size), Image.BICUBIC, box=(left, top, left + cw, top + ch)
    )
    if rng.random() < hflip_prob:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img.convert("RGB"), dtype=np.uint8)


def augmented_epochs(
    paths,
    epochs: int,
    size: int = 224,
    seed: int = 0,
):
    """Yield `epochs` lists of augmented uint8 batches, one view per image
    per epoch — the augment_epoch loop of build_cache_model
    (code/utils.py:104-118)."""
    from mmrs_tpu_torch.io.images import pil_loader

    for e in range(epochs):
        rng = random.Random((seed, e).__hash__())
        views = []
        for p in paths:
            with pil_loader(p) as img:
                views.append(augment_image(img, size, rng))
        yield np.stack(views)
