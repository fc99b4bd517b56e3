"""K-shot prototype construction.

Counterpart of mmrs_tpu/search/prototypes.py (code/search_image.py:119-318):
  - mean:            L2-normalized mean of the shot embeddings;
  - image_text_mean: (normalized mean image embedding + normalized text
                     embedding) / 2, renormalized (code/search_image.py:387).
The k-means cluster strategies and the outlier-filtered robust mean are
ported with ROADMAP A.7. Every strategy returns an L2-normalized [D] f32
vector.
"""

from __future__ import annotations

import numpy as np
import torch

from mmrs_tpu_torch.ops.normalize import l2_normalize


def _as_f32(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.float()


def mean_prototype(feats) -> torch.Tensor:
    """feats [K, D] -> normalized mean [D]."""
    return l2_normalize(_as_f32(feats).mean(dim=0))


def image_text_prototype(feats, text_embed) -> torch.Tensor:
    v = l2_normalize(_as_f32(feats).mean(dim=0))
    t = l2_normalize(_as_f32(text_embed).to(v.device))
    return l2_normalize((v + t) / 2.0)


def build_prototype(feats, strategy: str = "mean", text_embed=None
                    ) -> torch.Tensor:
    """Dispatch over the reference strategies by name."""
    if strategy == "mean":
        return mean_prototype(feats)
    if strategy == "image_text_mean":
        if text_embed is None:
            raise ValueError("image_text_mean requires text_embed")
        return image_text_prototype(feats, text_embed)
    if strategy in ("cluster", "cluster_scan", "robust_mean"):
        raise NotImplementedError(
            f"prototype strategy {strategy!r} is ported with ROADMAP A.7 "
            f"(k-means and the outlier filter)")
    raise ValueError(f"unknown prototype strategy {strategy!r}")
