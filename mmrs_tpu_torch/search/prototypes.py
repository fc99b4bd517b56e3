"""K-shot prototype construction.

Counterpart of mmrs_tpu/search/prototypes.py (code/search_image.py:119-318):
  - mean:            L2-normalized mean of the shot embeddings;
  - image_text_mean: (normalized mean image embedding + normalized text
                     embedding) / 2, renormalized (code/search_image.py:387);
  - cluster:         k-means (k=2) majority-cluster centroid with the 20%
                     balance rule (code/search_image.py:185-232): if the
                     minority holds >= balance_ratio of the shots, the split
                     is ambiguity and the plain mean is used instead;
  - cluster_scan:    the best-silhouette k of (2, 3, 4), then `cluster`
                     (code/search_image.py:234-293);
  - robust_mean:     drop the shots whose cosine distance to the mean is
                     above a percentile, then re-mean
                     (code/search_image.py:295-318).
Every strategy returns an L2-normalized [D] f32 vector.
"""

from __future__ import annotations

import numpy as np
import torch

from mmrs_tpu_torch.ops.kmeans import kmeans, silhouette_score
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


def cluster_prototype(feats, k: int = 2, balance_ratio: float = 0.2
                      ) -> torch.Tensor:
    """Majority-cluster centroid with the reference's balance rule."""
    feats32 = _as_f32(feats)
    cents, assign = kmeans(feats32, k=k)
    counts = torch.bincount(assign, minlength=k).float()
    major = torch.argmax(counts)
    minor_frac = 1.0 - counts[major] / feats32.shape[0]
    proto = torch.where(minor_frac >= balance_ratio, feats32.mean(dim=0),
                        cents[major])
    return l2_normalize(proto)


def robust_mean_prototype(feats, percentile: float = 95.0) -> torch.Tensor:
    """Outlier-filtered mean: drop shots whose cosine distance to the mean
    is above the given percentile (linear interpolation, as
    `jnp.percentile`), then re-mean."""
    feats32 = l2_normalize(_as_f32(feats))
    center = l2_normalize(feats32.mean(dim=0))
    dist = 1.0 - feats32 @ center
    cutoff = torch.quantile(dist, percentile / 100.0)
    keep = (dist <= cutoff).float()
    robust = (feats32 * keep[:, None]).sum(0) / keep.sum().clamp_min(1.0)
    return l2_normalize(robust)


def cluster_scan_prototype(feats, k_range=(2, 3, 4),
                           balance_ratio: float = 0.2) -> torch.Tensor:
    """Silhouette-scanned cluster prototype: the k of `k_range` with the
    best mean silhouette, then its majority-cluster centroid under the
    same balance rule; the plain mean when no k fits the shots."""
    feats32 = _as_f32(feats)
    best_k, best_score = None, float("-inf")
    for k in k_range:
        if feats32.shape[0] <= k:
            continue
        _, assign = kmeans(feats32, k=k)
        score = float(silhouette_score(feats32, assign, k))
        if score > best_score:
            best_k, best_score = k, score
    if best_k is None:
        return mean_prototype(feats32)
    return cluster_prototype(feats32, k=best_k, balance_ratio=balance_ratio)


def build_prototype(feats, strategy: str = "mean", text_embed=None,
                    cluster_k: int = 2, balance_ratio: float = 0.2,
                    outlier_percentile: float = 95.0) -> torch.Tensor:
    """Dispatch over the reference strategies by name."""
    if strategy == "mean":
        return mean_prototype(feats)
    if strategy == "image_text_mean":
        if text_embed is None:
            raise ValueError("image_text_mean requires text_embed")
        return image_text_prototype(feats, text_embed)
    if strategy == "cluster":
        return cluster_prototype(feats, k=cluster_k,
                                 balance_ratio=balance_ratio)
    if strategy == "cluster_scan":
        return cluster_scan_prototype(feats, balance_ratio=balance_ratio)
    if strategy == "robust_mean":
        return robust_mean_prototype(feats, percentile=outlier_percentile)
    raise ValueError(f"unknown prototype strategy {strategy!r}")
