"""F1-optimal threshold calibration — vectorized on the device.

Counterpart of mmrs_tpu/search/calibrate.py (`find_thresholds`,
code/search_image.py:58-103: a 200-point linspace between the min and max
observed similarity; `find_thresholds_overlap`, code/main_custom.py:47-50;
`evaluate_thresholds`, the fixed 0..1 raw-cosine grid of CLIP/lab3.py:39-65,
also `grid_thresholds` mode "arange"; `plot_f1_curve`, the F1 curve
image). The sweep is one broadcast comparison
per chunk: sims [N] x thresholds [T] -> boolean [T, chunk] -> per-threshold
TP/FP/FN counts. Divide-by-zero is guarded (SURVEY.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.config import CalibrationConfig


@dataclass
class SweepResult:
    thresholds: np.ndarray  # [T]
    precision: np.ndarray   # [T]
    recall: np.ndarray      # [T]
    f1: np.ndarray          # [T]
    best_threshold: float
    best_f1: float
    best_precision: float
    best_recall: float


def _sweep_counts(
    sims: torch.Tensor,        # [N] float
    positives: torch.Tensor,   # [N] bool
    thresholds: torch.Tensor,  # [T] float
    chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-threshold (tp, fp, fn) int32 counts, chunked over N."""
    t = thresholds.shape[0]
    tp, fp, fn = (torch.zeros(t, dtype=torch.int64, device=sims.device)
                  for _ in range(3))
    for a in range(0, sims.shape[0], chunk):
        s, p = sims[a:a + chunk], positives[a:a + chunk]
        pred = s[None, :] >= thresholds[:, None]                # [T, chunk]
        tp += (pred & p).sum(dim=1)
        fp += (pred & ~p).sum(dim=1)
        fn += (~pred & p).sum(dim=1)
    return tp.int(), fp.int(), fn.int()


def sweep(
    sims: np.ndarray,
    positives: np.ndarray,
    thresholds: Optional[np.ndarray] = None,
    config: Optional[CalibrationConfig] = None,
) -> SweepResult:
    """Full threshold sweep; returns per-threshold P/R/F1 and the F1-argmax.

    `sims`: similarity of each sample to the query/prototype.
    `positives`: boolean ground-truth per sample.
    """
    cfg = config or CalibrationConfig()
    sims = np.asarray(sims, dtype=np.float32)
    positives = np.asarray(positives, dtype=bool)
    if thresholds is None:
        thresholds = grid_thresholds(cfg, float(sims.min()),
                                     float(sims.max()))
    tp, fp, fn = _sweep_counts(
        torch.from_numpy(sims), torch.from_numpy(positives),
        torch.from_numpy(np.asarray(thresholds, np.float32)))
    return result_from_counts(thresholds, tp, fp, fn)


def grid_thresholds(cfg, lo: float, hi: float,
                    scale: float = 1.0) -> np.ndarray:
    """Threshold grid for a sweep (engine.sweep_class shares it). linspace
    spans the observed [lo, hi]; arange is the reference's ABSOLUTE
    raw-cosine 0..1 grid, multiplied by `scale` when the sims being swept
    are logit-scaled."""
    if cfg.mode == "linspace":
        return np.linspace(lo, hi, cfg.num_points, dtype=np.float32)
    if cfg.mode == "arange":
        grid = np.arange(0.0, cfg.arange_stop, cfg.arange_step,
                         dtype=np.float32)
        return (grid * scale).astype(np.float32) if scale != 1.0 else grid
    raise ValueError(f"unknown calibration mode {cfg.mode!r}")


def result_from_counts(thresholds, tp, fp, fn) -> SweepResult:
    """Per-threshold (tp, fp, fn) counts -> guarded P/R/F1 + F1-argmax."""
    tp, fp, fn = (np.asarray(torch.as_tensor(c).cpu(), dtype=np.float64)
                  for c in (tp, fp, fn))
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(
            precision + recall > 0,
            2 * precision * recall / np.maximum(precision + recall, 1e-12),
            0.0,
        )
    best = int(np.argmax(f1))
    return SweepResult(
        thresholds=np.asarray(thresholds),
        precision=precision,
        recall=recall,
        f1=f1,
        best_threshold=float(thresholds[best]),
        best_f1=float(f1[best]),
        best_precision=float(precision[best]),
        best_recall=float(recall[best]),
    )


def find_thresholds(
    pos_sims: np.ndarray,
    neg_sims: np.ndarray,
    num_points: int = 200,
) -> SweepResult:
    """The `find_thresholds` contract (code/search_image.py:58-103):
    positive-set and negative-set similarities in, 200-point linspace over
    the pooled range, best-F1 threshold out."""
    _, _, sims, positives = _pooled(pos_sims, neg_sims)
    lo, hi = float(sims.min()), float(sims.max())
    thresholds = np.linspace(lo, hi, num_points, dtype=np.float32)
    return sweep(sims, positives, thresholds)


def _pooled(pos_sims, neg_sims):
    pos_sims = np.asarray(pos_sims, dtype=np.float32)
    neg_sims = np.asarray(neg_sims, dtype=np.float32)
    sims = np.concatenate([pos_sims, neg_sims])
    positives = np.concatenate(
        [np.ones(len(pos_sims), bool), np.zeros(len(neg_sims), bool)])
    return pos_sims, neg_sims, sims, positives


def find_thresholds_overlap(
    pos_sims: np.ndarray,
    neg_sims: np.ndarray,
    points_per_unit: float = 10.0,
) -> SweepResult:
    """The main_custom.py variant (code/main_custom.py:47-50): thresholds
    span only the OVERLAP region [max(min_pos, min_neg), min(max_pos,
    max_neg)] with a density-scaled point count of int(range * 10) —
    meant for logit-scaled (0..100) similarities."""
    pos_sims, neg_sims, sims, positives = _pooled(pos_sims, neg_sims)
    lo = max(float(pos_sims.min()), float(neg_sims.min()))
    hi = min(float(pos_sims.max()), float(neg_sims.max()))
    num = max(int((hi - lo) * points_per_unit), 2)
    thresholds = np.linspace(lo, hi, num, dtype=np.float32)
    return sweep(sims, positives, thresholds)


def plot_f1_curve(result: SweepResult, target_class: str,
                  out_path: str) -> str:
    """The reference's F1-vs-threshold curve artifact
    (code/search_image.py:87-100, result_{class}_all.jpg). matplotlib is
    imported here, on call: nothing else in the package needs it."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(9, 9))
    plt.plot(result.thresholds, result.f1)
    plt.scatter(x=result.best_threshold, y=result.best_f1)
    plt.annotate(
        f"threshold:{result.best_threshold:.5f}/f1:{result.best_f1:.5f}",
        xy=(result.best_threshold, result.best_f1),
    )
    plt.xlabel("threshold")
    plt.ylabel("f1_score")
    plt.title(
        f"{target_class}_precision:{result.best_precision:.4f}"
        f"_recall:{result.best_recall:.4f}"
    )
    plt.savefig(out_path)
    plt.close()
    return out_path


def evaluate_thresholds(
    pos_sims: np.ndarray,
    neg_sims: np.ndarray,
    stop: float = 1.001,
    step: float = 0.001,
) -> SweepResult:
    """The `evaluate_thresholds` contract (CLIP/lab3.py:39-65): fixed
    arange(0, 1.001, 0.001) raw-cosine grid."""
    _, _, sims, positives = _pooled(pos_sims, neg_sims)
    thresholds = np.arange(0.0, stop, step, dtype=np.float32)
    return sweep(sims, positives, thresholds)
