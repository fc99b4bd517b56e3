"""Classification/retrieval metrics.

Counterpart of mmrs_tpu/search/metrics.py. Reference semantics:
  - per-class precision/recall/F1 from TP/FP/FN with divide-by-zero guards
    (CLIP/lab1.py:107-124: 0.0 where a denominator is 0);
  - top-k accuracy with an optional excluded class (reference `cls_acc`,
    code/utils.py:15-39), on tensors, in f32 as the JAX package's;
  - macro-F1 via a bincount confusion matrix (reference `cls_f1`,
    code/utils.py:41-76).
The P/R/F1 counts run on the host in numpy (the inputs are small host
arrays: the same integers as the JAX package's jnp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch


@dataclass
class PRF1:
    precision: float
    recall: float
    f1: float
    tp: int
    fp: int
    fn: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "precision": self.precision,
            "recall": self.recall,
            "f1": self.f1,
            "tp": self.tp,
            "fp": self.fp,
            "fn": self.fn,
        }


def prf1_from_counts(tp: int, fp: int, fn: int) -> PRF1:
    """Guarded precision/recall/F1 (CLIP/lab1.py:114-117 semantics)."""
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if (precision + recall) > 0
        else 0.0
    )
    return PRF1(precision, recall, f1, int(tp), int(fp), int(fn))


def binary_prf1(preds, labels) -> PRF1:
    """P/R/F1 for binary predictions; positive == 1 (the reference's
    `eval`, code/union_clip_llava2.py:274-291)."""
    preds = np.asarray(preds).astype(bool)
    labels = np.asarray(labels).astype(bool)
    tp = int(np.sum(preds & labels))
    fp = int(np.sum(preds & ~labels))
    fn = int(np.sum(~preds & labels))
    return prf1_from_counts(tp, fp, fn)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def topk_accuracy(
    logits,                 # [N, C] tensor or array
    labels,                 # [N] int
    topk: int = 1,
    exclude_class: Optional[int] = None,
) -> float:
    """Top-k accuracy, optionally masking out samples of one class.

    Reference: `cls_acc` (code/utils.py:15-39): samples whose true label
    is `exclude_class` are dropped from numerator and denominator. Ties
    rank the lower class first (a stable sort). In f32 as the JAX
    package's: the excluded form divides, the mean multiplies the count by
    f32(1 / N) (XLA's rewrite of a division by a constant)."""
    logits = _tensor(logits)
    labels = _tensor(labels).to(logits.device)
    k = min(topk, logits.shape[-1])
    top = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    correct = (top == labels[:, None]).any(dim=-1)
    if exclude_class is not None:
        keep = labels != exclude_class
        denom = int(keep.sum())
        if denom == 0:
            return 0.0
        return float(np.float32(int((correct & keep).sum()))
                     / np.float32(denom))
    return float(np.float32(int(correct.sum()))
                 * (np.float32(1.0) / np.float32(correct.numel())))


def confusion_matrix(preds, labels, num_classes: int) -> torch.Tensor:
    """[C, C] int32 confusion matrix (rows = true, cols = predicted) via
    bincount (code/utils.py:41-76)."""
    preds = _tensor(preds).long()
    labels = _tensor(labels).long().to(preds.device)
    counts = torch.bincount(labels * num_classes + preds,
                            minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).to(torch.int32)


def macro_f1(
    preds,
    labels,
    num_classes: int,
    exclude_class: Optional[int] = None,
) -> float:
    """Macro-averaged F1 over classes (reference `cls_f1`,
    code/utils.py:41-76), on the host in f64 numpy as the JAX package's."""
    preds_a = _host(preds).astype(np.int64)
    labels_a = _host(labels).astype(np.int64)
    cm = np.bincount(labels_a * num_classes + preds_a,
                     minlength=num_classes * num_classes
                     ).reshape(num_classes, num_classes).astype(np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall
                      / np.maximum(precision + recall, 1e-12), 0.0)
    if exclude_class is not None:
        mask = np.arange(num_classes) != exclude_class
        return float(np.sum(f1 * mask) / max(int(np.sum(mask)), 1))
    return float(np.mean(f1))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def per_class_report(
    preds: Sequence[int],
    labels: Sequence[int],
    class_names: Sequence[str],
) -> Dict[str, PRF1]:
    """Per-class one-vs-rest P/R/F1 table (CLIP/lab1.py:107-140 output
    shape)."""
    preds_a = _host(preds)
    labels_a = _host(labels)
    out: Dict[str, PRF1] = {}
    for idx, name in enumerate(class_names):
        tp = int(np.sum((preds_a == idx) & (labels_a == idx)))
        fp = int(np.sum((preds_a == idx) & (labels_a != idx)))
        fn = int(np.sum((preds_a != idx) & (labels_a == idx)))
        out[name] = prf1_from_counts(tp, fp, fn)
    return out
