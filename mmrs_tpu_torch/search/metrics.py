"""Precision/recall/F1 for the cascade, on the host in numpy.

Counterpart of the part of mmrs_tpu/search/metrics.py the cascade uses
(which computes in jnp; the inputs are small host arrays, so numpy gives
the same integers): guarded P/R/F1 from TP/FP/FN (CLIP/lab1.py
semantics: 0.0 where a denominator is 0). Top-k accuracy, the confusion
matrix and macro-F1 come with the evaluation modules (ROADMAP A.3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


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
