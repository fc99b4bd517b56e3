"""Zero-shot evaluation harnesses (CLIP/lab1.py and CLIP/lab2.py).

Counterpart of mmrs_tpu/eval/zeroshot.py. Features may be torch tensors
(on any device) or arrays; they are brought to the host once and scored
in f32 numpy, as the JAX package scores them, so predictions, tables and
probabilities are the JAX package's.

Feature-level: callers pass L2-normalized image features and per-class text
features (tower-agnostic — EN CLIP or the Taiyi pair both fit).

  - multiclass_zeroshot: softmax(100 * I @ T^T) argmax over the class
    prompts (+"others"), per-class TP/FP/FN/TN and P/R/F1 plus accuracy
    (CLIP/lab1.py:80-140), CSV writer matching its table (:143-148).
  - binary_zeroshot: per-target "a photo of X" vs "a photo that is not X"
    argmax (CLIP/lab2.py:56-130).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Dict, Sequence, Union

import numpy as np
import torch

from mmrs_tpu_torch.search.metrics import (PRF1, per_class_report,
                                           prf1_from_counts)

Feats = Union[torch.Tensor, np.ndarray]


def _f32(x) -> np.ndarray:
    """A host f32 array of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@dataclass
class MulticlassResult:
    accuracy: float
    macro_f1: float
    per_class: Dict[str, PRF1]
    preds: np.ndarray
    probs: np.ndarray


def multiclass_zeroshot(
    image_feats: Feats,      # [N, D] normalized
    text_feats: Feats,       # [C, D] normalized (one prompt per class)
    labels: Sequence[int],
    class_names: Sequence[str],
    scale: float = 100.0,
) -> MulticlassResult:
    logits = scale * _f32(image_feats) @ _f32(text_feats).T
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    preds = probs.argmax(axis=1)
    labels = np.asarray(labels)
    per_class = per_class_report(preds, labels, class_names)
    f1s = [m.f1 for m in per_class.values()]
    return MulticlassResult(
        accuracy=float((preds == labels).mean()),
        macro_f1=float(np.mean(f1s)),
        per_class=per_class,
        preds=preds,
        probs=probs,
    )


@dataclass
class BinaryResult:
    per_target: Dict[str, PRF1]
    mean_f1: float


def binary_zeroshot(
    image_feats_by_target: Dict[str, Feats],   # target -> [N, D]
    pos_text_feats: Dict[str, Feats],          # target -> [D]
    neg_text_feats: Dict[str, Feats],          # target -> [D]
    labels_by_target: Dict[str, Sequence[bool]],
    scale: float = 100.0,
) -> BinaryResult:
    """CLIP/lab2.py: argmax over {pos prompt, neg prompt} per target."""
    out: Dict[str, PRF1] = {}
    for target, feats in image_feats_by_target.items():
        t = np.stack([_f32(pos_text_feats[target]),
                      _f32(neg_text_feats[target])])
        logits = scale * _f32(feats) @ t.T
        preds = logits.argmax(axis=1) == 0         # 0 = positive prompt
        labels = np.asarray(labels_by_target[target], bool)
        tp = int(np.sum(preds & labels))
        fp = int(np.sum(preds & ~labels))
        fn = int(np.sum(~preds & labels))
        out[target] = prf1_from_counts(tp, fp, fn)
    mean_f1 = float(np.mean([m.f1 for m in out.values()])) if out else 0.0
    return BinaryResult(per_target=out, mean_f1=mean_f1)


def write_multiclass_csv(result: MulticlassResult, path: str) -> None:
    """CSV table in the CLIP/lab1.py:143-148 shape."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["class", "precision", "recall", "f1", "tp", "fp", "fn"])
        for name, m in result.per_class.items():
            w.writerow([name, f"{m.precision:.6f}", f"{m.recall:.6f}",
                        f"{m.f1:.6f}", m.tp, m.fp, m.fn])
        w.writerow(["__accuracy__", f"{result.accuracy:.6f}", "", "", "", "", ""])
        w.writerow(["__macro_f1__", f"{result.macro_f1:.6f}", "", "", "", "", ""])
