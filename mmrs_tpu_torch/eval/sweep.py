"""Confusable-pair threshold-sweep harness (CLIP/lab3.py and
CLIP-Chinese/lab_chinese.py).

A copy of mmrs_tpu/eval/sweep.py for the PyTorch port (numpy only).

For each (positive class, confusable negative class) pair — dog/wolf,
cat/lynx, porcelain/pottery, horse/donkey, ink painting/oil painting
(CLIP/lab3.py classes; 狗/狼 etc. for the Chinese mirror) — sweep raw-cosine
thresholds over arange(0, 1.001, 0.001) and report the F1-optimal point,
with per-pair CSV and a summary CSV (:119-151).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from mmrs_tpu_torch.search.calibrate import SweepResult, evaluate_thresholds

# The reference's evaluation pairs (CLIP/lab3.py; positive vs confusable)
DEFAULT_PAIRS = (
    ("dog", "wolf"),
    ("cat", "lynx"),
    ("porcelain", "pottery"),
    ("horse", "donkey"),
    ("ink painting", "oil painting"),
)

CHINESE_PAIRS = (
    ("狗", "狼"),
    ("猫", "猞猁"),
    ("瓷器", "陶器"),
    ("马", "驴"),
    ("水墨画", "油画"),
)


@dataclass
class PairSweep:
    positive: str
    negative: str
    result: SweepResult


def pair_threshold_sweep(
    pos_sims: Dict[str, np.ndarray],    # positive class -> sims of its images
    neg_sims: Dict[str, np.ndarray],    # same keyed by the PAIR's positive
    pairs: Sequence[Tuple[str, str]] = DEFAULT_PAIRS,
) -> Dict[str, PairSweep]:
    """For each (pos, neg) pair, both sim sets are similarities of images to
    the POSITIVE class's text prompt; the sweep finds the threshold
    separating them."""
    out: Dict[str, PairSweep] = {}
    for pos, neg in pairs:
        if pos not in pos_sims or pos not in neg_sims:
            continue
        res = evaluate_thresholds(pos_sims[pos], neg_sims[pos])
        out[pos] = PairSweep(positive=pos, negative=neg, result=res)
    return out


def write_sweep_csv(sweeps: Dict[str, PairSweep], out_dir: str) -> str:
    """Per-pair curve CSVs + summary.csv (CLIP/lab3.py:134-151 artifacts)."""
    os.makedirs(out_dir, exist_ok=True)
    summary = os.path.join(out_dir, "summary.csv")
    with open(summary, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["positive", "negative", "best_threshold", "best_f1",
                    "best_precision", "best_recall"])
        for pos, sweep in sweeps.items():
            r = sweep.result
            w.writerow([pos, sweep.negative, f"{r.best_threshold:.6f}",
                        f"{r.best_f1:.6f}", f"{r.best_precision:.6f}",
                        f"{r.best_recall:.6f}"])
            pair_csv = os.path.join(out_dir, f"sweep_{pos.replace(' ', '_')}.csv")
            with open(pair_csv, "w", newline="", encoding="utf-8") as pf:
                pw = csv.writer(pf)
                pw.writerow(["threshold", "precision", "recall", "f1"])
                for t, p, rc, f1 in zip(r.thresholds, r.precision, r.recall,
                                        r.f1):
                    pw.writerow([f"{t:.3f}", f"{p:.6f}", f"{rc:.6f}",
                                 f"{f1:.6f}"])
    return summary
