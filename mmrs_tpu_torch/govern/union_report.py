"""Bilingual union governance report (CLIP/union_dataset.py).

Given per-sample EN and CN similarities + thresholds:
  - union of passing BASENAMES (en_correct | cn_correct, :81-84);
  - copy union samples into union_samples/<class>/ with a per-file audit CSV
    (`_file_details.csv`: basename, en/cn sim, pass flags, source path,
    :97-114);
  - combined TP/FP/FN metrics deduped by basename via per-basename OR of
    the two detectors (:194-195, `calc_combined_metrics` :133-231).

A copy of mmrs_tpu/govern/union_report.py for the PyTorch port (no JAX).
"""

from __future__ import annotations

import csv
import os
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from mmrs_tpu_torch.search.metrics import PRF1, prf1_from_counts
from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class UnionSample:
    path: str
    basename: str
    is_positive: bool
    en_sim: float
    cn_sim: float


@dataclass
class UnionReport:
    cls: str
    en_threshold: float
    cn_threshold: float
    union_basenames: List[str]
    en_pass: int
    cn_pass: int
    union_pass: int
    metrics: PRF1
    copied: List[str] = field(default_factory=list)
    audit_csv: Optional[str] = None


def union_detect(
    samples: Sequence[UnionSample],
    en_threshold: float,
    cn_threshold: float,
) -> Dict[str, bool]:
    """Per-basename OR of the two tower detections."""
    detected: Dict[str, bool] = {}
    for s in samples:
        hit = (s.en_sim >= en_threshold) or (s.cn_sim >= cn_threshold)
        detected[s.basename] = detected.get(s.basename, False) or hit
    return detected


def combined_metrics(
    samples: Sequence[UnionSample],
    en_threshold: float,
    cn_threshold: float,
) -> PRF1:
    """TP/FP/FN over basenames, positives deduped by basename
    (calc_combined_metrics, CLIP/union_dataset.py:133-231)."""
    detected = union_detect(samples, en_threshold, cn_threshold)
    truth: Dict[str, bool] = {}
    for s in samples:
        truth[s.basename] = truth.get(s.basename, False) or s.is_positive
    tp = sum(1 for b, d in detected.items() if d and truth[b])
    fp = sum(1 for b, d in detected.items() if d and not truth[b])
    fn = sum(1 for b, d in detected.items() if not d and truth[b])
    return prf1_from_counts(tp, fp, fn)


def save_union_samples(
    samples: Sequence[UnionSample],
    cls: str,
    en_threshold: float,
    cn_threshold: float,
    out_root: str,
    copy_files: bool = True,
) -> UnionReport:
    """Copy every union-passing sample into out_root/<cls>/ and write the
    per-file audit CSV (save_correct_samples, CLIP/union_dataset.py:64-130)."""
    out_dir = os.path.join(out_root, cls)
    os.makedirs(out_dir, exist_ok=True)

    en_set = {s.basename for s in samples if s.en_sim >= en_threshold}
    cn_set = {s.basename for s in samples if s.cn_sim >= cn_threshold}
    union = sorted(en_set | cn_set)

    audit_path = os.path.join(out_dir, "_file_details.csv")
    copied: List[str] = []
    with open(audit_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow([
            "basename", "en_sim", "cn_sim", "en_pass", "cn_pass", "source_path",
        ])
        # several samples can share a basename (pos + neg dirs): the
        # audited/copied one must be a sample that itself PASSES — the
        # union sets are basename-level, so taking the first occurrence
        # could write a row whose own sims contradict its pass flags
        # and copy the non-passing file
        union_set = en_set | cn_set
        best = {}
        for s in samples:
            if s.basename not in union_set:
                continue
            passes = (s.en_sim >= en_threshold or s.cn_sim >= cn_threshold)
            cur = best.get(s.basename)
            if cur is None or (passes and not cur[0]):
                best[s.basename] = (passes, s)
        for s in (v[1] for v in best.values()):
            writer.writerow([
                s.basename, f"{s.en_sim:.6f}", f"{s.cn_sim:.6f}",
                int(s.en_sim >= en_threshold), int(s.cn_sim >= cn_threshold),
                s.path,
            ])
            if copy_files:
                try:
                    shutil.copy(s.path, os.path.join(out_dir, s.basename))
                    copied.append(s.basename)
                except OSError as e:
                    log.warning("copy failed for %s: %r", s.path, e)

    return UnionReport(
        cls=cls,
        en_threshold=en_threshold,
        cn_threshold=cn_threshold,
        union_basenames=union,
        en_pass=len(en_set),
        cn_pass=len(cn_set),
        union_pass=len(union),
        metrics=combined_metrics(samples, en_threshold, cn_threshold),
        copied=copied,
        audit_csv=audit_path,
    )
