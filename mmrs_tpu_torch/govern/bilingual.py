"""Bilingual (EN + CN) union governance driver.

The `CLIP/union_dataset.py:263-425` main flow, composed from framework
pieces: score a folder dataset with BOTH tower pairs (each with ITS OWN
preprocessing stack — OpenAI geometry for ViT-B/32, HF geometry for
ViT-L/14+Taiyi, SURVEY.md §7 hard-part), calibrate per-pair thresholds on a
labeled calibration set (or take provided thresholds), then produce the
union report: passing-set union, sample copies, audit CSVs, combined
metrics deduped by basename.

A copy of mmrs_tpu/govern/bilingual.py for the PyTorch port: the
encoders it takes are the port's (pipeline.build_towers), on the card
unless the CPU is asked for.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from mmrs_tpu_torch.govern.union_report import UnionReport, UnionSample, save_union_samples
from mmrs_tpu_torch.io.dataset import FolderDataset
from mmrs_tpu_torch.search.calibrate import evaluate_thresholds
from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def score_dataset(
    dataset: FolderDataset,
    image_encode: Callable[[np.ndarray], np.ndarray],
    text_embed: np.ndarray,          # [D] normalized class text embedding
    batch_size: int = 128,
) -> Tuple[List[str], List[str], np.ndarray]:
    """-> (paths, classes, cosine sims vs the class text embedding)."""
    paths: List[str] = []
    classes: List[str] = []
    sims: List[np.ndarray] = []
    t = np.asarray(text_embed, np.float32)
    t = t / np.linalg.norm(t)
    for batch in dataset.batches(batch_size, drop_errors=True):
        emb = np.asarray(image_encode(batch.pixels), np.float32)
        emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        sims.append(emb @ t)
        paths.extend(batch.paths)
        classes.extend(batch.labels)
    return paths, classes, (np.concatenate(sims) if sims else np.zeros(0))


@dataclass
class BilingualResult:
    cls: str
    en_threshold: float
    cn_threshold: float
    en_best_f1: float
    cn_best_f1: float
    report: Optional[UnionReport]


def bilingual_union(
    root: str,
    positive_class: str,
    en_encode: Callable[[np.ndarray], np.ndarray],
    en_text_embed: np.ndarray,
    cn_encode: Callable[[np.ndarray], np.ndarray],
    cn_text_embed: np.ndarray,
    out_root: Optional[str] = None,
    en_threshold: Optional[float] = None,
    cn_threshold: Optional[float] = None,
    image_size: int = 224,
    batch_size: int = 128,
    copy_files: bool = True,
) -> BilingualResult:
    """Calibrate (if thresholds not given) and produce the union report."""
    en_ds = FolderDataset.from_root(root, image_size=image_size, stack="openai")
    cn_ds = FolderDataset.from_root(root, image_size=image_size, stack="hf")

    en_paths, en_classes, en_sims = score_dataset(
        en_ds, en_encode, en_text_embed, batch_size)
    cn_paths, cn_classes, cn_sims = score_dataset(
        cn_ds, cn_encode, cn_text_embed, batch_size)
    assert en_paths == cn_paths, "tower scans must cover identical files"

    positives = np.asarray([c == positive_class for c in en_classes])

    en_f1 = cn_f1 = float("nan")
    if en_threshold is None:
        sweep = evaluate_thresholds(en_sims[positives], en_sims[~positives])
        en_threshold, en_f1 = sweep.best_threshold, sweep.best_f1
    if cn_threshold is None:
        sweep = evaluate_thresholds(cn_sims[positives], cn_sims[~positives])
        cn_threshold, cn_f1 = sweep.best_threshold, sweep.best_f1

    samples = [
        UnionSample(
            path=p, basename=os.path.basename(p), is_positive=bool(pos),
            en_sim=float(es), cn_sim=float(cs),
        )
        for p, pos, es, cs in zip(en_paths, positives, en_sims, cn_sims)
    ]
    report = None
    if out_root is not None:
        report = save_union_samples(samples, positive_class, en_threshold,
                                    cn_threshold, out_root, copy_files)
    return BilingualResult(
        cls=positive_class,
        en_threshold=float(en_threshold),
        cn_threshold=float(cn_threshold),
        en_best_f1=float(en_f1),
        cn_best_f1=float(cn_f1),
        report=report,
    )
