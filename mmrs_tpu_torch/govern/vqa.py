"""Balanced VQA (LLaVA-finetune) dataset builders, v1..v5.

Reference: tool/create_jsonl_dataset{1..5}.py. All five variants emit the
same record schema (a JSON array of):

    {"id": <uuid>, "image": <relative posix path>,
     "conversations": [
        {"from": "human", "value": "<image>\\nDoes this image contain a {category}?"},
        {"from": "gpt", "value": "Yes" | "No"}]}

Variants:
  v1  all positives -> "Yes"                       (create_jsonl_dataset1.py)
  v2  positives + equal-count cross-class "No"s, balanced across source
      classes with remainder distribution and (image, category) dedup
                                                   (create_jsonl_dataset2.py)
  v3  positives + 50% cross negatives + equal count of "easy" negatives
      from an ez_negative folder                   (create_jsonl_dataset3.py)
  v4  min-count-balanced positives; negative mix of cross/simple/hard pools
      at 0.4/0.4/0.2; emits FOUR files (pos-only, +cross, +simple, +hard);
      balance verifiers; internal metadata stripped on save
                                                   (create_jsonl_dataset4.py)
  v5  eval set from confusable negative pairs (lynx->cat, wolf->dog, ...)
      with the strict single-word prompt           (create_jsonl_dataset5.py)

Determinism: all sampling uses a seeded RNG (the reference used
unseeded random.shuffle; seeding is the conscious fix, documented per
SURVEY.md §7 quirks policy).
"""

from __future__ import annotations

import json
import os
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

PROMPT = "Does this image contain a {category}?"
STRICT_PROMPT = (
    "Does this image contain a {category}? "
    "Answer with ONLY a single word: 'yes' or 'no'."
)

# v5's confusable eval pairs (create_jsonl_dataset5.py:9-15)
CONFUSABLE_PAIRS = {
    "lynx": "cat",
    "wolf": "dog",
    "donkey": "horse",
    "oil painting": "ink painting",
    "pottery": "porcelain",
}


def _record(image_rel: str, category: str, answer: str,
            strict: bool = False, rng: Optional[np.random.Generator] = None,
            meta: Optional[dict] = None) -> dict:
    prompt = (STRICT_PROMPT if strict else PROMPT).format(category=category)
    rec = {
        "id": str(uuid.UUID(bytes=bytes(rng.integers(0, 256, 16, dtype=np.uint8)))
                  if rng is not None else uuid.uuid4()),
        "image": image_rel.replace(os.sep, "/"),
        "conversations": [
            {"from": "human", "value": f"<image>\n{prompt}"},
            {"from": "gpt", "value": answer},
        ],
    }
    if meta:
        rec["_meta"] = meta
    return rec


def _strip_meta(records: List[dict]) -> List[dict]:
    """v4 strips internal bookkeeping before save (:85-99)."""
    return [{k: v for k, v in r.items() if not k.startswith("_")} for r in records]


def _save(records: List[dict], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(_strip_meta(records), f, ensure_ascii=False, indent=2)


def _answer_of(rec: dict) -> str:
    return rec["conversations"][1]["value"]


def _category_of(rec: dict) -> str:
    import re

    m = re.search(r"contain an? (.+?)\?", rec["conversations"][0]["value"])
    return m.group(1) if m else ""


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------

def build_v1(
    images_by_class: Dict[str, List[str]],
    out_path: Optional[str] = None,
    seed: int = 0,
) -> List[dict]:
    """All positives -> Yes."""
    rng = np.random.default_rng(seed)
    records = [
        _record(p, cls, "Yes", rng=rng)
        for cls in sorted(images_by_class)
        for p in sorted(images_by_class[cls])
    ]
    if out_path:
        _save(records, out_path)
    return records


def _balanced_cross_negatives(
    images_by_class: Dict[str, List[str]],
    count_per_class: Dict[str, int],
    rng: np.random.Generator,
    used_pairs: set,
    unique_sources: bool = False,
) -> List[dict]:
    """For each target class, sample `count` negatives evenly from the OTHER
    classes, distributing the remainder, deduping (image, category) pairs and
    reusing images as fallback when a pool runs short
    (create_jsonl_dataset2.py:86-189)."""
    out: List[dict] = []
    globally_used: set = set()
    for target in sorted(count_per_class):
        need = count_per_class[target]
        sources = [c for c in sorted(images_by_class) if c != target]
        if not sources or need <= 0:
            continue
        base, rem = divmod(need, len(sources))
        quota = {c: base for c in sources}
        for c in rng.permutation(sources)[:rem]:
            quota[str(c)] += 1
        for src in sources:
            pool = [p for p in images_by_class[src]
                    if (p, target) not in used_pairs
                    and (not unique_sources or p not in globally_used)]
            rng.shuffle(pool)
            take = pool[:quota[src]]
            if len(take) < quota[src]:
                # fallback: reuse already-used images (:154-189)
                extra = [p for p in images_by_class[src] if p not in take]
                rng.shuffle(extra)
                take += extra[:quota[src] - len(take)]
            for p in take:
                used_pairs.add((p, target))
                globally_used.add(p)
                out.append(_record(p, target, "No", rng=rng,
                                   meta={"true_source_category": src}))
    return out


def build_v2(
    images_by_class: Dict[str, List[str]],
    out_path: Optional[str] = None,
    seed: int = 0,
) -> List[dict]:
    """Positives + equal-count balanced cross-class negatives."""
    rng = np.random.default_rng(seed)
    used: set = set()
    records = []
    for cls in sorted(images_by_class):
        for p in sorted(images_by_class[cls]):
            used.add((p, cls))
            records.append(_record(p, cls, "Yes", rng=rng))
    counts = {c: len(images_by_class[c]) for c in images_by_class}
    records += _balanced_cross_negatives(images_by_class, counts, rng, used)
    if out_path:
        _save(records, out_path)
    return records


def build_v3(
    images_by_class: Dict[str, List[str]],
    easy_negatives: Sequence[str],
    out_path: Optional[str] = None,
    seed: int = 0,
    cross_ratio: float = 0.5,
) -> List[dict]:
    """Positives + cross_ratio cross negatives + equal count of easy
    negatives from the ez_negative pool (create_jsonl_dataset3.py)."""
    rng = np.random.default_rng(seed)
    used: set = set()
    records = []
    for cls in sorted(images_by_class):
        for p in sorted(images_by_class[cls]):
            used.add((p, cls))
            records.append(_record(p, cls, "Yes", rng=rng))
    counts = {c: int(len(images_by_class[c]) * cross_ratio)
              for c in images_by_class}
    cross = _balanced_cross_negatives(images_by_class, counts, rng, used)
    records += cross
    # easy negatives: same count as cross, per target class round-robin
    easy = list(easy_negatives)
    rng.shuffle(easy)
    if len(easy) < len(cross):
        # truncated like the reference, but LOUDLY (create_jsonl_
        # dataset3.py:226-227 prints the same shortfall warning) — the
        # Yes/No balance the dataset exists for is skewed
        log.warning("easy-negative pool short: %d/%d — dataset balance "
                    "is skewed", len(easy), len(cross))
    targets = sorted(images_by_class)
    for i, rec in enumerate(cross):
        if i >= len(easy):
            break
        target = targets[i % len(targets)]
        records.append(_record(easy[i], target, "No", rng=rng,
                               meta={"pool": "easy"}))
    if out_path:
        _save(records, out_path)
    return records


@dataclass
class V4Outputs:
    positives: List[dict]
    with_cross: List[dict]
    with_simple: List[dict]
    with_hard: List[dict]
    files: Dict[str, str] = field(default_factory=dict)


def build_v4(
    images_by_class: Dict[str, List[str]],
    easy_negatives: Sequence[str],
    hard_negatives_by_class: Dict[str, List[str]],
    out_dir: Optional[str] = None,
    seed: int = 0,
    ratios: Tuple[float, float, float] = (0.4, 0.4, 0.2),
) -> V4Outputs:
    """The elaborate v4 pipeline (create_jsonl_dataset4.py): min-count
    balanced positives; cross (globally-unique sources) / simple / hard
    negative pools mixed at `ratios`; four cumulative dataset files."""
    rng = np.random.default_rng(seed)
    min_count = min(len(v) for v in images_by_class.values())

    used: set = set()
    positives: List[dict] = []
    balanced = {}
    for cls in sorted(images_by_class):
        pool = sorted(images_by_class[cls])
        rng.shuffle(pool)
        balanced[cls] = pool[:min_count]
        for p in balanced[cls]:
            used.add((p, cls))
            positives.append(_record(p, cls, "Yes", rng=rng))

    n_neg_per_class = min_count  # negatives match positives per class
    cross_n = {c: int(n_neg_per_class * ratios[0]) for c in balanced}
    cross = _balanced_cross_negatives(images_by_class, cross_n, rng, used,
                                      unique_sources=True)

    simple: List[dict] = []
    easy = list(easy_negatives)
    rng.shuffle(easy)
    need_simple = sum(int(n_neg_per_class * ratios[1]) for _ in balanced)
    if len(easy) < need_simple:
        log.warning("simple-negative pool short: %d/%d — v4 ratios are "
                    "skewed", len(easy), need_simple)
    ei = 0
    for cls in sorted(balanced):
        take = int(n_neg_per_class * ratios[1])
        for _ in range(take):
            if ei >= len(easy):
                break
            simple.append(_record(easy[ei], cls, "No", rng=rng,
                                  meta={"pool": "simple"}))
            ei += 1

    hard: List[dict] = []
    for cls in sorted(balanced):
        pool = sorted(hard_negatives_by_class.get(cls, []))
        rng.shuffle(pool)
        take = int(n_neg_per_class * ratios[2])
        for p in pool[:take]:
            hard.append(_record(p, cls, "No", rng=rng, meta={"pool": "hard"}))

    out = V4Outputs(
        positives=positives,
        with_cross=positives + cross,
        with_simple=positives + cross + simple,
        with_hard=positives + cross + simple + hard,
    )
    if out_dir:
        names = {
            "positives": "dataset_pos.json",
            "with_cross": "dataset_pos_cross.json",
            "with_simple": "dataset_pos_cross_simple.json",
            "with_hard": "dataset_pos_cross_simple_hard.json",
        }
        for attr, fn in names.items():
            path = os.path.join(out_dir, fn)
            _save(getattr(out, attr), path)
            out.files[attr] = path
    return out


def build_v5(
    images_by_class: Dict[str, List[str]],
    confusable_pairs: Dict[str, str] = None,
    out_path: Optional[str] = None,
    seed: int = 0,
) -> List[dict]:
    """Eval dataset: each confusable-class image asks about its TARGET class
    (expected 'No'), plus the target class's own images ('Yes'), with the
    strict single-word prompt (create_jsonl_dataset5.py)."""
    pairs = confusable_pairs or CONFUSABLE_PAIRS
    rng = np.random.default_rng(seed)
    records: List[dict] = []
    for neg_cls, target in sorted(pairs.items()):
        for p in sorted(images_by_class.get(target, [])):
            records.append(_record(p, target, "Yes", strict=True, rng=rng))
        for p in sorted(images_by_class.get(neg_cls, [])):
            records.append(_record(p, target, "No", strict=True, rng=rng,
                                   meta={"true_source_category": neg_cls}))
    if out_path:
        _save(records, out_path)
    return records


# --------------------------------------------------------------------------
# Balance verifiers (create_jsonl_dataset4.py:123-148, :337-385)
# --------------------------------------------------------------------------

def verify_balance(records: Sequence[dict]) -> Dict[str, Dict[str, int]]:
    """Per-category Yes/No counts."""
    out: Dict[str, Dict[str, int]] = {}
    for r in records:
        cat = _category_of(r)
        d = out.setdefault(cat, {"Yes": 0, "No": 0})
        d[_answer_of(r)] += 1
    return out


def verify_cross_negative_source_balance(
    records: Sequence[dict],
) -> Dict[str, Dict[str, int]]:
    """For cross negatives carrying _meta.true_source_category: counts of
    source categories per question category."""
    out: Dict[str, Dict[str, int]] = {}
    for r in records:
        meta = r.get("_meta") or {}
        src = meta.get("true_source_category")
        if src and _answer_of(r) == "No":
            cat = _category_of(r)
            out.setdefault(cat, {})
            out[cat][src] = out[cat].get(src, 0) + 1
    return out
