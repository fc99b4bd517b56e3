"""Gallery/dataset enumeration: folder scan, class merging, few-shot sampling.

Reference contracts reproduced:
  - `scan_dataset` (CLIP/union_dataset.py:234-244): recursive walk of
    class-per-subfolder trees collecting (path, class).
  - class-merge mapping (code/merge_dataset.py:79-129): N-way mode maps a
    list of positive folders to themselves and everything else to "others";
    binary mode maps one positive class vs "not_<class>".
  - few-shot sampling (code/custom.py:43-53): k random images per class with
    a seeded RNG.
  - batched parallel decode replacing torch DataLoader workers
    (num_workers=8 at CLIP/lab3.py:104) with a thread pool (PIL releases the
    GIL during decode).
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mmrs_tpu_torch.io.images import IMG_EXTENSIONS, ImageLoadResult, load_image


def scan_folder(
    root: str,
    extensions: Sequence[str] = IMG_EXTENSIONS,
    class_map: Optional[Dict[str, str]] = None,
) -> List[Tuple[str, str]]:
    """Recursively collect (path, class) pairs; class = top-level subfolder
    name (optionally remapped through class_map)."""
    out: List[Tuple[str, str]] = []
    exts = tuple(e.lower() for e in extensions)
    root = os.path.abspath(root)
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        rel = os.path.relpath(dirpath, root)
        if rel == ".":
            cls = ""
        else:
            cls = rel.split(os.sep)[0]
        if class_map is not None:
            cls = class_map.get(cls, cls)
        for fn in sorted(filenames):
            if fn.lower().endswith(exts):
                out.append((os.path.join(dirpath, fn), cls))
    return out


def merge_class_map(
    all_classes: Sequence[str],
    positives: Sequence[str],
    binary_positive: Optional[str] = None,
) -> Dict[str, str]:
    """The merge_dataset.py mapping: with `binary_positive`, that class maps
    to itself and every other folder to "not_<class>" (:95-129); otherwise
    the listed positives map to themselves and the rest to "others"
    (:79-94)."""
    mapping: Dict[str, str] = {}
    if binary_positive is not None:
        for c in all_classes:
            mapping[c] = c if c == binary_positive else f"not_{binary_positive}"
        return mapping
    pos = set(positives)
    for c in all_classes:
        mapping[c] = c if c in pos else "others"
    return mapping


def few_shot_sample(
    samples: Sequence[Tuple[str, str]],
    shots: int,
    seed: int = 0,
) -> List[Tuple[str, str]]:
    """k random samples per class (code/custom.py:43-53 semantics)."""
    rng = random.Random(seed)
    by_class: Dict[str, List[Tuple[str, str]]] = {}
    for p, c in samples:
        by_class.setdefault(c, []).append((p, c))
    out: List[Tuple[str, str]] = []
    for c in sorted(by_class):
        items = by_class[c]
        k = min(shots, len(items))
        out.extend(rng.sample(items, k))
    return out


@dataclass
class Batch:
    pixels: np.ndarray           # [B, S, S, 3] uint8
    labels: List[str]
    paths: List[str]
    ok: np.ndarray               # [B] bool — False rows are quarantined

    def __len__(self) -> int:
        return len(self.paths)


@dataclass
class FolderDataset:
    """Streaming batched reader over (path, class) samples."""

    samples: List[Tuple[str, str]]
    image_size: int = 224
    stack: str = "openai"        # preprocessing geometry per tower
    num_workers: int = 8

    @classmethod
    def from_root(cls, root: str, **kw) -> "FolderDataset":
        return cls(samples=scan_folder(root), **kw)

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def classes(self) -> List[str]:
        return sorted({c for _, c in self.samples})

    def batches(self, batch_size: int, drop_errors: bool = False) -> Iterator[Batch]:
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for i in range(0, len(self.samples), batch_size):
                chunk = self.samples[i:i + batch_size]
                results: List[ImageLoadResult] = list(
                    pool.map(
                        lambda pc: load_image(pc[0], self.image_size, self.stack),
                        chunk,
                    )
                )
                labels = [c for _, c in chunk]
                if drop_errors:
                    keep = [j for j, r in enumerate(results) if r.ok]
                    results = [results[j] for j in keep]
                    labels = [labels[j] for j in keep]
                    if not results:
                        continue
                yield Batch(
                    pixels=np.stack([r.pixels for r in results]),
                    labels=labels,
                    paths=[r.path for r in results],
                    ok=np.asarray([r.ok for r in results]),
                )
