"""Dedup + leakage-removal engines (the governance core).

Counterpart of mmrs_tpu/govern/dedup.py. The hash modes and leakage are
host code, as there; the embedding mode runs the first-match kernel
(ops/allpairs.py: K9 on a GPU) on `default_device()`.

Three modes matching the reference's tools, each with the reference's
keep-policy and a --dry-run default (tool/delete.py:4 had a test_mode that
production disabled; here dry-run is the DEFAULT and destruction is opt-in):

  - exact  (tool/find_repeated.py): MD5 of raw RGB pixels; cross-folder —
    keeps the REFERENCE folder's copy, removes matches in the target folder.
  - perceptual (tool/find_repeated_in_same_folder.py): pHash+dHash+wHash,
    duplicate if ANY Hamming <= 5; keeps the LARGEST file.
  - embedding (the semantic mode, SURVEY.md §7): L2-normalized encoder
    embeddings through the tiled `first_match` kernel; keep-first.

Leakage removal (tool/delete repeated.py): dHash of every test image; train
images whose dHash matches exactly (Hamming <= 0 in the reference) are
removed from TRAIN. Implemented as an O(N) dict lookup instead of the
reference's O(N_train * N_test) loop; a tolerance>0 falls back to the
vectorized packed-Hamming path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from mmrs_tpu_torch.govern.hashing import (
    PerceptualHashes,
    dhash,
    exact_pixel_hash,
    perceptual_hashes,
)
from mmrs_tpu_torch.io.images import pil_loader
from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class DedupReport:
    duplicates: List[Tuple[str, str]] = field(default_factory=list)  # (dup, keeper)
    errors: List[Tuple[str, str]] = field(default_factory=list)      # (path, error)
    removed: List[str] = field(default_factory=list)
    dry_run: bool = True

    @property
    def num_duplicates(self) -> int:
        return len(self.duplicates)

    def summary(self) -> str:
        return (
            f"{len(self.duplicates)} duplicates, {len(self.errors)} errors, "
            f"{len(self.removed)} removed (dry_run={self.dry_run})"
        )


def _hash_one(path: str, fn: Callable):
    with pil_loader(path) as img:
        return fn(img)


def _iter_hashes(paths: Sequence[str], fn: Callable, errors: list,
                 workers: int = 0):
    """(path, hash) pairs in input order; corrupt files land in `errors`.

    Decode + hash is the CPU-bound hot loop at 100k+ images (VERDICT r1
    Weak #6), so it runs on a thread pool — PIL decode and the numpy
    DCT/FFT inside the hashes release the GIL. `workers=0` sizes the pool
    to the machine; order is preserved so keep-first policies are stable."""
    if workers == 0:
        workers = min(32, os.cpu_count() or 1)
    if workers <= 1 or len(paths) < 4:
        for p in paths:
            try:
                yield p, _hash_one(p, fn)
            except Exception as e:  # noqa: BLE001 — corrupt files reported
                errors.append((p, repr(e)))
        return

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(_hash_one, p, fn) for p in paths]
        for p, fut in zip(paths, futures):
            try:
                yield p, fut.result()
            except Exception as e:  # noqa: BLE001
                errors.append((p, repr(e)))


def _apply_removals(report: DedupReport, dry_run: bool) -> None:
    report.dry_run = dry_run
    if dry_run:
        return
    for dup, _keeper in report.duplicates:
        try:
            os.remove(dup)
            report.removed.append(dup)
        except OSError as e:
            report.errors.append((dup, repr(e)))


def exact_dedup(
    reference_paths: Sequence[str],
    target_paths: Sequence[str],
    dry_run: bool = True,
    workers: int = 0,
) -> DedupReport:
    """Cross-folder exact dedup: delete files in `target` whose pixels match
    any file in `reference` (tool/find_repeated.py:35-71 semantics; the
    reference-folder copy is always the keeper)."""
    report = DedupReport()
    ref: Dict[str, str] = {}
    for p, h in _iter_hashes(reference_paths, exact_pixel_hash,
                             report.errors, workers):
        ref.setdefault(h, p)
    for p, h in _iter_hashes(target_paths, exact_pixel_hash,
                             report.errors, workers):
        if h in ref and os.path.abspath(p) != os.path.abspath(ref[h]):
            report.duplicates.append((p, ref[h]))
    _apply_removals(report, dry_run)
    return report


def perceptual_dedup(
    paths: Sequence[str],
    threshold: int = 5,
    dry_run: bool = True,
    workers: int = 0,
) -> DedupReport:
    """Intra-folder perceptual dedup; keeps the LARGEST file of each
    duplicate group (tool/find_repeated_in_same_folder.py:73 sorts by size
    desc and scans kept files linearly)."""
    report = DedupReport()
    sized = []
    for p in paths:
        try:
            sized.append((os.path.getsize(p), p))
        except OSError as e:
            report.errors.append((p, repr(e)))
    sized.sort(key=lambda t: (-t[0], t[1]))
    ordered = [p for _, p in sized]

    hashes: List[Tuple[str, PerceptualHashes]] = list(
        _iter_hashes(ordered, perceptual_hashes, report.errors, workers)
    )
    if not hashes:
        return report

    names = [p for p, _ in hashes]
    stacked = np.stack([
        np.asarray([h.phash for _, h in hashes], np.uint64),
        np.asarray([h.dhash for _, h in hashes], np.uint64),
        np.asarray([h.whash for _, h in hashes], np.uint64),
    ])

    # Threaded native keep-first scan (numpy-block fallback inside).
    from mmrs_tpu_torch.govern.native import hamming_first_match

    first = hamming_first_match(stacked, threshold=threshold)
    # first[i] is the earliest match among ALL predecessors — a parallel
    # prefilter. The reference compares each file only against KEPT
    # files (tool/find_repeated_in_same_folder.py:82-90): a row whose
    # only matches were themselves deleted must be KEPT, so resolve the
    # flagged candidates sequentially against the kept set. (The old
    # first-match chain walk over-deleted: A~B, B~C, A!~C kept only A,
    # while the reference keeps A and C.)
    kept = first < 0                  # no predecessor match at all: kept
    for i in np.nonzero(first >= 0)[0]:
        j = int(first[i])
        if kept[j]:
            # the first OVERALL match is kept => it is also the first
            # kept match (nothing matched before it at all)
            report.duplicates.append((names[i], names[j]))
            continue
        # first match was itself deleted: scan kept predecessors in
        # order (vectorized popcount over all 3 hash kinds)
        prev_kept = np.nonzero(kept[:i])[0]
        if prev_kept.size:
            x = stacked[:, prev_kept] ^ stacked[:, i:i + 1]   # [H, P]
            hit = (np.bitwise_count(x) <= threshold).any(axis=0)
            hits = np.nonzero(hit)[0]
        else:
            hits = np.empty(0, np.int64)
        if hits.size:
            report.duplicates.append((names[i],
                                      names[int(prev_kept[hits[0]])]))
        else:
            kept[i] = True
    _apply_removals(report, dry_run)
    return report


def leakage_removal(
    train_paths: Sequence[str],
    test_paths: Sequence[str],
    tolerance: int = 0,
    dry_run: bool = True,
    workers: int = 0,
) -> DedupReport:
    """Remove train images whose dHash is within `tolerance` of any test
    image (tool/delete repeated.py:11-162; the reference uses tolerance 0
    and always deletes from TRAIN)."""
    report = DedupReport()
    test_hashes: List[Tuple[str, np.uint64]] = list(
        _iter_hashes(test_paths, dhash, report.errors, workers)
    )
    if tolerance <= 0:
        lookup: Dict[int, str] = {}
        for p, h in test_hashes:
            lookup.setdefault(int(h), p)
        for p, h in _iter_hashes(train_paths, dhash, report.errors,
                                 workers):
            hit = lookup.get(int(h))
            if hit is not None:
                report.duplicates.append((p, hit))
    else:
        th = np.asarray([h for _, h in test_hashes], np.uint64)
        tnames = [p for p, _ in test_hashes]
        train_hashes = list(
            _iter_hashes(train_paths, dhash, report.errors, workers))
        if train_hashes and len(th):
            from mmrs_tpu_torch.govern.native import hamming_cross_any

            trh = np.asarray([h for _, h in train_hashes], np.uint64)
            first = hamming_cross_any(trh[None], th[None], threshold=tolerance)
            for r, c in enumerate(first):
                if c >= 0:
                    report.duplicates.append((train_hashes[r][0], tnames[c]))
    _apply_removals(report, dry_run)
    return report


def embedding_dedup(
    embeddings: np.ndarray,        # [N, D] L2-normalized, size-desc or keep-order
    paths: Sequence[str],
    tau: float = 0.96,
    dry_run: bool = True,
    mesh=None,
    impl: str = "auto",
    device=None,
) -> DedupReport:
    """Semantic dedup on encoder embeddings via the tiled first_match kernel.
    Keep-first: order the rows by preference (e.g. file size desc) before
    calling. The rows go to `device` (default: `default_device()`) as f32;
    the ring-sharded form (mesh=) is ported with ROADMAP A.12."""
    import torch

    from mmrs_tpu_torch.ops.allpairs import first_match
    from mmrs_tpu_torch.pipeline import default_device

    if mesh is not None:
        raise NotImplementedError(
            "the ring-sharded embedding dedup (mesh=) is ported with "
            "ROADMAP A.12")
    report = DedupReport()
    device = torch.device(device) if device is not None else default_device()
    # a copy: index rows are often a read-only memmap
    x = torch.tensor(np.asarray(embeddings, np.float32), device=device)
    fm = first_match(x, x, tau, intra=True, impl=impl).cpu().numpy()
    for i, j in enumerate(fm):
        if j >= 0:
            # resolve chains to the ultimate keeper
            k = int(j)
            while fm[k] >= 0:
                k = int(fm[k])
            report.duplicates.append((paths[i], paths[k]))
    _apply_removals(report, dry_run)
    return report
