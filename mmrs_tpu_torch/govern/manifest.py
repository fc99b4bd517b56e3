"""Gallery manifest canonicalization: rename + merge operations.

  - canonical_rename: two-phase rename of each class folder's files to
    sequential `{folder}{i}.ext` names — first shuffle every file to a
    random temp name so sequence renames can't collide
    (tool/rename.py:5-68 semantics, incl. processing all subfolders).
  - merge_folders: merge class folders (e.g. Chinese-named) into canonical
    (English) ones, continuing numbering from the existing maximum index,
    then re-sequence (tool/combine.py:5-142; the 猫->cat style mapping is a
    caller-supplied dict).
"""

from __future__ import annotations

import os
import random
import re
import shutil
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class RenameReport:
    renamed: List[Tuple[str, str]] = field(default_factory=list)
    moved: List[Tuple[str, str]] = field(default_factory=list)
    errors: List[Tuple[str, str]] = field(default_factory=list)
    dry_run: bool = True


def _files(directory: str) -> List[str]:
    return sorted(
        f for f in os.listdir(directory)
        if os.path.isfile(os.path.join(directory, f))
    )


def canonical_rename(root: str, dry_run: bool = True, seed: int = 0) -> RenameReport:
    """Rename files in every subfolder of `root` to {folder}{i}.{ext}."""
    report = RenameReport(dry_run=dry_run)
    rng = random.Random(seed)
    for sub in sorted(os.listdir(root)):
        d = os.path.join(root, sub)
        if not os.path.isdir(d):
            continue
        files = _files(d)
        if dry_run:
            for i, f in enumerate(files, 1):
                ext = os.path.splitext(f)[1].lower()
                report.renamed.append(
                    (os.path.join(d, f), os.path.join(d, f"{sub}{i}{ext}"))
                )
            continue
        # Phase 1: shuffle to random temp names (avoids collisions with the
        # target sequence, tool/rename.py:22-39).
        temp_names = []
        for f in files:
            ext = os.path.splitext(f)[1].lower()
            tmp = f"__tmp_{rng.getrandbits(64):016x}{ext}"
            os.rename(os.path.join(d, f), os.path.join(d, tmp))
            temp_names.append(tmp)
        # Phase 2: sequential canonical names (:50-66) in the ORIGINAL
        # files' sorted order — sorting the random temp names would
        # assign numbers by a random permutation, contradicting the
        # dry-run plan (the approval artifact) — and the report maps
        # the ORIGINAL path to its final name so the audit trail is
        # usable.
        for i, (orig, tmp) in enumerate(zip(files, temp_names), 1):
            ext = os.path.splitext(tmp)[1]
            dst = f"{sub}{i}{ext}"
            os.rename(os.path.join(d, tmp), os.path.join(d, dst))
            report.renamed.append((os.path.join(d, orig),
                                   os.path.join(d, dst)))
    return report


_NUM_RE = re.compile(r"(\d+)(?=\.[^.]+$)")


def _max_index(directory: str) -> int:
    mx = 0
    for f in _files(directory):
        m = _NUM_RE.search(f)
        if m:
            mx = max(mx, int(m.group(1)))
    return mx


def merge_folders(
    root: str,
    mapping: Dict[str, str],
    dry_run: bool = True,
    resequence: bool = True,
) -> RenameReport:
    """Move files from each source folder into its mapped destination,
    numbering after the destination's current max index; optionally
    re-sequence the destination afterwards (tool/combine.py:48-140)."""
    report = RenameReport(dry_run=dry_run)
    # per-destination counters so a dry run predicts the real run when
    # SEVERAL sources map to one destination (the real run sees earlier
    # sources' moves via _max_index; the dry run must carry the count)
    counters: Dict[str, int] = {}
    for src_name, dst_name in mapping.items():
        src = os.path.join(root, src_name)
        dst = os.path.join(root, dst_name)
        if not os.path.isdir(src):
            continue
        if not dry_run:
            os.makedirs(dst, exist_ok=True)
        idx = counters.get(dst)
        if idx is None:
            idx = _max_index(dst) if os.path.isdir(dst) else 0
        for f in _files(src):
            idx += 1
            ext = os.path.splitext(f)[1].lower()
            target = os.path.join(dst, f"{dst_name}{idx}{ext}")
            report.moved.append((os.path.join(src, f), target))
            if not dry_run:
                shutil.move(os.path.join(src, f), target)
        counters[dst] = idx
        if not dry_run and not _files(src):
            os.rmdir(src)
    if resequence and not dry_run:
        sub_report = canonical_rename(root, dry_run=False)
        report.renamed.extend(sub_report.renamed)
    return report
