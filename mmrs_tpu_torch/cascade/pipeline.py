"""Dual-tower OR-threshold gate + VLM-verify cascade.

A copy of mmrs_tpu/cascade/pipeline.py on the port's modules (it runs no
device code itself: the scorers and the verifier do).

Reference: `union_clip_by_threshold` (code/union_clip_llava2.py:134-271) and
the merge_dataset.py batch variant (:259-311, :430-442).

Design differences (TPU-first, documented per SURVEY.md §7):
  - the reference scores one image at a time (:172-260); here both towers
    score the WHOLE batch on device, then the OR-mask selects the (few)
    survivors that pay the expensive VLM call;
  - merge_dataset.py's inverted predicate (pred 0 == positive, :279, :440)
    is normalized to "score >= threshold => positive" at this API, as the
    survey directs;
  - per-stage wall-clock + counts ride a StageStats instead of prints
    (:163-168, :263-268).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from mmrs_tpu_torch.cascade.verifier import Verifier
from mmrs_tpu_torch.search.metrics import PRF1, binary_prf1
from mmrs_tpu_torch.utils.stats import StageStats

_JOURNAL_FIELDS = ("path", "en_score", "cn_score", "gate", "verified")


@dataclass
class CascadeResult:
    paths: List[str]
    en_scores: np.ndarray           # [N]
    cn_scores: np.ndarray           # [N]
    gate_passed: np.ndarray         # [N] bool — OR-threshold survivors
    verified: np.ndarray            # [N] bool — final positives
    verifier_calls: int
    stats: StageStats
    metrics: Optional[PRF1] = None

    def summary(self) -> str:
        lines = [
            f"images: {len(self.paths)}",
            f"gate passed: {int(self.gate_passed.sum())}",
            f"verifier calls: {self.verifier_calls}",
            f"final positives: {int(self.verified.sum())}",
        ]
        if self.metrics:
            m = self.metrics
            lines.append(
                f"P {m.precision:.4f} R {m.recall:.4f} F1 {m.f1:.4f}"
            )
        lines.append(self.stats.summary())
        return "\n".join(lines)

    def write_csv(self, out_path: str) -> None:
        """Per-image audit CSV (path, tower scores, gate, final verdict) —
        the cascade counterpart of the union report's `_file_details.csv`
        (reference: CLIP/union_dataset.py's per-file audit)."""
        with open(out_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(_JOURNAL_FIELDS)
            for i, p in enumerate(self.paths):
                w.writerow(_journal_row(p, self.en_scores[i],
                                        self.cn_scores[i],
                                        bool(self.gate_passed[i]),
                                        bool(self.verified[i])))


def _journal_row(path, en, cn, gate, verified):
    # %.9g round-trips float32 exactly, so a resumed run's scores equal
    # the clean run's bit for bit
    return [path, f"{float(en):.9g}", f"{float(cn):.9g}",
            int(gate), int(verified)]


def _load_journal(path: str) -> dict:
    """path -> (en, cn, gate, verified) for every FINALIZED row."""
    done = {}
    if not os.path.exists(path):
        return done
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) != len(_JOURNAL_FIELDS) or row[0] == "path":
                continue  # header / torn tail line
            try:
                done[row[0]] = (float(row[1]), float(row[2]),
                                bool(int(row[3])), bool(int(row[4])))
            except ValueError:
                continue  # torn write from a crash — redo that image
    return done


class _JournalWriter:
    """Append-only finalized-rows journal; fsynced per batch so a crash
    loses at most the in-flight batch (SURVEY.md §5 checkpoint/resume,
    same idiom as the index builder's shard-atomic writes)."""

    def __init__(self, path: str, fresh_header: bool):
        # a crash can leave a torn tail WITHOUT a trailing newline; make
        # sure the first appended row starts a fresh line rather than
        # merging into (and corrupting) the fragment
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                needs_nl = f.read(1) != b"\n"
        else:
            needs_nl = False
        self._f = open(path, "a", newline="")
        if needs_nl:
            self._f.write("\r\n")
        self._w = csv.writer(self._f)
        if fresh_header:
            self._w.writerow(_JOURNAL_FIELDS)
            self._sync()

    def append(self, rows) -> None:
        self._w.writerows(rows)
        self._sync()

    def _sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


class CascadePipeline:
    """score (cheap, batched, both towers) -> OR gate -> verify (expensive)."""

    def __init__(
        self,
        en_scorer=None,     # callable: paths -> [N] scores (or None)
        cn_scorer=None,
        en_threshold: float = 0.0,
        cn_threshold: float = 0.0,
        verifier: Optional[Verifier] = None,
    ):
        if en_scorer is None and cn_scorer is None:
            raise ValueError("at least one tower scorer is required")
        self.en_scorer = en_scorer
        self.cn_scorer = cn_scorer
        self.en_threshold = en_threshold
        self.cn_threshold = cn_threshold
        self.verifier = verifier

    def run(
        self,
        paths: Sequence[str],
        category: str,
        labels: Optional[Sequence[bool]] = None,
    ) -> CascadeResult:
        stats = StageStats()
        n = len(paths)
        neg_inf = np.full(n, -np.inf, np.float32)

        if self.en_scorer is not None:
            with stats.timed("en_clip", count=n):
                en_scores = np.asarray(self.en_scorer(paths), np.float32)
        else:
            en_scores = neg_inf
        if self.cn_scorer is not None:
            with stats.timed("cn_clip", count=n):
                cn_scores = np.asarray(self.cn_scorer(paths), np.float32)
        else:
            cn_scores = neg_inf

        gate = (en_scores >= self.en_threshold) | (cn_scores >= self.cn_threshold)

        verified = gate.copy()
        calls = 0
        if self.verifier is not None:
            survivors = np.nonzero(gate)[0]
            with stats.timed("verifier", count=len(survivors)):
                batch_fn = getattr(self.verifier, "verify_batch", None)
                if batch_fn is not None and len(survivors):
                    answers = batch_fn([paths[i] for i in survivors], category)
                    calls = len(survivors)
                    for i, ok in zip(survivors, answers):
                        if not ok:
                            verified[i] = False
                else:
                    for i in survivors:
                        calls += 1
                        if not self.verifier.verify(paths[i], category):
                            verified[i] = False

        metrics = None
        if labels is not None:
            metrics = binary_prf1(verified, np.asarray(labels, bool))

        return CascadeResult(
            paths=list(paths),
            en_scores=en_scores,
            cn_scores=cn_scores,
            gate_passed=gate,
            verified=verified,
            verifier_calls=calls,
            stats=stats,
            metrics=metrics,
        )

    def _verify_paths(self, paths: List[str], category: str,
                      fixed_batch: Optional[int]) -> List[bool]:
        import inspect

        batch_fn = getattr(self.verifier, "verify_batch", None)
        if batch_fn is None:
            return [self.verifier.verify(p, category) for p in paths]
        if fixed_batch and "fixed_batch" in inspect.signature(
                batch_fn).parameters:
            return list(batch_fn(paths, category, fixed_batch=fixed_batch))
        return list(batch_fn(paths, category))

    def run_streaming(
        self,
        paths: Sequence[str],
        category: str,
        labels: Optional[Sequence[bool]] = None,
        chunk_size: int = 224,
        verify_batch: int = 8,
        pipeline_depth: int = 2,
        journal: Optional[str] = None,
    ) -> CascadeResult:
        """Chunked cascade for folders that don't fit one scoring pass.

        Gates `chunk_size` images at a time (both towers), accumulates OR
        survivors, and dispatches the verifier only in FULL `verify_batch`
        packs padded to a fixed compiled shape (the reference loads the
        whole folder and loops one image at a time,
        code/union_clip_llava2.py:144-260; here memory is bounded by one
        chunk + one verify pack, and the 7B decoder compiles exactly once).
        Result is identical to `run()` with the same thresholds.

        Verify packs are PIPELINED when the verifier exposes
        `verify_batch_async`/`collect`: up to `pipeline_depth` packs stay
        in flight as async device dispatches while the host loads and
        gates the next chunk — the host-side image decode for chunk i+1
        hides behind the device's verify of chunk i's survivors.
        `pipeline_depth=0` forces the old synchronous flush.

        `journal=FILE` makes the run CRASH-RESUMABLE: every image's final
        row (scores, gate, verdict) is appended + fsynced as it finalizes
        — gate-failures at chunk end, survivors when their verify pack
        completes. Re-running with the same journal skips every finalized
        image (no re-scoring, no re-verifying) and the combined result
        equals a clean run. A torn tail line from a crash is ignored and
        that image is redone."""
        stats = StageStats()
        n = len(paths)
        en_all = np.full(n, -np.inf, np.float32)
        cn_all = np.full(n, -np.inf, np.float32)
        verified = np.zeros(n, bool)
        gate_all = np.zeros(n, bool)
        pending: List[int] = []
        calls = 0

        jw = None
        todo = list(range(n))
        if journal is not None:
            done = _load_journal(journal)
            if done:
                todo = []
                for i, p in enumerate(paths):
                    row = done.get(p)
                    if row is None:
                        todo.append(i)
                        continue
                    en, cn, old_gate, old_verified = row
                    # the journal may have been written under DIFFERENT
                    # thresholds — re-gate the stored scores. Same gate:
                    # reuse the finalized verdict. Now-failing: flip to
                    # negative (no verify needed). Now-passing but never
                    # verified: REDO the image — a verdict can't be
                    # invented (the last journal row per path wins, so
                    # the redone row supersedes the stale one).
                    new_gate = ((en >= self.en_threshold)
                                or (cn >= self.cn_threshold))
                    if new_gate and not old_gate and self.verifier is not None:
                        todo.append(i)
                        continue
                    en_all[i], cn_all[i] = en, cn
                    gate_all[i] = new_gate
                    verified[i] = old_verified if new_gate == old_gate \
                        else new_gate if self.verifier is None else False
            jw = _JournalWriter(journal, fresh_header=not done)

        def journal_rows(indices) -> None:
            if jw is not None:
                jw.append(_journal_row(paths[i], en_all[i], cn_all[i],
                                       bool(gate_all[i]), bool(verified[i]))
                          for i in indices)

        async_ok = (pipeline_depth > 0
                    and hasattr(self.verifier, "verify_batch_async")
                    and hasattr(self.verifier, "collect"))
        in_flight: List[tuple] = []   # [(batch_indices, handle), ...]

        def drain_one():
            batch, handle = in_flight.pop(0)
            with stats.timed("verifier_wait", count=len(batch)):
                answers = self.verifier.collect(handle)
            for i, ok in zip(batch, answers):
                verified[i] = ok
            journal_rows(batch)

        def flush(batch: List[int]):
            nonlocal calls
            calls += len(batch)
            if async_ok:
                with stats.timed("verifier", count=len(batch)):
                    handle = self.verifier.verify_batch_async(
                        [paths[i] for i in batch], category,
                        fixed_batch=verify_batch)
                in_flight.append((batch, handle))
                while len(in_flight) > pipeline_depth:
                    drain_one()
                return
            with stats.timed("verifier", count=len(batch)):
                answers = self._verify_paths(
                    [paths[i] for i in batch], category,
                    fixed_batch=verify_batch)
            for i, ok in zip(batch, answers):
                verified[i] = ok
            journal_rows(batch)

        try:
            for start in range(0, len(todo), chunk_size):
                idx = np.asarray(todo[start:start + chunk_size], np.int64)
                chunk = [paths[i] for i in idx]
                if self.en_scorer is not None:
                    with stats.timed("en_clip", count=len(chunk)):
                        en_all[idx] = np.asarray(self.en_scorer(chunk),
                                                 np.float32)
                if self.cn_scorer is not None:
                    with stats.timed("cn_clip", count=len(chunk)):
                        cn_all[idx] = np.asarray(self.cn_scorer(chunk),
                                                 np.float32)
                gate = ((en_all[idx] >= self.en_threshold)
                        | (cn_all[idx] >= self.cn_threshold))
                gate_all[idx] = gate
                if self.verifier is None:
                    verified[idx] = gate
                    journal_rows(int(i) for i in idx)
                    continue
                journal_rows(int(i) for i in idx[~gate])
                pending.extend(int(i) for i in idx[gate])
                while len(pending) >= verify_batch:
                    flush(pending[:verify_batch])
                    pending = pending[verify_batch:]
            if pending:
                flush(pending)
            while in_flight:
                drain_one()
        finally:
            if jw is not None:
                jw.close()

        metrics = None
        if labels is not None:
            metrics = binary_prf1(verified, np.asarray(labels, bool))
        return CascadeResult(
            paths=list(paths),
            en_scores=en_all,
            cn_scores=cn_all,
            gate_passed=gate_all,
            verified=verified,
            verifier_calls=calls,
            stats=stats,
            metrics=metrics,
        )
