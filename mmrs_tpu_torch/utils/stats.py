"""Per-stage timing/throughput statistics.

First-class replacement for the reference's manual `time.time()` stage
accumulators in the cascade (code/union_clip_llava2.py:163-168,215-218,
263-268): a `StageStats` object tracks wall-clock, item counts, and
derived rates per named stage, and renders the same style of summary.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator

# per-stage window of recent call durations for tail-latency percentiles
# (bounded: a long-running server keeps ~4 KB per stage)
_WINDOW = 512


@dataclass
class StageRecord:
    seconds: float = 0.0
    count: int = 0
    calls: int = 0
    recent: "deque[float]" = field(
        default_factory=lambda: deque(maxlen=_WINDOW))
    # guards `recent` snapshot vs concurrent appends: ThreadingHTTPServer
    # handler threads record() while a /v1/stats poll sorts the window
    # (deque raises "mutated during iteration" otherwise)
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def items_per_sec(self) -> float:
        return self.count / self.seconds if self.seconds > 0 else 0.0

    @property
    def mean_seconds(self) -> float:
        return self.seconds / self.calls if self.calls > 0 else 0.0

    @property
    def items_per_call(self) -> float:
        """Batch utilization: items per device dispatch (>1 means the
        serving micro-batcher coalesced concurrent requests)."""
        return self.count / self.calls if self.calls > 0 else 0.0

    def percentile_seconds(self, q: float) -> float:
        """q-th percentile (0..100) over the recent-call window (nearest
        rank, the conservative convention for tail SLOs)."""
        with self.lock:
            xs = sorted(self.recent)
        if not xs:
            return 0.0
        rank = max(0, min(len(xs) - 1,
                          int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[rank]


@dataclass
class StageStats:
    stages: Dict[str, StageRecord] = field(default_factory=dict)
    # guards the stages DICT itself (first record() of a new stage from a
    # handler thread vs a concurrent /v1/stats iteration — the same
    # mutated-during-iteration race percentile_seconds locks at the
    # deque level)
    _dict_lock: threading.Lock = field(default_factory=threading.Lock,
                                       repr=False)

    def record(self, stage: str, seconds: float, count: int = 1) -> None:
        rec = self.stages.get(stage)
        if rec is None:
            with self._dict_lock:
                rec = self.stages.setdefault(stage, StageRecord())
        # the scalar accumulators are read-modify-write: without the
        # lock two handler threads interleave and drop increments,
        # drifting the /v1/stats batching-factor numbers
        with rec.lock:
            rec.seconds += seconds
            rec.count += count
            rec.calls += 1
            rec.recent.append(seconds)

    def _items(self):
        with self._dict_lock:
            return list(self.stages.items())

    @contextmanager
    def timed(self, stage: str, count: int = 1) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0, count)

    def summary(self) -> str:
        lines = []
        for name, rec in self._items():
            lines.append(
                f"{name}: {rec.seconds:.4f}s total, {rec.count} items, "
                f"{rec.calls} calls, {rec.items_per_sec:.1f} items/s, "
                f"{rec.mean_seconds * 1e3:.2f} ms/call"
            )
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "seconds": rec.seconds,
                "count": rec.count,
                "calls": rec.calls,
                "items_per_sec": rec.items_per_sec,
                "items_per_call": rec.items_per_call,
                "mean_seconds": rec.mean_seconds,
                "p50_seconds": rec.percentile_seconds(50),
                "p99_seconds": rec.percentile_seconds(99),
            }
            for name, rec in self._items()
        }


class StageTimer:
    """Context-manager timer for a single stage."""

    def __init__(self) -> None:
        self.seconds = 0.0

    def __enter__(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
