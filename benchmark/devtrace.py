"""Host spans and the device trace of a traced run, and their reduction.

Spans are the benchmark's own: (name, start, end) on the host's wall
clock around the calls it makes into the system, in every run. The
device trace is `torch.profiler` over a slice of the window, recording
the card's activity only (kernels, copies, sets), as `chip_smoke.py`'s
`profile_device` does: recording the host's operators too slows a
host-bound path under the profiler. Kineto stamps device events on the
same wall clock (ns since the epoch), which is how gaps on the device are
matched to what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple


class Spans:
    """(name, start ns, end ns, info) of every wrapped call."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, int, int, object]] = []

    def wrap(self, name: str, fn: Callable,
             info: Optional[Callable] = None) -> Callable:
        def spanned(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.records.append((name, t0, time.time_ns(),
                                     info(*args) if info else None))
        return spanned

    def named(self, name: str) -> List[Tuple[str, int, int, object]]:
        return [r for r in self.records if r[0] == name]

    def seconds(self, name: str) -> float:
        return sum(b - a for _, a, b, _ in self.named(name)) / 1e9


class DeviceTrace:
    """torch.profiler (device activity only) over the last `length`
    seconds of the window. The window's own loop calls `poll()` between
    its steps and starts the profiler there, on the thread that drives the
    system; `finish()` stops it once the window's work is done, so the
    stop's cost falls outside every timed request and every timed build.
    `warm()` in set-up pays the profiler's first start."""

    def __init__(self, offset_s: float, length_s: float):
        self.offset_s, self.length_s = offset_s, length_s
        self.t0_ns = self.t1_ns = 0
        self.start_s = self.stop_s = 0.0    # the profiler's own cost
        self.events: List[Tuple[str, int, int]] = []
        self._start = float("inf")
        self._prof = None

    @staticmethod
    def _profiler():
        import torch
        from torch.profiler import ProfilerActivity, profile

        # a build without CUDA (the CPU tests) traces the host alone, and
        # finds no device events
        return profile(activities=[ProfilerActivity.CUDA
                                   if torch.cuda.is_available()
                                   else ProfilerActivity.CPU])

    def warm(self) -> None:
        prof = self._profiler()
        prof.start()
        prof.stop()

    def arm(self, window_start_perf: float) -> None:
        self._start = window_start_perf

    def poll(self) -> None:
        if self._prof is not None or self.t0_ns:
            return
        if time.perf_counter() - self._start >= self.offset_s:
            t = time.perf_counter()
            self._prof = self._profiler()
            self._prof.start()
            self.t0_ns = time.time_ns()
            self.start_s = time.perf_counter() - t

    def finish(self) -> None:
        """Stop the profiler if it runs, and keep the device's events."""
        import torch

        if self._prof is None:
            return
        self.t1_ns = time.time_ns()
        t = time.perf_counter()
        self._prof.stop()
        self.stop_s = time.perf_counter() - t
        cuda = torch.autograd.DeviceType.CUDA
        self.events = [(e.name(), e.start_ns(), e.end_ns())
                       for e in self._prof.profiler.kineto_results.events()
                       if e.device_type() == cuda and e.end_ns() > 0]
        self._prof = None

    # -- reduction -------------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def clipped(self) -> List[Tuple[str, int, int]]:
        return [(n, max(a, self.t0_ns), min(b, self.t1_ns))
                for n, a, b in self.events if b > self.t0_ns and a < self.t1_ns]

    def busy(self) -> List[Tuple[int, int]]:
        """Merged intervals in which an operation ran on the device."""
        out: List[List[int]] = []
        for _, a, b in sorted(self.clipped(), key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        edges = [self.t0_ns] + [t for iv in self.busy() for t in iv] \
            + [self.t1_ns]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def op_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, a, b in self.clipped():
            out[name] += (b - a) / 1e9
        return out

    def seconds_of(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose name
        matches."""
        hits = [b - a for name, a, b in self.clipped() if match(name)]
        return sum(hits) / 1e9, len(hits)

    def breakdown(self, spans: Spans, idle_label: str) -> Dict[str, list]:
        """The ten operations that took most device time, and the device's
        idle time by what the host was doing: the innermost benchmark span
        around each gap's middle, else `idle_label`."""
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:10]
        recs = sorted((r for r in spans.records
                       if r[2] > self.t0_ns and r[1] < self.t1_ns),
                      key=lambda r: r[1])
        starts = [r[1] for r in recs]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid)
            around = [r for r in recs[max(0, i - 8):i] if mid < r[2]]
            name = (min(around, key=lambda r: r[2] - r[1])[0] if around
                    else idle_label)
            idle[name] += (b - a) / 1e9
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."
