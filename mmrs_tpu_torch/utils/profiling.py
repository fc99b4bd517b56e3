"""Tracing/profiling, in torch.profiler form.

Counterpart of mmrs_tpu/utils/profiling.py, with the same names:
  - `trace(name, items=0, nbytes=0)`: a named span of the host's work.
    While torch's profiler captures on the calling thread, the span is
    kept in an in-memory ring (read by `spans()`) and is a
    `torch.profiler.record_function` region of the captured timeline (in
    place of jax.profiler.TraceAnnotation); otherwise it costs a clock
    read and a flag check;
  - `spans()`: the kept spans, oldest first, and how many the ring
    dropped; the ring is emptied;
  - `profile_to(dir)`: captures a trace of the host and, where there is a
    card, of its kernels, written as `*.pt.trace.json.gz` (Chrome /
    Perfetto / TensorBoard format) under `dir`;
  - `annotate_fn`: the decorator form of `trace`;
  - `trace_op_table(dir)`: per-op device-time totals from the newest
    trace, restricted to tracks whose process name holds `device_substr`
    (the card's kernels sit on a "GPU <n>" track), optionally only inside
    a named span.
StageStats (utils/stats.py) remains the lightweight wall-clock layer.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from functools import wraps
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch

# spans kept between two reads; past this the oldest are dropped (and
# counted). A traced index build keeps a few per batch.
RING_SPANS = 1 << 15

_capturing = torch.autograd._profiler_enabled   # this thread's capture


class Span(NamedTuple):
    """One kept span. Stamps are `time.time_ns()`, the wall clock that
    kineto stamps device events on. `parent` is the `sid` of the span that
    enclosed it on the same thread (0: none); `items` and `nbytes` are
    what the caller counted (rows, images, bytes moved)."""
    name: str
    start_ns: int
    end_ns: int
    sid: int
    parent: int
    thread: int
    items: int
    nbytes: int


class _Ring:
    def __init__(self, capacity: int):
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=capacity)
        self._dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    def take(self) -> Tuple[List[Span], int]:
        with self._lock:
            out, dropped = list(self._spans), self._dropped
            self._spans.clear()
            self._dropped = 0
        return out, dropped


class _Open(threading.local):
    top: Optional["trace"] = None     # the innermost open span


_RING = _Ring(RING_SPANS)
_OPEN = _Open()
_IDS = itertools.count(1)


class trace:
    """`with trace(name, items, nbytes) as sp:` spans the block; `sp.items`
    and `sp.nbytes` may be set inside it. The start is stamped on entry
    whether or not a capture runs, so a span opened before a capture
    started and closed inside it is kept; the record_function region is
    entered only for spans opened under capture."""

    __slots__ = ("name", "items", "nbytes", "start_ns", "sid", "up", "_rf")

    def __init__(self, name: str, items: int = 0, nbytes: int = 0):
        self.name, self.items, self.nbytes = name, items, nbytes
        self._rf = None

    def __enter__(self) -> "trace":
        self.start_ns = time.time_ns()
        self.sid = next(_IDS)
        self.up = _OPEN.top
        _OPEN.top = self
        if _capturing():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.top = self.up
        keep = _capturing()
        end_ns = time.time_ns() if keep else 0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if keep:
            _RING.add(Span(self.name, self.start_ns, end_ns, self.sid,
                           self.up.sid if self.up is not None else 0,
                           threading.get_ident(), int(self.items),
                           int(self.nbytes)))


def spans() -> Tuple[List[Span], int]:
    """(the kept spans in the order they closed, how many the ring dropped
    since the last read); empties the ring."""
    return _RING.take()


@contextlib.contextmanager
def profile_to(log_dir: str, create_perfetto_link: bool = False
               ) -> Iterator[None]:
    """Capture a trace viewable in TensorBoard / Perfetto. The card's
    kernels are traced when CUDA is available. `create_perfetto_link` is
    accepted for the JAX signature; there is no link to create."""
    from torch.profiler import ProfilerActivity, profile

    del create_perfetto_link
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=torch.profiler.tensorboard_trace_handler(
                     log_dir, use_gzip=True)):
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def annotate_fn(name: Optional[str] = None):
    def deco(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*a, **kw):
            with trace(label):
                return fn(*a, **kw)

        return wrapper

    return deco


def _device_events(log_dir: str, device_substr: str) -> list:
    """Complete ('X') events on matching tracks from the newest trace under
    log_dir: [(name, pid, ts, dur_us), ...]."""
    import glob
    import gzip
    import json
    import os

    files = sorted(glob.glob(f"{log_dir}/**/*.trace.json.gz", recursive=True),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace.json.gz under {log_dir!r}")
    with gzip.open(files[-1]) as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    track_names = {
        e["pid"]: str(e.get("args", {}).get("name", ""))
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    return [
        (e["name"], e["pid"], e.get("ts", 0), e.get("dur", 0))
        for e in events
        if (e.get("ph") == "X"
            and device_substr in track_names.get(e.get("pid"), ""))
    ]


def trace_op_table(log_dir: str, device_substr: str = "GPU",
                   top: int = 25, within: Optional[str] = None) -> list:
    """Summarize a captured trace into per-op device-time totals.

    Reads the newest `*.trace.json.gz` under `log_dir` (what `profile_to`
    writes) and returns [(op_name, total_ms), ...] sorted by time,
    restricted to tracks whose process name holds `device_substr`.

    `within="name"` restricts the table to ops whose time interval nests
    inside an event of that name on the same track (a span's ops).
    """
    from collections import Counter

    evs = _device_events(log_dir, device_substr)
    if within is not None:
        spans = [(pid, ts, ts + dur) for name, pid, ts, dur in evs
                 if name == within]
        if not spans:
            raise ValueError(f"no event named {within!r} in the trace")
        evs = [
            (name, pid, ts, dur) for name, pid, ts, dur in evs
            if name != within and any(
                pid == sp and ts >= s0 and ts + dur <= s1
                for sp, s0, s1 in spans)
        ]
    totals: Counter = Counter()
    for name, _pid, _ts, dur in evs:
        totals[name] += dur
    return [(name, us / 1e3) for name, us in totals.most_common(top)]
