"""Tracing/profiling, in torch.profiler form.

Counterpart of mmrs_tpu/utils/profiling.py, with the same names:
  - `trace(name)`: a named region of the timeline
    (`torch.profiler.record_function`, in place of
    jax.profiler.TraceAnnotation);
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

import contextlib
from functools import wraps
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str, create_perfetto_link: bool = False
               ) -> Iterator[None]:
    """Capture a trace viewable in TensorBoard / Perfetto. The card's
    kernels are traced when CUDA is available. `create_perfetto_link` is
    accepted for the JAX signature; there is no link to create."""
    import torch
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
