"""The port's own spans in a traced run, and the device's idle time by
the span the build's thread was in.

The port records spans (`mmrs_tpu_torch.utils.profiling.trace`) while
torch's profiler captures on the calling thread, which the device trace
does over its slice of the window. They are taken from the port's ring
once, by the first reader that asks, and kept on the run. A port that
records none (a tree without `profiling.spans`) gives None, and so does
every reader built on it.

Each instant of an idle gap on the device goes to the innermost of the
index path's spans that covers it on the thread that drives the build
(the thread of `gallery.build`), by overlap: a gap that starts in one
span and ends in the next is split between them. The groups:
  towers  -- `towers.upload`, `towers.encode`, `towers.fetch`
  storage -- `gallery.flush`, `gallery.load`
  loop    -- `gallery.build` outside its children (the loop's bookkeeping
             and the stream handing over batches)
  outside -- no `gallery.build` (before it, or after it until the trace
             stops)
The four sum to the slice's idle time.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

BUILD = "gallery.build"
GROUPS = {"towers.upload": "towers", "towers.encode": "towers",
          "towers.fetch": "towers", "gallery.flush": "storage",
          "gallery.load": "storage", BUILD: "loop"}
OUTSIDE = "outside"


def spans(run) -> Optional[list]:
    """The port's spans of this run (`Span` records: name, start_ns,
    end_ns, sid, parent, thread, items, nbytes); None where the port keeps
    none. The port's ring is read, and so emptied, once a run."""
    if not hasattr(run, "program_spans"):
        run.program_spans, run.program_spans_dropped = _take()
    return run.program_spans


def _take() -> Tuple[Optional[list], int]:
    try:
        from mmrs_tpu_torch.utils import profiling
    except ImportError:
        return None, 0
    take = getattr(profiling, "spans", None)
    if take is None:
        return None, 0
    got, dropped = take()
    return got, int(dropped)


def innermost(recs: Sequence, t0: int, t1: int
              ) -> List[Tuple[int, int, str]]:
    """[(a, b, group)] covering [t0, t1] in order: the group of the
    innermost span over [a, b) among `recs` (properly nested spans of one
    thread), else OUTSIDE."""
    recs = sorted(recs, key=lambda s: (s.start_ns, -s.end_ns))
    bounds = sorted({t0, t1} | {min(max(t, t0), t1) for s in recs
                                for t in (s.start_ns, s.end_ns)})
    out: List[Tuple[int, int, str]] = []
    active: list = []
    i = 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(recs) and recs[i].start_ns <= a:
            active.append(recs[i])
            i += 1
        active = [s for s in active if s.end_ns > a]
        inner = max(active, key=lambda s: (s.start_ns, -s.end_ns),
                    default=None)
        group = GROUPS[inner.name] if inner is not None else OUTSIDE
        if out and out[-1][2] == group and out[-1][1] == a:
            out[-1] = (out[-1][0], b, group)
        else:
            out.append((a, b, group))
    return out


def overlap(gaps: Sequence[Tuple[int, int]],
            segments: Sequence[Tuple[int, int, str]]) -> Dict[str, int]:
    """Nanoseconds of the gaps under each segment's group (both lists in
    order, each of disjoint intervals)."""
    out: Dict[str, int] = defaultdict(int)
    j = 0
    for a, b in gaps:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            lo, hi = max(a, segments[k][0]), min(b, segments[k][1])
            if hi > lo:
                out[segments[k][2]] += hi - lo
            k += 1
    return dict(out)


def idle_ns(run) -> Optional[Dict[str, int]]:
    """The traced slice's idle nanoseconds by group (every group present,
    0 where none); None without a trace or without the port's build
    span in the slice."""
    if hasattr(run, "program_idle"):
        return run.program_idle
    run.program_idle = None
    trace = run.trace
    got = spans(run)
    if trace is None or trace.window_s <= 0 or not got:
        return None
    t0, t1 = trace.t0_ns, trace.t1_ns
    inside = [s for s in got if s.end_ns > t0 and s.start_ns < t1]
    builds = [s for s in inside if s.name == BUILD]
    if not builds:
        return None
    thread = builds[0].thread
    mine = [s for s in inside if s.thread == thread and s.name in GROUPS]
    idle = overlap(trace.gaps(), innermost(mine, t0, t1))
    run.program_idle = {g: idle.get(g, 0)
                        for g in ("towers", "storage", "loop", OUTSIDE)}
    return run.program_idle


def idle_share(run, group: str) -> Optional[float]:
    """100 x the group's idle time over the traced slice."""
    idle = idle_ns(run)
    if idle is None:
        return None
    return 100.0 * idle[group] / (run.trace.t1_ns - run.trace.t0_ns)


def rate_gbps(run, name: str) -> Optional[float]:
    """Bytes over seconds of the spans named `name` that lie inside the
    traced slice, in GB/s; None where there are none."""
    trace = run.trace
    got = spans(run)
    if trace is None or not got:
        return None
    inside = [s for s in got if s.name == name
              and s.start_ns >= trace.t0_ns and s.end_ns <= trace.t1_ns]
    ns = sum(s.end_ns - s.start_ns for s in inside)
    if not inside or ns <= 0:
        return None
    return sum(s.nbytes for s in inside) / ns
