"""Arithmetic the metric readers share: counters, spans and the trace."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from benchmark import roofline


def generator(run) -> str:
    return run.traffic["generator"]


def percentile_ms(run, q: float) -> Optional[float]:
    lat = getattr(run, "latency", None)
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, q) * 1e3)


def stage_delta(run, stage: str) -> Optional[Tuple[float, int, int]]:
    """(seconds, items, calls) a serving stage spent in the window, from
    the service's own counters (`SearchService.stats`)."""
    s1 = getattr(run, "stats1", {}).get(stage)
    if not s1 or not s1["calls"]:
        return None
    s0 = run.stats0.get(stage, {"seconds": 0.0, "count": 0, "calls": 0})
    calls = s1["calls"] - s0["calls"]
    if calls <= 0:
        return None
    return (s1["seconds"] - s0["seconds"], s1["count"] - s0["count"], calls)


def dispatches(run) -> List[Tuple[tuple, tuple]]:
    """The window's device dispatches: (text_encode span, query span)
    pairs in order, each span (name, start ns, end ns, info)."""
    enc, qry = run.spans.named("text_encode"), run.spans.named("query")
    return list(zip(enc, qry))


def text_flops(run, token_counts) -> float:
    spec = run.cfg["text_tower"]
    count = roofline.TEXT_FLOPS[spec["kind"]]
    return sum(count(spec, t) for t in token_counts)


def k1_seconds(run, queries: int) -> float:
    g = run.cfg["gallery"]
    return roofline.least_seconds(
        roofline.k1_flops(g["rows"], g["dim"], queries),
        roofline.k1_bytes(g["rows"], g["dim"], queries, run.traffic["k"]))


def dispatch_least_seconds(run, enc, qry) -> float:
    """The least time of one dispatch by the peaks: the text tower (its
    operations at the texts' own lengths, or its weight bytes) and then
    K1's bytes."""
    spec = run.cfg["text_tower"]
    tower = roofline.least_seconds(
        text_flops(run, enc[3]),
        roofline.TEXT_WEIGHT_BYTES[spec["kind"]](spec))
    return tower + k1_seconds(run, qry[3])


def idle_share(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def kernel_roofline(run, match: Callable[[str], bool], least_of_launch=None,
                    least_total=None) -> Optional[float]:
    """100 x the least time over the device time of the matching kernels
    in the trace; None where the trace holds none of them."""
    if run.trace is None:
        return None
    seconds, launches = run.trace.seconds_of(match)
    if not launches or seconds <= 0:
        return None
    least = (least_total if least_total is not None
             else launches * least_of_launch)
    return 100.0 * least / seconds
