"""Milliseconds a dispatch spends in the engine (the scan K1, its merges,
the hits): the service's `query` seconds over its calls in the window."""

from benchmark import derive


def read(run):
    d = derive.stage_delta(run, "query")
    return None if d is None else 1e3 * d[0] / d[2]
