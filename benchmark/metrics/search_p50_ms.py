"""Median latency of every request due in the window, from when it was
due to its answer."""

from benchmark import derive


def read(run):
    return derive.percentile_ms(run, 50)
