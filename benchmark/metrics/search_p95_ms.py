"""95th percentile latency of every request due in the window, from when
it was due to its answer (an unanswered one waited to the end)."""

from benchmark import derive


def read(run):
    return derive.percentile_ms(run, 95)
