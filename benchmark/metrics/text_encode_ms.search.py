"""Milliseconds a dispatch spends in the text tower (tokenizing, the
upload, the tower, the fetch): the service's `text_encode` seconds over
its calls in the window."""

from benchmark import derive


def read(run):
    d = derive.stage_delta(run, "text_encode")
    return None if d is None else 1e3 * d[0] / d[2]
