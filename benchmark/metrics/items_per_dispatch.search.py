"""Texts a device dispatch of the service's micro-batcher encodes: its
`text_encode` items over its calls in the window (`SearchService.stats`)."""

from benchmark import derive


def read(run):
    d = derive.stage_delta(run, "text_encode")
    return None if d is None else d[1] / d[2]
