"""Rate of the pageable host-to-device upload of the build's pixels: the
bytes of the port's `towers.upload` spans inside the traced slice over
their seconds on the host's clock, in GB/s."""

from benchmark import derive, program_spans


def read(run):
    if derive.generator(run) != "index":
        return None
    return program_spans.rate_gbps(run, "towers.upload")
