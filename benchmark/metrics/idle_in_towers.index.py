"""Share of the traced slice in which the device idles while the build's
thread is inside the port's `towers.upload`, `towers.encode` or
`towers.fetch` span (the pageable upload, the tower's launches, the wait
and the fetch): benchmark/program_spans.py."""

from benchmark import derive, program_spans


def read(run):
    if derive.generator(run) != "index":
        return None
    return program_spans.idle_share(run, "towers")
