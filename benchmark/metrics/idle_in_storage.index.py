"""Share of the traced slice in which the device idles while the build's
thread is inside the port's `gallery.flush` (a shard's write and the
manifest) or `gallery.load` span (the final load and its consolidation
into one file): benchmark/program_spans.py."""

from benchmark import derive, program_spans


def read(run):
    if derive.generator(run) != "index":
        return None
    return program_spans.idle_share(run, "storage")
