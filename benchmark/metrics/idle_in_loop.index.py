"""Share of the traced slice in which the device idles while the build's
thread is inside the port's `gallery.build` span and none of its
children: the build loop's bookkeeping and the stream handing over
batches (benchmark/program_spans.py)."""

from benchmark import derive, program_spans


def read(run):
    if derive.generator(run) != "index":
        return None
    return program_spans.idle_share(run, "loop")
