"""Images indexed over the whole `build_index` call: every row in the
returned index over the seconds from the call to its return."""

from benchmark import derive


def read(run):
    if derive.generator(run) != "index" or run.elapsed <= 0:
        return None
    return run.items / run.elapsed
