"""Share of the traced slice of the search window with no operation on the
device."""

from benchmark import derive


def read(run):
    if derive.generator(run) != "open_loop":
        return None
    return derive.idle_share(run)
