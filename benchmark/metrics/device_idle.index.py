"""Share of the traced slice of the build with no operation on the
device."""

from benchmark import derive


def read(run):
    if derive.generator(run) != "index":
        return None
    return derive.idle_share(run)
