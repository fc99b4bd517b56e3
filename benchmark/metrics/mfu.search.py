"""The dispatches' least time by the peaks (the text tower's operations
at the texts' own lengths or its weight bytes, then the gallery's and
queries' bytes through K1; benchmark/roofline.py), summed over the
window's dispatches, over their measured time (the benchmark's spans
around the text tower and the engine)."""

from benchmark import derive


def read(run):
    if derive.generator(run) != "open_loop":
        return None
    pairs = derive.dispatches(run)
    spent = sum((e[2] - e[1]) + (q[2] - q[1]) for e, q in pairs) / 1e9
    if not pairs or spent <= 0:
        return None
    least = sum(derive.dispatch_least_seconds(run, e, q) for e, q in pairs)
    return 100.0 * least / spent
