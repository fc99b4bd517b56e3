"""K1 (the flat bf16 cosine top-k: csrc/span_scan.cuh's scan and the
merge passes, ops/topk) in the traced slice: its least time (the gallery
and queries read once, or its operations if longer; benchmark/roofline.py)
over its device time. A dispatch launches one scan, so the slice's scans
are priced at the mean least time of the dispatches that overlap it (the
host's and the device's clocks need not agree to the millisecond)."""

from benchmark import derive


def read(run):
    if derive.generator(run) != "open_loop" or run.trace is None:
        return None
    inside = [q for q in run.spans.named("query")
              if q[2] > run.trace.t0_ns and q[1] < run.trace.t1_ns]
    scans = run.trace.seconds_of(lambda n: "span_scan_kernel" in n)[1]
    if not inside or not scans:
        return None
    mean = sum(derive.k1_seconds(run, q[3]) for q in inside) / len(inside)
    return derive.kernel_roofline(
        run, lambda n: "span_scan_kernel" in n or "topk_merge" in n,
        least_total=scans * mean)
