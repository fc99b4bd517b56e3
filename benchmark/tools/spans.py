"""What the port's spans cost, and a traced run with the checks on them.

    python3 benchmark/tools/spans.py cost
    python3 benchmark/tools/spans.py check --workload <cell> --seed <n> \
        [--seconds 20]

`cost` times `utils.profiling.trace` with no capture (ns a span) and under
the device trace's own profiler (us a span, the span kept), and says
whether that profiler turns the recorder on. `check` runs the cell once
with `--trace 1` as run.py does (its result line last on standard output)
and prints a JSON line of checks on standard error: the idle time by
group of benchmark/program_spans.py and its sum against the idle share;
and the clock check, each `towers.fetch` span in the slice against the
last device operation that started before it ended (the fetch waits for
the device, so on one clock the operation ends first); and the shares
again with the device's events moved by 100 us and by 1 ms either way.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import program_spans  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark.devtrace import DeviceTrace  # noqa: E402


def _per_span(n: int) -> float:
    from mmrs_tpu_torch.utils.profiling import trace

    t = time.perf_counter()
    for i in range(n):
        with trace("cost", items=i):
            pass
    return (time.perf_counter() - t) / n


def cost(n_off: int = 200_000, n_on: int = 20_000) -> dict:
    import torch
    from mmrs_tpu_torch.utils import profiling

    profiling.spans()
    _per_span(1000)
    off = _per_span(n_off)
    prof = DeviceTrace._profiler()
    prof.start()
    flag = bool(torch.autograd._profiler_enabled())
    _per_span(100)
    on = _per_span(n_on)
    prof.stop()
    kept, dropped = profiling.spans()
    return {"device": (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu"),
            "recorder_on_under_the_trace": flag,
            "off_ns_per_span": off * 1e9, "on_us_per_span": on * 1e6,
            "kept": len(kept), "dropped": dropped, "asked": n_on + 100}


def fetch_clock(run) -> dict:
    """Each `towers.fetch` span inside the slice against the latest end of
    the device operations that started before the span ended."""
    trace, got = run.trace, program_spans.spans(run) or []
    events = sorted(trace.events, key=lambda e: e[1])
    starts = [e[1] for e in events]
    latest, top = [], 0
    for _, _, b in events:
        top = max(top, b)
        latest.append(top)
    late = []
    for s in got:
        if (s.name == "towers.fetch" and s.start_ns >= trace.t0_ns
                and s.end_ns <= trace.t1_ns):
            i = bisect.bisect_left(starts, s.end_ns)
            if i:
                late.append(latest[i - 1] - s.end_ns)
    late.sort()

    def pct(q):
        return late[min(len(late) - 1, int(q * len(late)))] / 1e3

    return {"fetches": len(late),
            "ended_after_the_device": sum(d <= 0 for d in late),
            "disagreement_us_p50_p90_p99_max": ([pct(0.5), pct(0.9),
                                                 pct(0.99), late[-1] / 1e3]
                                                if late else None)}


def shifted_shares(run, shift_ns: int) -> dict:
    """The idle shares by group with every device event moved `shift_ns`
    later: how far a clock offset of that size moves the readings."""
    trace = run.trace
    moved = DeviceTrace(trace.offset_s, trace.length_s)
    moved.t0_ns, moved.t1_ns = trace.t0_ns, trace.t1_ns
    moved.events = [(n, a + shift_ns, b + shift_ns)
                    for n, a, b in trace.events]
    probe = type("Probe", (), {})()
    probe.trace, probe.program_spans = moved, program_spans.spans(run)
    idle = program_spans.idle_ns(probe) or {}
    window = trace.t1_ns - trace.t0_ns
    return {g: 100.0 * ns / window for g, ns in idle.items()}


def check(workload: str, seed: int, seconds: float) -> int:
    import torch

    run = bench_run.Run(bench_run.Manifest(), workload, seed, seconds, True,
                        torch.device("cuda", 0))
    result, _ = bench_run.execute(run)
    idle = program_spans.idle_ns(run)
    window = run.trace.t1_ns - run.trace.t0_ns
    out = {"workload": workload, "seed": seed,
           "spans": len(program_spans.spans(run) or []),
           "dropped": getattr(run, "program_spans_dropped", 0)}
    if idle is not None:
        shares = {g: 100.0 * ns / window for g, ns in idle.items()}
        out.update(idle_share_by_group=shares,
                   idle_share=result["metrics"]["device_idle.index"]["value"],
                   sum_less_idle_share=sum(shares.values()) - result[
                       "metrics"]["device_idle.index"]["value"])
    out.update(fetch_clock(run))
    if idle is not None:
        out["shares_with_device_events_moved_us"] = {
            str(us): shifted_shares(run, us * 1000)
            for us in (-1000, -100, 100, 1000)}
    print("spans check " + json.dumps(out), file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    sub.add_parser("cost")
    c = sub.add_parser("check")
    c.add_argument("--workload", required=True)
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    if args.what == "cost":
        print(json.dumps(cost()))
        return 0
    return check(args.workload, args.seed, args.seconds)


if __name__ == "__main__":
    sys.exit(main())
