"""Find the highest rate a search cell sustains: one set-up, then the
cell's open-loop window at each offered rate in turn.

    python3 benchmark/tools/sweep.py --workload <cell> --rates 100,200,400 \
        [--seconds 8] [--seed 7]

Prints one JSON line a rate: offered and answered rates, p50 / p95 / p99
latency from the due times, the senders' mean lag, texts a dispatch, and
how long the window ran past its last due time (a backlog that grows
through the window shows there); then the knee: the highest rate that,
with every lower rate swept, answers 97% of what is offered with a p95
at most twice the lowest rate's. The cell's traffic file fixes its rate
at four fifths of the knee, rounded to 10 queries a second.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import derive  # noqa: E402
from benchmark import run as bench_run  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()
    import torch

    run = bench_run.Run(bench_run.Manifest(), args.workload, args.seed,
                        args.seconds, False, torch.device("cuda", 0))
    gen = run.manifest.generator(run.traffic["generator"])
    gen.setup(run)
    rows = []
    for rate in sorted(float(r) for r in args.rates.split(",")):
        run.traffic["rate_qps"] = rate
        run.spans.records.clear()
        run.stats0 = run.service.stats.as_dict()
        gen.window(run)
        lat = run.latency
        d = derive.stage_delta(run, "text_encode")
        rows.append({
            "workload": args.workload, "offered_qps": rate,
            "answered_qps": run.items / run.elapsed,
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "lag_ms": float(np.nanmean(run.lag) * 1e3),
            "items_per_dispatch": d[1] / d[2] if d else None,
            "overrun_s": run.elapsed - args.seconds,
            "failed": run.failed})
        print(json.dumps(rows[-1]), flush=True)
    gen.release(run)
    print(json.dumps(knee(rows)))
    return 0


def knee(rows):
    """The highest offered rate that, with every lower one, keeps up (97%
    answered, none failed) with a p95 at most twice the lowest rate's."""
    limit = 2 * rows[0]["p95_ms"]
    best = None
    for r in rows:
        if (r["answered_qps"] < 0.97 * r["offered_qps"] or r["failed"]
                or r["p95_ms"] > limit):
            break
        best = r["offered_qps"]
    return {"workload": rows[0]["workload"], "p95_limit_ms": limit,
            "knee_qps": best,
            "rate_qps": None if best is None else 10 * round(0.08 * best)}


if __name__ == "__main__":
    sys.exit(main())
