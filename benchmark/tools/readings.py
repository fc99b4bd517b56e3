"""Readings that the limits of `correct` are set from, in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 101-112 \
        [--control-seeds 201-203] [--seconds 4]

Runs the cell (short windows, untraced) once a seed, then its control
(the lower-precision path in the system's place, `run.py --control`)
once a control seed, and prints one JSON line a run with the numbers
compared. The limits in benchmark/limits/<cell>.json lie between the
largest sound reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import run as bench_run  # noqa: E402


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args()
    import torch

    manifest = bench_run.Manifest()
    todo = [(s, False) for s in seeds(args.seeds)]
    todo += [(s, True) for s in seeds(args.control_seeds)]
    for seed, control in todo:
        t0 = time.perf_counter()
        run = bench_run.Run(manifest, args.workload, seed, args.seconds,
                            False, torch.device("cuda", 0), control)
        result, compared = bench_run.execute(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control,
                          "compared": {n: v for n, v, _ in compared},
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
