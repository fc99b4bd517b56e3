"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name:
`BENCHMARK.json` names the cell's configuration and traffic,
`benchmark/configs/<config>.json` holds the configuration's sizes,
`benchmark/traffic/<traffic>.json` the mix's parameters and the generator
(`benchmark/generators/<generator>.py`) that drives them, and each metric
is read by `benchmark/metrics/<metric>.py`. The limits of the numbers
that decide `correct` are in `benchmark/limits/<cell>.json`.

Set-up (weights and data made on the device from the seed, the system
built through the port's entry points, every shape of the window warmed
up) is timed from the process's start; the window then runs `--seconds`
of traffic; its outputs are held against the plain reference in
`benchmark/reference/` once the window has closed and the system's state
is freed. With `--trace 1` the per-layer metrics are reported, read from
the benchmark's spans, the system's counters and a device trace of part
of the window; otherwise the end-to-end metrics. The last line of
standard output is the result as one JSON object; the numbers compared
for `correct`, each beside its limit, end standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import sys
import time
from typing import Dict, List, Optional, Tuple

PROCESS_CLOCK = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's kernel caches live in the checkout, at fixed paths: the
# CUDA library in mmrs_tpu_torch/_build/, Triton's compiled kernels here
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ.setdefault("USE_FLAX", "0")
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "mmrs_tpu")
TRACE_SLICE = (0.5, 5.0)   # the window's last share, at most so many seconds


def seconds_since_start() -> float:
    """Seconds since this process started (Linux: its start time in
    /proc), else since this module was first run."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return boot - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - PROCESS_CLOCK


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """BENCHMARK.json and the files it names, found by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = load_json(root, "BENCHMARK.json")
        self.bench = os.path.join(root, "benchmark")

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(self.root, c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.bench, "traffic", f"{name}.json")

    def generator(self, name: str):
        return load_module(os.path.join(self.bench, "generators",
                                        f"{name}.py"),
                           f"benchmark.generators.{name}")

    def limits(self, cell: str) -> dict:
        return load_json(self.bench, "limits", f"{cell}.json")

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics, or with `trace` its per-layer
        ones: those that list it, or list no cells."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench, "metrics",
                                        f"{metric}.py"),
                           f"benchmark.metrics.{metric}")


class Run:
    """One run of one cell: its inputs, and what set-up, the window and
    the check leave for the metric readers."""

    def __init__(self, manifest: Manifest, workload: str, seed: int,
                 seconds: float, trace: bool, device, control: bool = False):
        from benchmark.devtrace import DeviceTrace, Spans

        self.manifest = manifest
        self.cell = manifest.cell(workload)
        self.cfg = manifest.config(self.cell["config"])
        self.traffic = manifest.traffic(self.cell["traffic"])
        self.seed, self.seconds, self.device = seed, seconds, device
        self.control = control
        self.spans = Spans()
        share, most = TRACE_SLICE
        length = min(share * seconds, most)
        self.trace = (DeviceTrace(seconds - length, length) if trace
                      else None)
        self.cleanup: List[str] = []
        self.setup_s = self.elapsed = 0.0
        self.attempted = self.failed = self.items = 0
        self.memory_peak = 0
        self.marks: List[Tuple[str, float]] = []

    def mark(self, step: str) -> None:
        """Note that a set-up step has ended (reported on standard error)."""
        self.marks.append((step, seconds_since_start()))

    def start_window(self) -> float:
        """Mark the window's start (set-up ends here); returns it on the
        perf_counter clock."""
        self.setup_s = seconds_since_start()
        start = time.perf_counter()
        if self.trace is not None:
            self.trace.arm(start)
        return start

    def tick(self) -> None:
        """Called by the window's loop between its steps."""
        if self.trace is not None:
            self.trace.poll()


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among loaded modules (or `names`) that are JAX's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None
                                             else names)
                   if m.split(".")[0] in FORBIDDEN})


def execute(run: Run) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """Set up, run the window, check; returns (result, compared numbers
    as (name, value, limit))."""
    import torch

    gen = run.manifest.generator(run.traffic["generator"])
    try:
        gen.setup(run)
        # set-up's objects (modules, weights' views, vocabularies, pools)
        # leave the collector's scans, so that a collection in the window
        # scans what the window makes
        gc.collect()
        gc.freeze()
        if run.trace is not None:
            run.trace.warm()
        gen.window(run)
        if run.trace is not None:
            run.trace.finish()
            print(f"profiler start {run.trace.start_s:.4f} s, stop "
                  f"{run.trace.stop_s:.4f} s, {len(run.trace.events)} device "
                  f"events", file=sys.stderr)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
            run.memory_peak = torch.cuda.max_memory_allocated(run.device)
        gen.release(run)
        checks = gen.check(run)
    finally:
        gc.unfreeze()
        for d in run.cleanup:
            shutil.rmtree(d, ignore_errors=True)
    limits = run.manifest.limits(run.cell["name"])
    compared = [(name, value, float(limits[name])) for name, value in checks]
    metrics = {}
    for m in run.manifest.metrics(run.cell["name"], run.trace is not None):
        value = run.manifest.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(run.memory_peak)}
    result = {"correct": all(v <= lim for _, v, lim in compared),
              "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown(
            run.spans, run.traffic["idle_label"])
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    return result, compared


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the control (the cell's lower-precision path) "
                        "in the system's place; for setting limits only")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    import torch

    manifest = Manifest()
    chips = manifest.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(manifest, args.workload, args.seed, args.seconds,
              bool(args.trace), torch.device("cuda", 0), args.control)
    result, compared = execute(run)
    print("set-up, seconds from the process's start: " + ", ".join(
        f"{step} {t:.2f}" for step, t in run.marks), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, value, limit in compared:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
