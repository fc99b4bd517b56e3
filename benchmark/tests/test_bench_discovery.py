"""run.py finds configurations, traffic mixes, generators and metric
readers by name alone, and a new one of each is a new file and a new
BENCHMARK.json entry."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests import tiny

pytestmark = pytest.mark.usefixtures("cpu_port")


@pytest.fixture
def cpu_port(monkeypatch):
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")


def test_the_real_manifest_names_files_that_exist():
    m = bench_run.Manifest()
    assert m.data["command"] == ["python3", "benchmark/run.py"]
    for c in m.data["configs"]:
        assert os.path.exists(os.path.join(m.root, c["file"]))
    for w in m.data["workloads"]:
        m.config(w["config"])
        traffic = m.traffic(w["traffic"])
        m.generator(traffic["generator"])
        m.limits(w["name"])
        for trace in (False, True):
            for metric in m.metrics(w["name"], trace):
                assert hasattr(m.reader(metric["name"]), "read")


def test_each_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    m = bench_run.Manifest()
    for w in m.data["workloads"]:
        e2e = [x["name"] for x in m.metrics(w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics(w["name"], True)


def test_a_new_config_traffic_and_metric_are_files_and_entries(tmp_path):
    """A copy of the tiny benchmark gains a configuration, a traffic mix and
    a per-layer metric by adding files and entries only; the new cell runs
    and reports the new metric."""
    root = tiny.make_root(str(tmp_path / "root"))
    bench = os.path.join(root, "benchmark")
    # the metric readers are linked from the repository: copy them, so
    # that the new reader lands in this copy only
    metrics = os.path.join(bench, "metrics")
    os.unlink(metrics)
    shutil.copytree(os.path.join(tiny.BENCH, "metrics"), metrics)
    with open(os.path.join(metrics, "rows_seen.index.py"), "w") as f:
        f.write("def read(run):\n    return float(run.items)\n")
    cfg = tiny.tiny("tiny-clip")
    cfg["gallery"]["rows"] = 4096
    with open(os.path.join(bench, "configs", "tiny-clip-2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "index.json")) as f:
        traffic = json.load(f)
    traffic["batch"] = 8
    with open(os.path.join(bench, "traffic", "index_small.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(bench, "limits", "t-clip.index.json"),
                os.path.join(bench, "limits", "t2.index.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["configs"].append({"name": "tiny-clip-2", "source": "tiny",
                                "file": "benchmark/configs/tiny-clip-2.json",
                                "reduced": [], "why": "tests"})
    manifest["workloads"].append({"name": "t2.index", "config": "tiny-clip-2",
                                  "traffic": "index_small", "chips": 1,
                                  "why": "tests"})
    manifest["per_layer"].append({
        "name": "rows_seen.index", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "index/gallery",
        "moves": "index_img_per_s", "workloads": ["t2.index"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    m = bench_run.Manifest(root)
    r = bench_run.Run(m, "t2.index", 5, 1.0, True, torch.device("cpu"))
    result, _ = bench_run.execute(r)
    assert r.traffic["batch"] == 8
    assert result["metrics"]["rows_seen.index"]["value"] == result[
        "attempted"] > 0
    assert result["attempted"] % 8 == 0
