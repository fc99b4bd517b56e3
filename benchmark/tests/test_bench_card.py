"""Each cell as committed runs on the card and prints a correct result.

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py

Skips without a card (decided inside the fixture)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _cells():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_a_short_run_of_the_cell_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "3000000017", "--seconds", "3", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert "setup_s" in result["metrics"]
