"""A run with its timed path broken underneath reads `correct` false, and
its control (the lower-precision path) fails the limits that sound runs
pass. Tiny cells on the CPU, with limits of their own set between their
sound readings (seeds 21-23: 90th-percentile row gaps 0.005-0.008,
score gaps 0.002-0.008, rank gaps 0.001-0.004) and their controls' (row
gaps 0.016-0.089; B/32 score 0.013-0.027, rank 0.014-0.023)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark import system
from benchmark.tests import tiny

CPU = torch.device("cpu")
LIMITS = {"t-clip.index": {"rows_lost": 0, "rows_misplaced": 0,
                           "row_gap_p90": 0.012},
          "t-taiyi.index": {"rows_lost": 0, "rows_misplaced": 0,
                            "row_gap_p90": 0.012},
          "t-clip.search": {"unanswered": 0, "bad_answers": 0,
                            "score_gap": 0.01, "rank_gap": 0.005},
          "t-taiyi.search": {"unanswered": 0, "bad_answers": 0,
                             "score_gap": 0.01, "rank_gap": 0.005}}


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")
    r = tiny.make_root(str(tmp_path), LIMITS)
    # every answered request of a search run is compared, and batches form
    import json
    import os
    for mix in ("search_en_poisson", "search_zh_poisson"):
        path = os.path.join(r, "benchmark", "traffic", f"{mix}.json")
        with open(path) as f:
            t = json.load(f)
        t.update(rate_qps=200, sample_requests=100000)
        with open(path, "w") as f:
            json.dump(t, f)
    return r


def _run(root, cell, control=False, seconds=1.0):
    r = bench_run.Run(bench_run.Manifest(root), cell, 21, seconds, False,
                      CPU, control)
    result, _ = bench_run.execute(r)
    return result


def _previous(fn):
    """Returns the previous call's answer: a step that leaves its state
    unchanged."""
    last = {}

    def broken(x):
        out = fn(x)
        prev = last.get("out", out)
        last["out"] = out
        reps = -(-len(out) // len(prev))
        return np.concatenate([prev] * reps)[:len(out)]
    return broken


def _half(fn):
    """Encodes every other input and repeats it: half of the batch left
    out."""
    def broken(x):
        out = fn(x[::2])
        return np.repeat(out, 2, axis=0)[:len(x)]
    return broken


def _altered(fn):
    """One answer altered where it is produced: the first row of each call
    replaced by its neighbour's."""
    def broken(x):
        out = np.array(fn(x))
        if len(out) > 1:
            out[0] = out[1]
        else:
            out[0] = -out[0]
        return out
    return broken


def _break(monkeypatch, attr, fault):
    real = system.towers

    def towers(*a, **k):
        t = real(*a, **k)
        setattr(t, attr, fault(getattr(t, attr)))
        return t
    monkeypatch.setattr(system, "towers", towers)


@pytest.mark.parametrize("cell", ["t-clip.index", "t-taiyi.index",
                                  "t-clip.search", "t-taiyi.search"])
def test_sound_runs_are_correct(root, cell):
    result = _run(root, cell)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("cell,attr", [("t-clip.index", "image_encode"),
                                       ("t-clip.search", "text_encode"),
                                       ("t-taiyi.search", "text_encode")])
@pytest.mark.parametrize("fault", [_previous, _half, _altered])
def test_a_broken_path_is_not_correct(root, monkeypatch, cell, attr, fault):
    _break(monkeypatch, attr, fault)
    result = _run(root, cell)
    assert not result["correct"], result["compared"]


def test_a_wrong_answer_from_the_engine_is_not_correct(root, monkeypatch):
    from mmrs_tpu_torch.search import engine

    real = engine.SearchEngine.query_vectors

    def wrong(self, vectors, top_k=None):
        hits = real(self, vectors, top_k)
        for h in hits:
            h[0].path = f"r{(int(h[0].path[1:]) + 1) % len(self.index)}"
        return hits
    monkeypatch.setattr(engine.SearchEngine, "query_vectors", wrong)
    assert not _run(root, "t-clip.search")["correct"]


def test_the_control_is_not_correct(root):
    """The index cells' control is the port's own int8 tower."""
    result = _run(root, "t-clip.index", control=True)
    assert not result["correct"], result["compared"]


def test_the_search_control_is_not_correct(root):
    """The search cells' control is the reference in the system's place,
    its text tower and scan on int8 codes."""
    result = _run(root, "t-clip.search", control=True)
    assert not result["correct"], result["compared"]
