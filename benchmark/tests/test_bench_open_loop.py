"""The open-loop generator keeps its schedule whatever the system does,
times each request from when it was due, and reports how late it sent."""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark import data
from benchmark.generators import open_loop


class _Stats:
    def as_dict(self):
        return {}


class _Service:
    """Answers one request at a time, each taking `busy` seconds."""

    def __init__(self, busy: float):
        self.busy, self.lock, self.stats = busy, threading.Lock(), _Stats()

    def search_texts(self, texts, k):
        with self.lock:
            time.sleep(self.busy)
        return [[{"path": "r0", "score": 1.0, "rank": 0, "cls": ""}]]


class _Run:
    def __init__(self, busy, rate, senders, seconds=1.0):
        self.traffic = {"rate_qps": rate, "k": 1, "senders": senders,
                        "logit_scale": 100.0}
        self.seconds, self.seed = seconds, 11
        self.texts = ["a b c"] * 8
        self.service = _Service(busy)

    def start_window(self):
        self.start = time.perf_counter()
        return self.start

    def tick(self):
        pass


def test_arrivals_are_the_same_work_for_every_seed():
    a, b = data.arrivals(200, 2.0, 1), data.arrivals(200, 2.0, 2)
    assert len(a) == len(b) == 400
    assert np.isclose(a[-1], 2.0) and np.isclose(b[-1], 2.0)
    np.testing.assert_allclose(np.sort(np.diff(a, prepend=0)),
                               np.sort(np.diff(b, prepend=0)), atol=1e-12)
    assert not np.array_equal(a, b)


def test_a_slow_system_is_charged_its_queue():
    """Offered 100 requests a second to a system that answers 50: the
    schedule holds, so the backlog grows and the latencies from the due
    times with it; two senders block, so sending lags too."""
    run = _Run(busy=0.02, rate=100, senders=2)
    open_loop.window(run)
    assert run.attempted == 100 and run.failed == 0
    assert np.all(run.latency >= 0.02 - 1e-3)
    assert run.latency[-10:].mean() > 0.5          # the queue grew
    assert run.latency.max() > run.lag.max() > 0.3  # waiting to be sent counts
    assert np.all(run.latency >= run.lag)


def test_a_fast_system_is_sent_on_time():
    run = _Run(busy=0.001, rate=50, senders=8)
    open_loop.window(run)
    assert run.attempted == 50 and run.failed == 0
    assert np.median(run.lag) < 5e-3
    assert np.median(run.latency) < 0.02


def test_the_knee_is_the_last_rate_of_a_run_that_keeps_up():
    from benchmark.tools import sweep

    def row(rate, answered, p95, failed=0):
        return {"workload": "w", "offered_qps": rate, "answered_qps": answered,
                "p95_ms": p95, "failed": failed}

    rows = [row(100, 100, 30), row(200, 199, 40), row(400, 395, 59),
            row(800, 790, 61), row(1600, 1590, 50)]
    k = sweep.knee(rows)
    assert k["knee_qps"] == 400 and k["rate_qps"] == 320
    rows[1] = row(200, 150, 40)          # fell behind: the knee is below
    assert sweep.knee(rows)["knee_qps"] == 100
