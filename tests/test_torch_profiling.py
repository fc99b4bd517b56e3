"""The port's utils/profiling.py (torch.profiler form) against
mmrs_tpu/utils/profiling.py: the same names, the same op tables from one
trace file, and a capture on the CPU that the table reads back; then the
port's span recorder: spans kept only under a capture, with their parent,
thread, counts and stamps, in a bounded ring."""

import gzip
import json
import threading
import time

import pytest
import torch

from mmrs_tpu.utils import profiling as j_profiling
from mmrs_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _trace(path, device_name):
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": device_name}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "python"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "step", "ts": 0,
         "dur": 100},
        {"ph": "X", "pid": 1, "tid": 2, "name": "gemm", "ts": 10, "dur": 30},
        {"ph": "X", "pid": 1, "tid": 2, "name": "gemm", "ts": 45, "dur": 20},
        {"ph": "X", "pid": 1, "tid": 2, "name": "topk", "ts": 70, "dur": 25},
        {"ph": "X", "pid": 1, "tid": 2, "name": "topk", "ts": 120,
         "dur": 40},
        {"ph": "X", "pid": 2, "tid": 3, "name": "host_op", "ts": 5,
         "dur": 500},
    ]
    path.mkdir(parents=True, exist_ok=True)
    with gzip.open(path / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("within", [None, "step"])
@pytest.mark.parametrize("track", ["GPU 0", "/device:TPU:0"])
def test_op_table_equals_jax(tmp_path, within, track):
    _trace(tmp_path, track)
    substr = "GPU" if track.startswith("GPU") else "TPU"
    want = j_profiling.trace_op_table(str(tmp_path), substr, within=within)
    got = profiling.trace_op_table(str(tmp_path), substr, within=within)
    assert got == want
    assert ("host_op", 0.5) not in got
    if within is None:
        assert dict(got)["topk"] == pytest.approx(0.065)


def test_missing_trace_and_span_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.trace_op_table(str(tmp_path))
    _trace(tmp_path, "GPU 0")
    with pytest.raises(ValueError, match="no event named"):
        profiling.trace_op_table(str(tmp_path), within="nope")


def test_capture_on_the_cpu_reads_back(tmp_path):
    @profiling.annotate_fn("scored")
    def scored(x):
        return (x @ x.T).sum()

    x = torch.ones(64, 64)
    with profiling.profile_to(str(tmp_path)):
        with profiling.trace("outer"):
            scored(x)
    rows = dict(profiling.trace_op_table(str(tmp_path), device_substr=""))
    assert "outer" in rows and "scored" in rows
    inner = dict(profiling.trace_op_table(str(tmp_path), device_substr="",
                                          within="outer"))
    assert "scored" in inner and "outer" not in inner
    assert all(isinstance(v, float) for v in inner.values())


# ---- the span recorder ------------------------------------------------------

def _capture():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def ring():
    """An empty ring before and after the test."""
    profiling.spans()
    yield
    profiling.spans()


def test_no_capture_keeps_nothing_and_enters_no_region(ring, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.trace("outer", items=3):
        with profiling.trace("inner", nbytes=8) as inner:
            inner.items = 1

    @profiling.annotate_fn("decorated")
    def f():
        return 7

    assert f() == 7
    assert profiling.spans() == ([], 0)


def test_nested_spans_carry_parent_thread_items_and_bytes(ring, tmp_path):
    seen = []

    def elsewhere():     # another thread: its capture is off
        with profiling.trace("other"):
            pass

    with profiling.profile_to(str(tmp_path)):
        with profiling.trace("outer", items=2) as outer:
            with profiling.trace("inner", items=5, nbytes=640):
                pass
            with profiling.trace("sibling") as sib:
                sib.nbytes = 32
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=30)
            outer.items = 4
            seen.append(threading.get_ident())
    assert not t.is_alive()
    got, dropped = profiling.spans()
    assert dropped == 0
    assert [s.name for s in got] == ["inner", "sibling", "outer"]
    inner, sib, outer = got
    assert outer.parent == 0
    assert inner.parent == sib.parent == outer.sid
    assert {s.thread for s in got} == set(seen)
    assert (inner.items, inner.nbytes) == (5, 640)
    assert (sib.items, sib.nbytes) == (0, 32)
    assert (outer.items, outer.nbytes) == (4, 0)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns \
        <= sib.start_ns <= sib.end_ns <= outer.end_ns
    # the spans are regions of the captured timeline too
    rows = dict(profiling.trace_op_table(str(tmp_path), device_substr=""))
    assert {"outer", "inner", "sibling"} <= set(rows)


def test_a_span_open_when_the_capture_starts_is_kept(ring):
    with profiling.trace("early") as early:
        with profiling.trace("before"):
            pass
        prof = _capture()
        prof.start()
        t0 = time.time_ns()
        with profiling.trace("child"):
            pass
    prof.stop()
    with profiling.trace("after"):
        pass
    got, _ = profiling.spans()
    assert [s.name for s in got] == ["child", "early"]
    child, kept = got
    assert kept.start_ns < t0 <= child.start_ns
    assert child.parent == kept.sid == early.sid


def test_the_ring_drops_the_oldest_spans_and_counts_them(ring, monkeypatch):
    monkeypatch.setattr(profiling, "_RING", profiling._Ring(4))
    with _capture():
        for i in range(7):
            with profiling.trace(f"s{i}", items=i):
                pass
    got, dropped = profiling.spans()
    assert [s.name for s in got] == ["s3", "s4", "s5", "s6"]
    assert [s.items for s in got] == [3, 4, 5, 6]
    assert dropped == 3
    assert profiling.spans() == ([], 0)


def test_stamps_agree_with_kinetos_event_for_the_span(ring):
    names = [f"stamped{i}" for i in range(6)]
    with _capture() as prof:
        for name in names:
            with profiling.trace(name):
                time.sleep(0.002)
    got, _ = profiling.spans()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in names}
    assert [s.name for s in got] == names and set(events) == set(names)
    starts = sorted(abs(events[s.name].start_ns() - s.start_ns) for s in got)
    ends = sorted(abs(events[s.name].end_ns() - s.end_ns) for s in got)
    # the median span within 1 ms at either end
    assert starts[len(starts) // 2] < 1_000_000, starts
    assert ends[len(ends) // 2] < 1_000_000, ends
