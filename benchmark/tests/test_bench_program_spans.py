"""The port's spans against a hand-made trace: idle gaps attributed by
overlap to the innermost span of the build's thread, the shares summing
to the idle share, the upload rate, and readers that give None where the
port keeps no spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans
from benchmark import run as bench_run
from benchmark.devtrace import DeviceTrace
from mmrs_tpu_torch.utils import profiling
from mmrs_tpu_torch.utils.profiling import Span

READERS = ("idle_in_towers.index", "idle_in_storage.index",
           "idle_in_loop.index", "upload_gbps.index")


def _span(name, a, b, thread=1, nbytes=0):
    return Span(name, a, b, 0, 0, thread, 0, nbytes)


def _run(spans, events=((1000, 1100), (1300, 1400), (1700, 1750))):
    """Slice [1000, 2000] ns; the device busy 250 ns of it."""
    trace = DeviceTrace(0.0, 1.0)
    trace.t0_ns, trace.t1_ns = 1000, 2000
    trace.events = [("op", a, b) for a, b in events]
    run = SimpleNamespace(traffic={"generator": "index"}, trace=trace)
    if spans is not None:
        run.program_spans, run.program_spans_dropped = list(spans), 0
    return run


SPANS = [
    _span("towers.upload", 950, 1010, nbytes=1000),   # starts before the slice
    _span("towers.upload", 1050, 1150, nbytes=500),
    _span("towers.encode", 1150, 1250),
    _span("towers.fetch", 1250, 1350),
    _span("gallery.flush", 1500, 1600),
    _span("gallery.load", 1600, 1800),
    _span("gallery.build", 900, 1900),
    # another thread's span, over the loop's gap: not the build's thread
    _span("towers.encode", 1400, 1700, thread=2),
]


def _read(run):
    m = bench_run.Manifest()
    return {name: m.reader(name).read(run) for name in READERS}


def test_gaps_go_by_overlap_to_the_innermost_span():
    run = _run(SPANS)
    # gap [1100, 1300]: upload 50, encode 100, fetch 50; gap [1400, 1700]:
    # the loop 100, flush 100, load 100 (its middle lies in the flush);
    # gap [1750, 2000]: load 50, the loop 100, after the build 100
    assert program_spans.idle_ns(run) == {"towers": 200, "storage": 250,
                                          "loop": 200, "outside": 100}
    got = _read(run)
    assert got["idle_in_towers.index"] == pytest.approx(20.0)
    assert got["idle_in_storage.index"] == pytest.approx(25.0)
    assert got["idle_in_loop.index"] == pytest.approx(20.0)
    # only the upload inside the slice: 500 bytes in 100 ns
    assert got["upload_gbps.index"] == pytest.approx(5.0)


@pytest.mark.parametrize("events", [
    ((1000, 1100), (1300, 1400), (1700, 1750)),
    ((990, 1020), (1010, 1200), (1500, 1510), (1890, 1950)),
    (),
    ((1000, 2000),),
])
def test_the_shares_and_the_idle_outside_sum_to_the_idle_share(events):
    run = _run(SPANS, events)
    got = _read(run)
    outside = 100.0 * program_spans.idle_ns(run)["outside"] / 1000
    idle = bench_run.Manifest().reader("device_idle.index").read(run)
    assert sum(got[n] for n in READERS[:3]) + outside == pytest.approx(idle)


def test_idle_under_no_span_is_outside():
    # the build idles [1100, 1120]; a load after it is still storage
    run = _run([_span("gallery.build", 1050, 1120),
                _span("gallery.load", 1500, 1600)])
    assert program_spans.idle_ns(run) == {"towers": 0, "storage": 100,
                                          "loop": 20, "outside": 630}


def test_readers_give_none_where_the_port_keeps_no_spans(monkeypatch):
    # a port whose profiling module has no recorder (an older tree)
    monkeypatch.delattr(profiling, "spans")
    run = _run(None)
    assert _read(run) == dict.fromkeys(READERS)
    # spans, but no build among them; and no trace at all
    assert _read(_run([_span("towers.encode", 1100, 1200)]))[
        "idle_in_towers.index"] is None
    no_trace = _run(SPANS)
    no_trace.trace = None
    assert _read(no_trace) == dict.fromkeys(READERS)


def test_the_ring_is_read_once_a_run():
    profiling.spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.trace("gallery.build"):
            with profiling.trace("towers.upload", nbytes=64):
                pass
    run = _run(None)
    first = program_spans.spans(run)
    assert [s.name for s in first] == ["towers.upload", "gallery.build"]
    assert profiling.spans() == ([], 0)
    assert program_spans.spans(run) is first
