"""The port's utils/profiling.py (torch.profiler form) against
mmrs_tpu/utils/profiling.py: the same names, the same op tables from one
trace file, and a capture on the CPU that the table reads back."""

import gzip
import json

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
