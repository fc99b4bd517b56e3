"""The index_kind mix on the CPU at a tiny size: a SigLIP cell built by
files and entries alone (`builders/siglip_vit.py`, `reference/
siglip_vit.py`), correct when sound, not correct with its timed path
broken underneath or as its control (the port's int8 tower); its readers
against hand arithmetic.

The tiny cell's `row_gap_p90` limit is L^0.4 U^0.6 of its own readings
(seeds 21-23, one-second windows: one batch of 16 on the CPU): sound
0.0049-0.0060, the control 0.0279-0.0330."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import devtrace, program_spans, roofline, roofline_siglip
from benchmark import run as bench_run
from benchmark.builders import siglip_vit as builder
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELL = "t-siglip.index"
LIMITS = {"rows_lost": 0, "rows_misplaced": 0, "row_gap_p90": 0.015}
METRICS = ("mfu.index_kind", "k2_roofline.index_kind",
           "e1_roofline.index_kind")
# the index builds' readers, which read this mix's runs as they are
INDEX = ("index_self_share.index", "device_idle.index",
         "idle_in_towers.index", "idle_in_storage.index",
         "idle_in_loop.index", "upload_gbps.index")


def _load(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def tiny_siglip() -> dict:
    """The cell's configuration at the port's `siglip_tiny` sizes."""
    cfg = _load(tiny.BENCH, "configs", "siglip-so400m-384.json")
    cfg["port"] = {"image_tower": "siglip_tiny",
                   "text_tower": "siglip_text_tiny"}
    cfg["image_tower"].update(image_size=62, width=144, layers=2, heads=2,
                              mlp_width=152, embed_dim=144)
    cfg["text_tower"].update(vocab_size=512, context_length=16, width=144,
                             layers=2, heads=2, mlp_width=152, embed_dim=144)
    return cfg


def make_root(tmp: str) -> str:
    """A tiny root with the SigLIP index cell added as the real one is:
    a configuration, the traffic, limits and entries."""
    root = tiny.make_root(tmp)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny-siglip.json"), "w") as f:
        json.dump(tiny_siglip(), f)
    traffic = _load(tiny.BENCH, "traffic", "index_kind.json")
    traffic.update(tiny.TRAFFIC_CHANGES["index"])
    with open(os.path.join(bench, "traffic", "index_kind.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "limits", f"{CELL}.json"), "w") as f:
        json.dump(LIMITS, f)
    manifest = _load(root, "BENCHMARK.json")
    manifest["configs"].append({"name": "tiny-siglip", "source": "tiny",
                                "file": "benchmark/configs/tiny-siglip.json",
                                "reduced": [], "why": "tests"})
    manifest["workloads"].append({"name": CELL, "config": "tiny-siglip",
                                  "traffic": "index_kind", "chips": 1,
                                  "why": "tests"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] == "index_img_per_s" or m["name"] in METRICS + INDEX:
            m["workloads"] = [CELL]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")
    return make_root(str(tmp_path / "root"))


def _run(root, control=False, trace=False, seed=21):
    r = bench_run.Run(bench_run.Manifest(root), CELL, seed, 1.0, trace, CPU,
                      control)
    result, _ = bench_run.execute(r)
    return result, r


def test_a_sound_run_is_correct_and_reports_the_index_metrics(root):
    result, r = _run(root)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "index_img_per_s"}
    assert result["metrics"]["index_img_per_s"]["value"] == pytest.approx(
        r.items / r.elapsed)
    assert r.index.dim == 144


def test_a_traced_run_reports_its_layers(root):
    result, r = _run(root, trace=True)
    assert result["correct"], result["compared"]
    got = result["metrics"]
    # the CPU trace holds no device kernel: the two rooflines stay silent;
    # the index builds' readers read the run as they read B/32's
    assert set(got) == {"mfu.index_kind", *INDEX}
    assert got["device_idle.index"]["value"] == pytest.approx(100.0)
    assert sum(got[f"idle_in_{g}.index"]["value"]
               for g in ("towers", "storage", "loop")) <= 100.0 + 1e-9
    spec = r.cfg["image_tower"]
    assert got["mfu.index_kind"]["value"] == pytest.approx(
        100 * roofline_siglip.tower_flops_per_image(spec) * r.items
        / (r.elapsed * roofline.BF16_FLOPS))


def _previous(fn):
    last = {}

    def broken(x):
        out = fn(x)
        prev = last.get("out", out)
        last["out"] = out
        return prev[:len(out)] if len(prev) >= len(out) else out
    return broken


def _altered(fn):
    def broken(x):
        out = np.array(fn(x))
        out[0] = out[1]
        return out
    return broken


@pytest.mark.parametrize("fault", [_previous, _altered])
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    real = builder.build

    def build(*a, **k):
        towers = real(*a, **k)
        towers.image_encode = fault(towers.image_encode)
        return towers
    monkeypatch.setattr(builder, "build", build)
    result, _ = _run(root)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("seed", [21, 22])
def test_the_control_is_not_correct(root, seed):
    """The control is the port's int8 tower, through the same builder."""
    sound, _ = _run(root, seed=seed)
    control, _ = _run(root, control=True, seed=seed)
    assert sound["correct"] and not control["correct"], (
        sound["compared"], control["compared"])


def test_the_work_counts_match_hand_arithmetic():
    spec = _load(tiny.BENCH, "configs", "siglip-so400m-384.json")[
        "image_tower"]
    w, t, h = 1152, 729, 4304
    block = 2 * t * (4 * w * w + 2 * w * h) + 4 * t * t * w
    head = 2 * w * w * 2 + 2 * 2 * t * w * w + 4 * t * w + 2 * 2 * w * h
    want = 2 * t * 588 * w + 27 * block + head
    assert roofline_siglip.tower_flops_per_image(spec) == want
    assert 6.6e11 < want < 6.8e11               # about 0.67 TFLOP an image
    assert roofline_siglip.k2_seconds(spec, 256) == pytest.approx(
        4 * 256 * t * t * w / roofline.BF16_FLOPS)   # bound by operations
    big = 256 * t * h * 6 + 4 * h
    small = 256 * h * 6 + 4 * h
    assert roofline_siglip.e1_gelu_seconds(spec, 256) == pytest.approx(
        (27 * big + small) / 28 / roofline.HBM_BYTES_PER_S)


class _Run:
    """What the kernel readers take from a run."""

    def __init__(self, events):
        self.index_kind = True
        self.cfg = {"image_tower": _load(
            tiny.BENCH, "configs", "siglip-so400m-384.json")["image_tower"]}
        self.traffic = {"batch": 256}
        self.trace = devtrace.DeviceTrace(0.0, 1.0)
        self.trace.t0_ns, self.trace.t1_ns = 0, 10 ** 10
        self.trace.events = events


def test_the_kernel_readers_take_only_their_instances():
    k2 = bench_run.load_module(os.path.join(
        tiny.BENCH, "metrics", "k2_roofline.index_kind.py"), "k2")
    e1 = bench_run.load_module(os.path.join(
        tiny.BENCH, "metrics", "e1_roofline.index_kind.py"), "e1")
    ms = 10 ** 6
    events = [
        ("void (anonymous namespace)::mha_mma_kernel<80, true>("
         "__nv_bfloat16 const*)", 0, 4 * ms),
        ("void (anonymous namespace)::mha_mma_kernel<64, true>("
         "__nv_bfloat16 const*)", 4 * ms, 5 * ms),
        ("void (anonymous namespace)::bias_act_kernel<3, true>("
         "float4 const*)", 5 * ms, 7 * ms),
        ("void (anonymous namespace)::bias_act_kernel<0, true>("
         "float4 const*)", 7 * ms, 8 * ms)]
    run = _Run(events)
    spec = run.cfg["image_tower"]
    assert k2.read(run) == pytest.approx(
        100 * roofline_siglip.k2_seconds(spec, 256) / 4e-3)
    assert e1.read(run) == pytest.approx(
        100 * roofline_siglip.e1_gelu_seconds(spec, 256) / 2e-3)
    assert k2.instance_80("_ZN12_GLOBAL__N_114mha_mma_kernelILi80ELb1EEEvPK")
    assert _Run([]).trace.seconds_of(k2.instance_80) == (0.0, 0)
    assert k2.read(_Run(events[1:2])) is None
    other = _Run(events)
    other.index_kind = False
    assert k2.read(other) is None and e1.read(other) is None


def test_the_map_heads_span_counts_under_the_towers_encode():
    """`towers.pool` (inside `towers.encode`) is in no group of
    benchmark/program_spans.py: idle inside it is the towers' idle, and
    the shares are those of the same trace without it."""
    from types import SimpleNamespace

    from mmrs_tpu_torch.utils.profiling import Span

    def span(name, a, b):
        return Span(name, a, b, 0, 0, 1, 0, 0)

    spans = [span("gallery.build", 900, 1900),
             span("towers.encode", 1100, 1400),
             span("gallery.flush", 1500, 1600)]
    got = []
    for extra in ([], [span("towers.pool", 1250, 1350)]):
        trace = devtrace.DeviceTrace(0.0, 1.0)
        trace.t0_ns, trace.t1_ns = 1000, 2000
        trace.events = [("op", 1000, 1200), ("op", 1700, 1800)]
        run = SimpleNamespace(traffic={"generator": "index"}, trace=trace,
                              program_spans=spans + extra,
                              program_spans_dropped=0)
        got.append(program_spans.idle_ns(run))
    assert got[0] == got[1] == {"towers": 200, "storage": 100, "loop": 300,
                                "outside": 100}
