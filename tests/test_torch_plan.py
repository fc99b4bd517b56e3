"""The port's capacity planner (mmrs_tpu_torch/plan.py, `mmrs-torch
plan`) against mmrs_tpu's (tests/test_plan.py).

The residency formulas and the ladder are the JAX package's: residency
and default cluster counts are equal, and so is the recommendation at the
same memory size with no latency target (fit decides it). The latency
constants are the H100's, so predicted times are the port's own: they are
checked for their shape (monotone in rows, faster rungs for fewer bytes),
not against JAX's. An out-of-memory error while the engine places its
gallery is raised again pointing at `mmrs-torch plan`.
"""

import numpy as np
import pytest
import torch

from mmrs_tpu import plan as J
from mmrs_tpu_torch import plan as T

torch.set_num_threads(2)

TEN_M, DIM = 10_000_000, 512


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.mark.parametrize("rows", [1_048_576, TEN_M, 100_000_000, 12_345])
@pytest.mark.parametrize("dim", [512, 768])
def test_residency_equals_jax(rows, dim):
    assert T.default_clusters(rows) == J.default_clusters(rows)
    for quant in T.QUANTS:
        assert T.row_bytes(dim, quant) == J.row_bytes(dim, quant)
        for shards in (1, 8):
            assert T.flat_resident_gb(rows, dim, quant, shards) == \
                J.flat_resident_gb(rows, dim, quant, shards)
        for kw in ({}, dict(clusters=4096, slots_frac=1.25,
                            spill_frac=0.079), dict(shards=4)):
            assert T.ivf_resident_gb(rows, dim, quant, **kw) == \
                J.ivf_resident_gb(rows, dim, quant, **kw)
    with pytest.raises(ValueError, match="unknown quant"):
        T.row_bytes(dim, "fp8")


@pytest.mark.parametrize("rows,chips,hbm", [
    (1_000_000, 1, 16.0), (TEN_M, 1, 16.0), (40_000_000, 1, 16.0),
    (40_000_000, 8, 16.0), (400_000_000, 1, 16.0), (TEN_M, 1, 80.0),
    (150_000_000, 1, 80.0), (400_000_000, 1, 80.0)])
def test_recommendation_equals_jax_without_a_target(rows, chips, hbm):
    t = T.plan(rows, DIM, chips=chips, hbm_gb=hbm, target_ms=0)
    j = J.plan(rows, DIM, chips=chips, hbm_gb=hbm, target_ms=0)
    key = (lambda r: None if r.recommended is None
           else (r.recommended.quant, r.recommended.index,
                 r.recommended.shards))
    assert key(t) == key(j)
    assert t.min_chips_exact_bf16 == j.min_chips_exact_bf16
    assert [(o.quant, o.index, o.fits, o.exact) for o in t.options] == \
        [(o.quant, o.index, o.fits, o.exact) for o in j.options]
    assert [o.resident_gb_per_chip for o in t.options] == \
        [o.resident_gb_per_chip for o in j.options]


def test_latency_model_shape():
    """The H100 constants drive JAX's formulas: flat time is bytes over
    the scan rate, so int8 / int4 are ~2x / ~4x faster than bf16 and 10x
    the rows is 10x the time; an IVF probe of few buckets beats the flat
    scan at 10M rows; a target recommends the fastest rung that meets
    it."""
    assert T.predict_flat_q1_ms(TEN_M, DIM) == pytest.approx(
        10 * T.predict_flat_q1_ms(TEN_M // 10, DIM))
    assert T.predict_flat_q1_ms(TEN_M, DIM, "int8") == pytest.approx(
        T.predict_flat_q1_ms(TEN_M, DIM) * (DIM + 4) / (2 * DIM))
    assert T.predict_ivf_q1_ms(TEN_M, DIM, nprobe=32) < \
        T.predict_flat_q1_ms(TEN_M, DIM)
    assert T.predict_ivf_q1_ms(TEN_M, DIM, nprobe=32) > T.IVF_OVERHEAD_MS
    r = T.plan(TEN_M, DIM, target_ms=T.predict_flat_q1_ms(TEN_M, DIM) / 2)
    assert r.recommended.index == "ivf" or r.recommended.quant != "bf16"
    assert r.recommended.predicted_q1_ms <= \
        T.predict_flat_q1_ms(TEN_M, DIM) / 2


def test_constants_are_the_cards():
    """Fitted on the H100 (80 GB card): no TPU constant remains."""
    assert T.HBM_GB_DEFAULT > 79.0
    assert T.EFFECTIVE_SCAN_GBPS != J.EFFECTIVE_SCAN_GBPS
    assert T.IVF_OVERHEAD_MS != J.IVF_OVERHEAD_MS


def test_render_and_hint_name_the_ports_flags():
    txt = T.plan(150_000_000, DIM, hbm_gb=80.0).render()
    assert "--gallery-quant" in txt or "--ann-nprobe" in txt
    assert "GB/chip" in txt and "mmrs-torch search" in txt
    # the sharded gallery is the port's too: the line names the flag, as
    # the JAX package's names `--gallery-shards N`
    assert T.plan(400_000_000, DIM, chips=8).render().splitlines()[-1] \
        .endswith("mmrs-torch search --gallery-shards 8")
    msg = T.oom_hint(123, 45)
    assert "mmrs-torch plan --rows 123 --dim 45" in msg
    assert "--gallery-quant" in msg and "--gallery-shards" in msg
    assert "A.12" not in msg


def test_cli_plan_matches_the_library(capsys):
    from mmrs_tpu_torch.cli.main import build_parser, main

    args = build_parser().parse_args(["plan", "--rows", "1000", "--dim",
                                      "64"])
    assert args.hbm_gb == T.HBM_GB_DEFAULT and args.nprobe == 32
    with pytest.raises(SystemExit) as e:
        main(["plan", "--rows", str(TEN_M), "--dim", str(DIM),
              "--hbm-gb", "16"])
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == \
        T.plan(TEN_M, DIM, hbm_gb=16.0).render()
    with pytest.raises(SystemExit) as e:    # nothing fits: exit 1
        main(["plan", "--rows", "400000000", "--dim", "512",
              "--hbm-gb", "16"])
    assert e.value.code == 1
    assert "NOTHING fits" in capsys.readouterr().out


def _index(n, d, seed):
    from mmrs_tpu_torch.index.gallery import GalleryIndex

    emb = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return GalleryIndex(embeddings=emb, paths=[f"p{i}" for i in range(n)],
                        classes=["c"] * n)


@pytest.mark.parametrize("err", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: out of memory")])
def test_engine_init_oom_references_plan(monkeypatch, err):
    """An out-of-memory error while the engine is built is raised again
    pointing the user at `mmrs-torch plan` (tests/test_plan.py's check)."""
    from mmrs_tpu_torch.search import engine as eng

    def boom(self, *a, **k):
        raise err

    monkeypatch.setattr(eng.SearchEngine, "_init", boom)
    with pytest.raises(RuntimeError,
                       match="mmrs-torch plan --rows 8 --dim 16") as e:
        eng.SearchEngine(_index(8, 16, 0))
    assert e.value.__cause__ is err


def test_engine_other_errors_pass_through(monkeypatch):
    from mmrs_tpu_torch.search import engine as eng

    with pytest.raises(ValueError, match="unknown quantize"):
        eng.SearchEngine(_index(8, 16, 0), quantize="int3")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_engine_still_constructs_and_queries(dtype):
    """The __init__ -> _init split keeps the engine working; the f32
    gallery (the lifecycle's calibration) holds the rows in f32."""
    from mmrs_tpu_torch.search.engine import SearchEngine

    idx = _index(32, 16, 1)
    e = SearchEngine(idx, device_dtype=dtype)
    assert e.gallery.dtype == dtype
    hits = e.query_vectors(idx.embeddings[[5]], top_k=3)
    assert hits[0][0].path == "p5"
