"""The port's IVF serving path against mmrs_tpu's: SearchEngine(ann="ivf")
with its sidecar cache, the prototype knobs, and the CLI's `--ann-*`
flags, `ann build`, `index update` and `index compact`.

Both packages read the same on-disk index and the same sidecar files, so
an engine of one package can load what the other trained (with the other's
`train_centroids` patched to raise) and must serve the same hits.

Tolerances, and why:
  - hit scores (x100, the logit scale): 1e-3, i.e. 1e-5 in cosine (f32
    sums in another order; a row's L2 norm may differ in the last bit);
  - hit paths: equal wherever a JAX score is more than 1e-3 from its
    neighbours' (rows closer than that may swap);
  - CLI hit scores: 2e-2, as tests/test_torch_cli.py (the two towers'
    embeddings differ in the bf16 / f32 round-off of a whole tower).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mmrs_tpu.cli.main import main as j_main
from mmrs_tpu.config import SearchConfig as JConfig
from mmrs_tpu.index import ivf as J
from mmrs_tpu.index.gallery import GalleryIndex as JIndex
from mmrs_tpu.index.gallery import _write_manifest, _write_shard
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
from mmrs_tpu.search.engine import SearchEngine as JEngine
from mmrs_tpu_torch.cli.main import main as t_main
from mmrs_tpu_torch.config import SearchConfig as TConfig
from mmrs_tpu_torch.index import ivf as T
from mmrs_tpu_torch.index.gallery import GalleryIndex as TIndex
from mmrs_tpu_torch.search.engine import SearchEngine as TEngine
from mmrs_tpu_torch.search.prototypes import build_prototype

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _blobs(rng, n, d, n_blobs, sigma=0.15):
    """Clustered unit vectors (tests/test_ivf.py's data)."""
    centers = _normed(rng, n_blobs, d)
    which = rng.integers(0, n_blobs, n)
    x = centers[which] + sigma * rng.standard_normal((n, d)).astype(
        np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _index_dir(path, g, prefix="p"):
    """An on-disk index of rows `g` (one shard), as both packages store it."""
    os.makedirs(path)
    entry = _write_shard(str(path), 0, g, [(f"{prefix}{i}.jpg", "c")
                                           for i in range(len(g))])
    _write_manifest(str(path), [entry], g.shape[1])
    return str(path)


def _append_shard(d, g, prefix):
    with open(os.path.join(d, "manifest.json"), encoding="utf-8") as f:
        shards = json.load(f)["shards"]
    entry = _write_shard(d, len(shards), g, [(f"{prefix}{i}.jpg", "c")
                                             for i in range(len(g))])
    _write_manifest(d, shards + [entry], g.shape[1])


def _boom(*a, **k):
    raise AssertionError("the sidecar is there: this must not run")


def _same_hits(t_hits, j_hits, tol=1e-3):
    """Scores within `tol`; paths equal where the JAX scores are separated."""
    assert len(t_hits) == len(j_hits)
    for th, jh in zip(t_hits, j_hits):
        assert len(th) == len(jh) > 0
        js = np.asarray([h.score for h in jh])
        np.testing.assert_allclose([h.score for h in th], js, atol=tol, rtol=0)
        gap = np.full(js.shape, np.inf)
        d = np.abs(np.diff(js))
        gap[1:], gap[:-1] = np.minimum(gap[1:], d), np.minimum(gap[:-1], d)
        for a, b, g in zip(th, jh, gap):
            assert g <= tol or a.path == b.path
        assert [h.rank for h in th] == list(range(len(th)))


# -- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_engines_load_each_others_sidecars_and_serve_the_same_hits(
        tmp_path, monkeypatch, quant):
    rng = np.random.default_rng(1)
    g = _blobs(rng, 600, 64, 8)
    q, shots = _blobs(rng, 4, 64, 8), g[:8]
    knobs = dict(ann="ivf", ann_clusters=8, ann_nprobe=3, ann_train_iters=2)
    dj = _index_dir(tmp_path / "j", g)
    dt = _index_dir(tmp_path / "t", g)

    je = JEngine(JIndex.load(dj), JConfig(**knobs), quantize=quant)
    monkeypatch.setattr(T, "train_centroids", _boom)
    te = TEngine(TIndex.load(dj), TConfig(**knobs), quantize=quant,
                 device=CPU)
    monkeypatch.undo()
    assert te.ivf.quant == quant and te.ivf.n_total == 600
    assert te.gallery is None
    _same_hits(te.query_vectors(q, top_k=10),
               je.query_vectors(jnp.asarray(q), top_k=10))
    for strategy in ("mean", "cluster", "robust_mean"):
        _same_hits(te.query_prototype(shots, strategy=strategy, top_k=5),
                   je.query_prototype(jnp.asarray(shots), strategy=strategy,
                                      top_k=5))

    te2 = TEngine(TIndex.load(dt), TConfig(**knobs), quantize=quant,
                  device=CPU)
    monkeypatch.setattr(J, "train_centroids", _boom)
    je2 = JEngine(JIndex.load(dt), JConfig(**knobs), quantize=quant)
    _same_hits(te2.query_vectors(q, top_k=10),
               je2.query_vectors(jnp.asarray(q), top_k=10))


def test_engine_target_recall_growth_knobs_and_fingerprint(tmp_path,
                                                           monkeypatch):
    rng = np.random.default_rng(2)
    g = _blobs(rng, 400, 64, 8)
    d = _index_dir(tmp_path / "idx", g)
    sidecar = os.path.join(d, "ivf")
    tuned_cfg = TConfig(ann="ivf", ann_clusters=8, ann_train_iters=2,
                        ann_target_recall=0.9)
    e1 = TEngine(TIndex.load(d), tuned_cfg, device=CPU)
    meta = T.sidecar_meta(sidecar)
    assert meta["tuned"]["target"] == 0.9 and meta["tuned"]["k"] == 10
    assert meta["tuned"]["nprobe"] == e1.config.ann_nprobe > 0
    assert (meta["cover"], meta["slots_frac"]) == (0.98, 1.3)

    # a restart loads the sidecar and its tuned nprobe: no k-means, no
    # recall measurement
    monkeypatch.setattr(T, "train_centroids", _boom)
    monkeypatch.setattr(T, "tune_nprobe", _boom)
    e2 = TEngine(TIndex.load(d), tuned_cfg, device=CPU)
    assert e2.config.ann_nprobe == e1.config.ann_nprobe
    assert e2.query_vectors(g[[5]], top_k=3)[0][0].path == "p5.jpg"

    # growth: an appended shard extends the sidecar, no retraining, and
    # the new rows are served
    g2 = _blobs(rng, 60, 64, 8)
    _append_shard(d, g2, "q")
    full = TConfig(ann="ivf", ann_clusters=8, ann_nprobe=8,
                   ann_train_iters=2)
    e3 = TEngine(TIndex.load(d), full, device=CPU)
    assert e3.ivf.n_total == 460 and T.sidecar_meta(sidecar)["n_total"] == 460
    assert "tuned" not in T.sidecar_meta(sidecar)
    assert e3.query_vectors(g2[[7]], top_k=1)[0][0].path == "q7.jpg"
    monkeypatch.undo()

    # a changed knob rebuilds and saves
    e4 = TEngine(TIndex.load(d), TConfig(ann="ivf", ann_clusters=4,
                                         ann_nprobe=4, ann_train_iters=2),
                 device=CPU)
    assert e4.ivf.n_clusters == 4
    assert T.sidecar_meta(sidecar)["n_clusters"] == 4

    # changed rows at the same shape: the fingerprint refuses the sidecar
    d2 = str(tmp_path / "idx2")
    shutil.copytree(d, d2)
    g_rev = np.ascontiguousarray(np.concatenate([g, g2])[::-1])
    entry = _write_shard(d2, 0, g_rev, [(f"r{i}.jpg", "c")
                                        for i in range(460)])
    _write_manifest(d2, [entry], 64)
    e5 = TEngine(TIndex.load(d2), TConfig(ann="ivf", ann_clusters=4,
                                          ann_nprobe=4, ann_train_iters=2),
                 device=CPU)
    assert e5.query_vectors(g_rev[[7]], top_k=1)[0][0].path == "r7.jpg"

    with pytest.raises(ValueError, match="not both"):
        TEngine(TIndex.load(d), TConfig(ann="ivf", ann_nprobe=2,
                                        ann_target_recall=0.9), device=CPU)
    with pytest.raises(ValueError, match="unknown ann"):
        TEngine(TIndex.load(d), TConfig(ann="hnsw"), device=CPU)
    with pytest.raises(RuntimeError, match="flat gallery"):
        e4.device_similarities(g[:1])


def test_engine_never_serves_the_sentinel_hits():
    """k past the live slots of the probed buckets: the -1 ids are dropped,
    never served as paths[-1]."""
    rng = np.random.default_rng(22)
    g = _normed(rng, 64, 32)
    idx = TIndex(g, [f"p{i}.jpg" for i in range(64)], ["c"] * 64)
    eng = TEngine(idx, TConfig(ann="ivf", ann_clusters=8, ann_bucket_cap=8,
                               ann_nprobe=1), device=CPU)
    for hits in eng.query_vectors(_normed(rng, 2, 32), top_k=32):
        assert 0 < len(hits) < 32
        assert [h.rank for h in hits] == list(range(len(hits)))
        assert all(h.score > -1e6 for h in hits)


def test_engine_prototype_passes_the_config_knobs():
    """query_prototype hands cluster_k, cluster_balance_ratio and
    outlier_percentile to build_prototype, as mmrs_tpu's engine does. The
    knobs below change every strategy's prototype, so an engine that
    dropped them would serve other hits."""
    rng = np.random.default_rng(3)
    g = _blobs(rng, 300, 48, 6)
    centers = _normed(rng, 3, 48)
    shots = np.concatenate([centers[0] + 0.2 * rng.standard_normal((6, 48)),
                            centers[1] + 0.2 * rng.standard_normal((2, 48)),
                            centers[2] + 0.2 * rng.standard_normal((2, 48))])
    shots = (shots / np.linalg.norm(shots, axis=1, keepdims=True)).astype(
        np.float32)
    knobs = dict(cluster_k=3, cluster_balance_ratio=0.6,
                 outlier_percentile=60.0)
    paths, classes = [f"p{i}.jpg" for i in range(300)], ["c"] * 300
    te = TEngine(TIndex(g, paths, classes), TConfig(**knobs), device=CPU)
    je = JEngine(JIndex(g, paths, classes), JConfig(**knobs))
    for strategy in ("cluster", "cluster_scan", "robust_mean"):
        got = te.query_prototype(shots, strategy=strategy, top_k=8)
        _same_hits(got, je.query_prototype(jnp.asarray(shots),
                                           strategy=strategy, top_k=8))
        with_knobs = build_prototype(torch.from_numpy(shots), strategy,
                                     cluster_k=3, balance_ratio=0.6,
                                     outlier_percentile=60.0)
        default = build_prototype(torch.from_numpy(shots), strategy)
        assert float((with_knobs - default).abs().max()) > 1e-3, strategy
        want = te.query_vectors(with_knobs[None, :], top_k=8)
        assert [(h.path, h.score) for h in got[0]] == \
            [(h.path, h.score) for h in want[0]]


# -- the CLI -----------------------------------------------------------------

def _run(main, argv, capsys, code=0):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    out = capsys.readouterr().out
    assert exit_info.value.code == code, out
    return out.strip().splitlines()


def test_cli_ann_build_matches_jax_and_refuses_flag_clashes(tmp_path, capsys,
                                                            monkeypatch):
    rng = np.random.default_rng(90)
    g = _blobs(rng, 300, 64, 8)
    dj = _index_dir(tmp_path / "j", g)
    argv = ["ann", "build", "--clusters", "8", "--target-recall", "0.9"]
    j_out = json.loads(_run(j_main, argv + ["--index", dj], capsys)[-1])
    # the port on a copy of that index loads JAX's sidecar and its tuning
    dt = str(tmp_path / "t")
    shutil.copytree(dj, dt)
    monkeypatch.setattr(T, "train_centroids", _boom)
    monkeypatch.setattr(T, "tune_nprobe", _boom)
    t_out = json.loads(_run(t_main, argv + ["--index", dt], capsys)[-1])
    monkeypatch.undo()
    assert set(t_out) == set(j_out)
    for key in ("rows", "clusters", "bucket_cap", "spill_rows", "spill_frac",
                "quant", "sidecar", "tuned_nprobe"):
        assert t_out[key] == j_out[key], key

    # a fresh int4 build: the JAX package's keys, cap rounded to 128
    d4 = _index_dir(tmp_path / "t4", g)
    t4 = json.loads(_run(t_main, ["ann", "build", "--index", d4,
                                  "--clusters", "4", "--gallery-quant",
                                  "int4"], capsys)[-1])
    assert set(t4) == set(j_out) - {"tuned_nprobe"}
    assert t4["quant"] == "int4" and t4["bucket_cap"] % 128 == 0
    assert T.sidecar_meta(os.path.join(d4, "ivf"))["quant"] == "int4"

    for main in (j_main, t_main):
        _run(main, ["search", "--index", dt, "--image", "x.jpg",
                    "--ann-nprobe", "4", "--ann-target-recall", "0.9"],
             capsys, code=2)
        _run(main, ["calibrate", "--index", dt, "--positive-class", "c",
                    "--ann-nprobe", "4"], capsys, code=2)


def _images(root, cls, color, n, rng):
    (root / cls).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        arr = np.zeros((40, 40, 3), np.uint8) + np.uint8(color)
        arr = np.clip(arr.astype(int) + rng.integers(0, 60, arr.shape),
                      0, 255).astype(np.uint8)
        Image.fromarray(arr).save(root / cls / f"{cls}{i}.jpg")


def _search_lines(main, index, query, cfg, capsys):
    return [line.split("\t") for line in _run(
        main, ["search", "--index", index, "--image", query, "-k", "3",
               "--ann-clusters", "2", "--ann-nprobe", "2", "--config", cfg],
        capsys)]


def _same_lines(t_rows, j_rows):
    assert len(t_rows) == len(j_rows) > 0
    for t, j in zip(t_rows, j_rows):
        assert len(t) == 5 and t[:2] == j[:2] and t[3:] == j[3:]
        assert abs(float(t[2]) - float(j[2])) <= 2e-2


def test_cli_search_ann_index_update_and_compact_match_jax(tmp_path, capsys,
                                                           monkeypatch):
    """nprobe == clusters: the IVF hits are the flat scan's, so both CLIs
    print the same hits through build, update (the port's sidecar extends
    without retraining) and compact (the sidecar shrinks)."""
    rng = np.random.default_rng(0)
    root = tmp_path / "tree"
    _images(root, "red", (255, 0, 0), 3, rng)
    _images(root, "blue", (0, 0, 255), 3, rng)
    ckpt = str(tmp_path / "w.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(1), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), ckpt)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(f"model:\n  image_tower: vit_tiny\n  dtype: float32\n"
                   f"  checkpoint_path: {ckpt}\n")
    cfg = str(cfg)
    query = str(root / "red" / "red1.jpg")
    idx = {name: str(tmp_path / f"idx_{name}") for name in ("j", "t")}
    mains = {"j": j_main, "t": t_main}
    for name, main in mains.items():
        _run(main, ["index", "build", "--root", str(root), "--out",
                    idx[name], "--config", cfg, "--workers", "2"], capsys)
    rows = {n: _search_lines(m, idx[n], query, cfg, capsys)
            for n, m in mains.items()}
    _same_lines(rows["t"], rows["j"])
    sidecar = os.path.join(idx["t"], "ivf")
    assert T.sidecar_meta(sidecar)["n_total"] == 6

    _images(root, "green", (0, 255, 0), 3, rng)
    for name, main in mains.items():
        assert _run(main, ["index", "update", "--root", str(root), "--index",
                           idx[name], "--config", cfg, "--workers", "2"],
                    capsys)[-1] == "index now has 9 rows"
    monkeypatch.setattr(T, "train_centroids", _boom)
    green = str(root / "green" / "green0.jpg")
    rows = {n: _search_lines(m, idx[n], green, cfg, capsys)
            for n, m in mains.items()}
    _same_lines(rows["t"], rows["j"])
    assert rows["t"][0][4].endswith("green0.jpg")
    assert T.sidecar_meta(sidecar)["n_total"] == 9

    os.remove(root / "red" / "red0.jpg")
    for name, main in mains.items():
        assert _run(main, ["index", "compact", "--index", idx[name],
                           "--drop-class", "blue"], capsys)[-1] == \
            "index now has 5 rows"
    assert T.sidecar_meta(sidecar)["n_total"] == 5
    rows = {n: _search_lines(m, idx[n], query, cfg, capsys)
            for n, m in mains.items()}
    _same_lines(rows["t"], rows["j"])
    assert all("blue" not in r[3] for r in rows["t"])
