"""The port's SearchEngine over a mesh (mesh=) against mmrs_tpu's engine on
its 8-device CPU mesh, and against the port's one-device engine, on the
same seeded galleries (tests/test_engine_modes.py's and test_ivf.py's
cases).

Tolerances, and why:
  - hit scores (x100, the logit scale): 1e-3 against JAX's engine (f32
    sums in another order), equal to the port's one-device engine for
    the int8 / int4 rungs (exact dots) and within 1e-4 for f32 rows;
  - hit paths: equal wherever a score is more than the tolerance from its
    neighbours' (rows closer than that may swap);
  - similarities: f32 within 1e-6 of the one-device engine's, int8 / int4
    equal; sweep thresholds within 1e-3 and best F1 equal (1e-9).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.config import MeshConfig as JMeshConfig
from mmrs_tpu.config import SearchConfig as JSearch
from mmrs_tpu.index import ivf as J_ivf
from mmrs_tpu.index.gallery import GalleryIndex as JIndex
from mmrs_tpu.index.gallery import _write_manifest, _write_shard
from mmrs_tpu.parallel import make_mesh as j_make_mesh
from mmrs_tpu.search.engine import SearchEngine as JEngine
from mmrs_tpu_torch.config import MeshConfig, SearchConfig
from mmrs_tpu_torch.index import ivf as T_ivf
from mmrs_tpu_torch.index.gallery import GalleryIndex
from mmrs_tpu_torch.parallel import make_mesh
from mmrs_tpu_torch.parallel.ivf import ShardedIVF
from mmrs_tpu_torch.search.engine import SearchEngine

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _rows(n, d, seed):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _indexes(n=512, d=32, seed=0):
    emb = _rows(n, d, seed)
    paths = [f"img{i}.jpg" for i in range(n)]
    classes = [f"c{i % 4}" for i in range(n)]
    return GalleryIndex(emb, paths, classes), JIndex(emb, paths, classes)


def _meshes(s=8):
    return (make_mesh(MeshConfig(data_size=s), [CPU] * s),
            j_make_mesh(JMeshConfig(data_size=s), jax.devices()[:s]))


def _j_dtype(quant):
    """The JAX engine's device dtype for the port's: a quantized rung
    quantizes bf16 rows in the port whatever device_dtype says (the JAX
    package's chain at its default dtype)."""
    return jnp.bfloat16 if quant else jnp.float32


def _same_hits(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b) > 0
        ws = np.asarray([h.score for h in b])
        np.testing.assert_allclose([h.score for h in a], ws, atol=tol,
                                   rtol=0)
        gap = np.full(ws.shape, np.inf)
        d = np.abs(np.diff(ws))
        gap[1:], gap[:-1] = np.minimum(gap[1:], d), np.minimum(gap[:-1], d)
        for x, y, g in zip(a, b, gap):
            assert g <= tol or x.path == y.path


ENGINE_CASES = [("", 512, 8), ("", 1000, 8), ("", 1001, 3),
                ("int8", 1000, 8), ("int8", 513, 4),
                ("int4", 1000, 8), ("int4", 1001, 3)]


@pytest.mark.parametrize("quant,n,s", ENGINE_CASES)
def test_engine_mesh_matches_jax_and_one_device(quant, n, s):
    t_idx, j_idx = _indexes(n=n, seed=n)
    tm, jm = _meshes(s)
    sharded = SearchEngine(t_idx, SearchConfig(), mesh=tm, quantize=quant,
                           device_dtype=torch.float32)
    plain = SearchEngine(t_idx, SearchConfig(), quantize=quant,
                         device="cpu", device_dtype=torch.float32)
    j_eng = JEngine(j_idx, JSearch(), mesh=jm, device_dtype=_j_dtype(quant),
                    quantize=quant)
    assert sharded.device == CPU and len(sharded.gallery) == s
    rows = [7, n - 1, 300]
    q = t_idx.embeddings[rows]
    got = sharded.query_vectors(q, top_k=7)
    _same_hits(got, j_eng.query_vectors(jnp.asarray(q), top_k=7), 1e-3)
    one = plain.query_vectors(q, top_k=7)
    if quant:
        assert [[(h.path, h.score) for h in r] for r in got] == \
            [[(h.path, h.score) for h in r] for r in one]
    else:
        _same_hits(got, one, 1e-4)
    if quant != "int4":      # int4 keeps the row in its top 3 (COVERAGE)
        assert [r[0].path for r in got] == [f"img{i}.jpg" for i in rows]
    # k past the index: (-inf, -1) places are dropped, as one device
    tiny = SearchEngine(GalleryIndex(t_idx.embeddings[:5], t_idx.paths[:5],
                                     t_idx.classes[:5]), SearchConfig(),
                        mesh=tm, quantize=quant)
    assert len(tiny.query_vectors(q[:1], top_k=9)[0]) == 5


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_similarities_and_sweep_on_mesh(quant):
    t_idx, j_idx = _indexes(n=1001, seed=4)
    tm, jm = _meshes(8)
    labels = np.asarray([c == "c2" for c in t_idx.classes])
    proto = t_idx.embeddings[labels][:5].mean(0)
    proto /= np.linalg.norm(proto)
    sharded = SearchEngine(t_idx, SearchConfig(), mesh=tm, quantize=quant,
                           device_dtype=torch.float32)
    plain = SearchEngine(t_idx, SearchConfig(), quantize=quant,
                         device="cpu", device_dtype=torch.float32)
    j_eng = JEngine(j_idx, JSearch(), mesh=jm, device_dtype=_j_dtype(quant),
                    quantize=quant)
    a = sharded.device_similarities(proto[None])
    b = plain.device_similarities(proto[None])
    assert a.shape == (1, 1001)
    if quant:
        assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        a.numpy(), np.asarray(j_eng.device_similarities(
            jnp.asarray(proto)[None])), atol=1e-6)
    got = sharded.sweep_class(proto, labels)
    want = j_eng.sweep_class(jnp.asarray(proto), labels)
    one = plain.sweep_class(proto, labels)
    for ref in (want, one):
        assert got.best_threshold == pytest.approx(ref.best_threshold,
                                                   abs=1e-3)
        assert got.best_f1 == pytest.approx(ref.best_f1, abs=1e-9)


def _index_dir(path, g):
    os.makedirs(path)
    entry = _write_shard(str(path), 0, g, [(f"p{i}.jpg", "c")
                                           for i in range(len(g))])
    _write_manifest(str(path), [entry], g.shape[1])
    return str(path)


def _blobs(seed, n=512, d=64, n_blobs=8, sigma=0.15):
    rng = np.random.default_rng(seed)
    centers = _rows(n_blobs, d, seed + 1)
    x = centers[rng.integers(0, n_blobs, n)] + sigma * rng.standard_normal(
        (n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_engine_ivf_mesh_composes(quant):
    """SearchEngine(ann='ivf', mesh=) == the one-device IVF engine at the
    same explicit cap (tests/test_ivf.py::test_engine_ivf_mesh_composes):
    the port's own k-means from one seed, strips built straight on the
    mesh."""
    g = _blobs(33)
    idx = GalleryIndex(g, [f"p{i}.jpg" for i in range(512)], ["c"] * 512)
    cap = 512 if quant == "int4" else 64
    cfg = SearchConfig(ann="ivf", ann_clusters=8, ann_bucket_cap=cap,
                       ann_nprobe=3)
    tm, _ = _meshes(8)
    single = SearchEngine(idx, cfg, quantize=quant, device="cpu",
                          device_dtype=torch.float32)
    sharded = SearchEngine(idx, cfg, mesh=tm, quantize=quant,
                           device_dtype=torch.float32)
    assert isinstance(sharded.ivf, ShardedIVF)
    q = _rows(3, 64, 34)
    _same_hits(sharded.query_vectors(q, top_k=5),
               single.query_vectors(q, top_k=5), 1e-4)
    hits = sharded.query_vectors(g[[3]], top_k=3)
    assert hits[0][0].path == "p3.jpg"


@pytest.mark.parametrize("quant", ["", "int8"])
def test_engine_ivf_mesh_loads_the_jax_mesh_sidecar(tmp_path, monkeypatch,
                                                    quant):
    """JAX's mesh engine trains and saves the sidecar (its cap rounded to
    8 S); the port's mesh engine loads it into slot strips without
    training (load_ivf(mesh=)) and serves JAX's hits."""
    g = _blobs(35, n=600)
    q = _rows(4, 64, 36)
    d = _index_dir(tmp_path / "idx", g)
    tm, jm = _meshes(8)
    knobs = dict(ann="ivf", ann_clusters=8, ann_nprobe=3, ann_train_iters=2)
    j_eng = JEngine(JIndex.load(d), JSearch(**knobs), mesh=jm,
                    quantize=quant)
    want = j_eng.query_vectors(jnp.asarray(q), top_k=6)
    monkeypatch.setattr(T_ivf, "train_centroids", _boom)
    t_eng = SearchEngine(GalleryIndex.load(d), SearchConfig(**knobs),
                         mesh=tm, quantize=quant)
    assert isinstance(t_eng.ivf, ShardedIVF)
    assert t_eng.ivf.bucket_cap == T_ivf.sidecar_meta(
        os.path.join(d, "ivf"))["bucket_cap"]
    _same_hits(t_eng.query_vectors(q, top_k=6), want, 1e-2)


def _boom(*a, **k):
    raise AssertionError("the sidecar is there: this must not run")


def test_engine_ivf_mesh_target_recall_tunes_on_the_mesh(tmp_path):
    g = _blobs(37, n=600)
    d = _index_dir(tmp_path / "idx", g)
    tm, _ = _meshes(4)
    cfg = SearchConfig(ann="ivf", ann_clusters=8, ann_target_recall=0.9)
    eng = SearchEngine(GalleryIndex.load(d), cfg, mesh=tm)
    tuned = T_ivf.sidecar_meta(os.path.join(d, "ivf"))["tuned"]
    assert eng.config.ann_nprobe == tuned["nprobe"] and \
        tuned["recall"] >= 0.9
    # the saved sidecar loads on one device too, with the same hits
    one = SearchEngine(GalleryIndex.load(d), dataclasses.replace(
        cfg, ann_target_recall=0.0, ann_nprobe=tuned["nprobe"]),
        device="cpu")
    q = _rows(3, 64, 38)
    _same_hits(eng.query_vectors(q, top_k=5), one.query_vectors(q, top_k=5),
               1e-4)


def test_healthz_reports_the_data_axis():
    from mmrs_tpu import serve as j_serve
    from mmrs_tpu_torch.serve import SearchService

    t_idx, j_idx = _indexes(n=100)
    tm, jm = _meshes(4)
    got = SearchService(SearchEngine(t_idx, SearchConfig(), mesh=tm), None)
    want = j_serve.SearchService(JEngine(j_idx, JSearch(), mesh=jm), None)
    try:
        assert got.healthz()["gallery_shards"] == 4
        assert got.healthz() == want.healthz()
    finally:
        got.close()
        want.close()


def test_ivf_sidecar_written_by_a_mesh_build_loads_anywhere(tmp_path):
    """save_ivf of a ShardedIVF stores the gathered global slot maps."""
    g = _blobs(39)
    tm, _ = _meshes(4)
    b = T_ivf.build_ivf(g, n_clusters=8, iters=2, device=CPU, mesh=tm,
                        dtype=torch.float32)
    T_ivf.save_ivf(str(tmp_path / "s"), b, embeddings=g)
    one = T_ivf.load_ivf(str(tmp_path / "s"), g, dtype=torch.float32,
                         device=CPU)
    assert torch.equal(one.bucket_ids, b.bucket_ids)
    assert torch.equal(one.spill_ids, b.spill_ids)
    q = torch.from_numpy(_rows(3, 64, 40))
    from mmrs_tpu_torch.parallel.ivf import sharded_ivf_topk

    v1, i1 = T_ivf.ivf_topk(q, one, k=5, nprobe=8)
    v2, i2 = sharded_ivf_topk(q, b, k=5, nprobe=8, mesh=tm)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), atol=1e-6)
    assert J_ivf.sidecar_meta(str(tmp_path / "s"))["bucket_cap"] == \
        b.bucket_cap
