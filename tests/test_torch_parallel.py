"""The port's data axis (mmrs_tpu_torch/parallel/) against mmrs_tpu's, on
the same seeded numpy inputs: the JAX functions on tests/conftest.py's
8-device CPU mesh (or its first S devices), the port's on a CPU mesh of S
entries.

Tolerances, and why:
  - sharded top-k over f32 rows: ids equal to JAX's sharded output and to
    the port's one-device top-k; values within 1e-6 (f32 sums of the same
    products in another order);
  - int8 / int4 galleries: ids and values bit-equal (exact integer dots,
    the same f32 epilogue in both packages);
  - similarities: f32 within 1e-6, int8 / int4 bit-equal;
  - IVF: int4 values bit-equal to the port's one-device ivf_topk (exact
    dots, one epilogue) and within 1e-6 of JAX's sharded ones (XLA's CPU
    build of the same epilogue rounds 1 ulp apart; JAX's sharded and
    one-device values are equal to each other); f32 and int8 buckets
    (scored against the unquantized query in f32 sums, whose order
    follows the probed matrix's shape) within 1e-6 of the one-device
    values and within 1e-5 of JAX's (K7's plain version against JAX's
    probe, tests/test_torch_ivf.py); ids equal where neighbouring scores
    are more than 1e-6 apart;
  - the dedup ring: every element equal;
  - the sharded encoder: 1e-4, the JAX test's own tolerance
    (tests/test_parallel.py::test_sharded_encoder_matches_single_device),
    against the one-device encode and against JAX's sharded encoder.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.config import MeshConfig as JMeshConfig
from mmrs_tpu.index import ivf as J_ivf
from mmrs_tpu.ops.allpairs import first_match as j_first_match
from mmrs_tpu.parallel import dedup as j_dedup
from mmrs_tpu.parallel import embed as j_embed
from mmrs_tpu.parallel import ivf as j_pivf
from mmrs_tpu.parallel import mesh as j_mesh
from mmrs_tpu.parallel import quant4 as j_q4
from mmrs_tpu.parallel import topk as j_topk
from mmrs_tpu_torch.config import MeshConfig
from mmrs_tpu_torch.index import ivf as T_ivf
from mmrs_tpu_torch.ops import quant as t_quant
from mmrs_tpu_torch.ops import quant4 as t_quant4
from mmrs_tpu_torch.ops.allpairs import first_match
from mmrs_tpu_torch.ops.normalize import l2_normalize
from mmrs_tpu_torch.ops.topk import cosine_topk, sorted_topk
from mmrs_tpu_torch.parallel import dedup, embed, mesh, quant4, topk
from mmrs_tpu_torch.parallel import ivf as pivf

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


def _meshes(s):
    """(JAX mesh over the first s CPU devices, the port's s-entry mesh)."""
    jm = j_mesh.make_mesh(JMeshConfig(data_size=s), jax.devices()[:s])
    tm = mesh.make_mesh(MeshConfig(data_size=s), [CPU] * s)
    return jm, tm


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- the mesh ---------------------------------------------------------------

def test_mesh_shape_matches_jax():
    assert len(jax.devices()) == 8
    for cfg in (dict(), dict(model_size=2), dict(data_size=4, model_size=2)):
        jm = j_mesh.make_mesh(JMeshConfig(**cfg))
        tm = mesh.make_mesh(MeshConfig(**cfg), [CPU] * 8)
        assert tm.shape == dict(jm.shape)
        assert mesh.num_shards(tm) == j_mesh.num_shards(jm)
    with pytest.raises(ValueError, match="mesh 3x1 != 8 devices"):
        mesh.make_mesh(MeshConfig(data_size=3), [CPU] * 8)


def test_local_devices_asks_for_the_cpu_and_never_falls_back(monkeypatch):
    assert mesh.local_devices(3) == [CPU] * 3
    assert mesh.local_devices() == [CPU]
    assert mesh.make_mesh(MeshConfig(data_size=4)).shape == {"data": 4,
                                                             "model": 1}
    monkeypatch.delenv("MMRS_TORCH_DEVICE")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="MMRS_TORCH_DEVICE=cpu"):
            mesh.local_devices(2)
    assert mesh.local_devices(2, device="cpu") == [CPU] * 2


def test_shard_rows_and_replicate():
    _, tm = _meshes(4)
    x = torch.arange(24.0).reshape(8, 3)
    blocks = mesh.shard_rows(x, tm)
    assert [b.shape for b in blocks] == [(2, 3)] * 4
    assert torch.equal(torch.cat(blocks), x)
    assert blocks[1].data_ptr() == x[2:].data_ptr()       # views, one device
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_rows(x[:7], tm)
    copies = mesh.replicate(x, tm)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)


# -- flat top-k ----------------------------------------------------------------

TOPK_CASES = [   # (rows, dim, queries, k, shards)
    (4096, 64, 5, 10, 8),
    (1000, 32, 3, 10, 8),      # ragged over 8
    (41, 16, 2, 10, 8),        # k past the rows a shard (6)
    (1000, 64, 4, 7, 3),       # ragged over 3
    (997, 64, 4, 10, 2),
    (1003, 64, 4, 5, 4),
]


@pytest.mark.parametrize("n,d,nq,k,s", TOPK_CASES)
def test_sharded_topk_matches_jax_and_one_device(n, d, nq, k, s):
    rng = np.random.default_rng(n + s)
    g = _normed(rng, n, d)
    q = _normed(rng, nq, d)
    g[n - 3] = q[0]                       # an exact hit in the last shard
    jm, tm = _meshes(s)
    jv, ji = j_topk.sharded_cosine_topk(
        jnp.asarray(q), j_topk.place_gallery(jnp.asarray(g), jm), k, jm,
        impl="xla", n_valid=n)
    placed = topk.place_gallery(_t(g), tm)
    assert len(placed) == s and placed[0].shape[0] == -(-n // s)
    tv, ti = topk.sharded_cosine_topk(_t(q), placed, k, tm, n_valid=n)
    rv, ri = cosine_topk(_t(q), _t(g), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), ri.numpy())
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), rv.numpy(), atol=1e-6)
    assert int(ti[0, 0]) == n - 3
    # an unplaced ragged gallery pads inside
    tv2, ti2 = topk.sharded_cosine_topk(_t(q), _t(g), k, tm)
    np.testing.assert_array_equal(ti2.numpy(), ri.numpy())


def test_sharded_topk_ties_keep_the_lower_shard():
    """Equal scores in several shards: the merge keeps JAX's order (lower
    shard first, then the earlier place), which is also the one-device
    order (lower row first)."""
    rng = np.random.default_rng(9)
    g = _normed(rng, 64, 16)
    for r in (50, 9, 33, 20):
        g[r] = g[5]
    jm, tm = _meshes(4)
    jv, ji = j_topk.sharded_cosine_topk(jnp.asarray(g[[5]]), jnp.asarray(g),
                                        6, jm, impl="xla")
    tv, ti = topk.sharded_cosine_topk(_t(g[[5]]), _t(g), 6, tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0, :5].tolist() == [5, 9, 20, 33, 50]


@pytest.mark.parametrize("n,s", [(1000, 8), (1000, 3), (41, 8)])
def test_sharded_quantized_topk_bit_equal(n, s):
    rng = np.random.default_rng(6 + n)
    g = _normed(rng, n, 32)
    q = _normed(rng, 4, 32)
    k = 10
    jm, tm = _meshes(s)
    jq, js = j_topk.place_gallery_quantized(jnp.asarray(g), jm)
    jv, ji = j_topk.sharded_cosine_topk_quantized(
        jnp.asarray(q), jq, js, k, jm, impl="xla", n_valid=n)
    tq, ts = topk.place_gallery_quantized(_t(g), tm)
    tv, ti = topk.sharded_cosine_topk_quantized(_t(q), tq, ts, k, tm,
                                                n_valid=n)
    rv, ri = t_quant.cosine_topk_quantized(_t(q), *t_quant.quantize_rows(
        _t(g)), k)
    for want_v, want_i in ((np.asarray(jv), np.asarray(ji)),
                           (rv.numpy(), ri.numpy())):
        np.testing.assert_array_equal(ti.numpy(), want_i)
        np.testing.assert_array_equal(tv.numpy(), want_v)


@pytest.mark.parametrize("n,s", [(1000, 8), (1001, 3), (41, 8)])
def test_sharded_int4_topk_bit_equal(n, s):
    rng = np.random.default_rng(11 + n)
    g = _normed(rng, n, 64)
    q = _normed(rng, 4, 64)
    g[n - 1] = q[1]
    k = 10
    jm, tm = _meshes(s)
    jw, js = j_q4.place_gallery_int4(jnp.asarray(g), jm)
    jv, ji = j_q4.sharded_cosine_topk_int4(jnp.asarray(q), jw, js, k, jm,
                                           n_valid=n)
    tw, ts = quant4.place_gallery_int4(_t(g), tm)
    # padding rows: zero float rows, all-zero codes, score exactly 0.0
    if n % s:
        lo, hi = t_quant4.planes(tw[-1][-1:])
        assert int(lo.int().sum()) == 8 * 32 and int(hi.abs().sum()) == 0
    tv, ti = quant4.sharded_cosine_topk_int4(_t(q), tw, ts, k, tm,
                                             n_valid=n)
    rv, ri = t_quant4.cosine_topk_int4(
        _t(q), *t_quant4.quantize_rows_int4(_t(g)), k)
    for want_v, want_i in ((np.asarray(jv), np.asarray(ji)),
                           (rv.numpy(), ri.numpy())):
        np.testing.assert_array_equal(ti.numpy(), want_i)
        np.testing.assert_array_equal(tv.numpy(), want_v)
    assert int(ti[1, 0]) == n - 1
    assert quant4.place_gallery_int4(_t(g), None)[0].shape == (n, 32)


def test_sharded_similarities_match():
    rng = np.random.default_rng(12)
    n, s = 1001, 8
    g = _normed(rng, n, 64)
    q = _normed(rng, 3, 64)
    jm, tm = _meshes(s)
    one = _t(q) @ _t(g).T
    tf = topk.sharded_similarities(_t(q), _t(g), tm)
    jf = np.asarray(j_topk.sharded_similarities(
        jnp.asarray(q), j_topk.place_gallery(jnp.asarray(g), jm), jm))
    assert tf.shape == (3, topk.padded_rows(n, s))
    np.testing.assert_allclose(tf[:, :n].numpy(), one.numpy(), atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-6)
    # int8: exact dots, the single-device epilogue
    qq, qs = t_quant.quantize_rows(_t(q))
    tq, ts = topk.place_gallery_quantized(_t(g), tm)
    t8 = topk.sharded_similarities_quantized(qq, qs, tq, ts, tm)
    gq, gs = t_quant.quantize_rows(_t(g))
    np.testing.assert_array_equal(t8[:, :n].numpy(),
                                  t_quant.scores_q8(qq, qs, gq, gs).numpy())
    jq, js = j_topk.place_gallery_quantized(jnp.asarray(g), jm)
    from mmrs_tpu.ops.quant import quantize_rows as j_qrows

    jqq, jqs = j_qrows(jnp.asarray(q))
    np.testing.assert_array_equal(
        t8.numpy(), np.asarray(j_topk.sharded_similarities_quantized(
            jqq, jqs, jq, js, jm)))
    # int4
    tw, tws = quant4.place_gallery_int4(_t(g), tm)
    t4 = quant4.sharded_similarities_int4(_t(q), tw, tws, tm)
    np.testing.assert_array_equal(
        t4[:, :n].numpy(), t_quant4.similarities_int4(
            _t(q), *t_quant4.quantize_rows_int4(_t(g))).numpy())
    jw, jws = j_q4.place_gallery_int4(jnp.asarray(g), jm)
    np.testing.assert_array_equal(
        t4[:, :n].numpy(),
        np.asarray(j_q4.sharded_similarities_int4(jnp.asarray(q), jw, jws,
                                                  jm))[:, :n])


# -- the dedup ring -------------------------------------------------------------

DEDUP_CASES = [  # (rows, dim, shards, intra)
    (512, 32, 8, True), (1000, 16, 8, True), (1000, 16, 3, True),
    (256, 16, 8, False), (301, 16, 4, False), (7, 8, 8, True)]


@pytest.mark.parametrize("n,d,s,intra", DEDUP_CASES)
def test_sharded_first_match_matches_jax_and_one_device(n, d, s, intra):
    rng = np.random.default_rng(n + d)
    x = _normed(rng, n, d)
    for dup, src in ((min(70, n - 1), 3 % n), (min(130, n - 1), 3 % n),
                     (n - 1, n // 2), (n - 2, 0)):
        if dup != src:
            x[dup] = x[src]
    jm, tm = _meshes(s)
    want = np.asarray(j_dedup.sharded_first_match(
        jnp.asarray(x), tau=0.999, mesh=jm, intra=intra, impl="xla"))
    one = first_match(_t(x), _t(x), 0.999, intra=intra).numpy()
    got = dedup.sharded_first_match(_t(x), 0.999, tm, intra=intra)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), one)
    ref = np.asarray(j_first_match(jnp.asarray(x), jnp.asarray(x), 0.999,
                                   intra=intra, impl="xla"))
    np.testing.assert_array_equal(got.numpy(), ref)
    if not intra:
        assert (got.numpy() >= 0).all()


def test_sharded_first_match_takes_placed_blocks():
    rng = np.random.default_rng(3)
    x = _normed(rng, 256, 16)
    x[200] = x[10]
    _, tm = _meshes(8)
    got = dedup.sharded_first_match(topk.place_gallery(_t(x), tm), 0.999,
                                    tm)
    assert got[200] == 10 and (got[:200] == -1).all()


# -- the sharded encoder ----------------------------------------------------------

def test_sharded_encoder_matches_jax_and_one_device():
    """The JAX test's linear encoder, ragged batch (10 over 8)."""
    w = np.random.default_rng(0).normal(size=(3 * 4 * 4, 16)).astype(
        np.float32)
    jm, tm = _meshes(8)

    def j_fn(params, images_u8):
        x = images_u8.astype(jnp.float32).reshape(images_u8.shape[0], -1)
        return x @ params

    def t_fn(params, images_u8):
        return images_u8.float().reshape(images_u8.shape[0], -1) @ params

    pixels = np.random.default_rng(1).integers(0, 255, (10, 4, 4, 3),
                                               dtype=np.uint8)
    want = j_embed.make_sharded_encoder(j_fn, jnp.asarray(w), jm, 16)(pixels)
    got = embed.make_sharded_encoder(t_fn, _t(w), tm, 16)(pixels)
    ref = pixels.astype(np.float32).reshape(10, -1) @ w
    assert got.shape == (10, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    with pytest.raises(ValueError, match="not divisible by data axis 8"):
        embed.make_sharded_encoder(t_fn, _t(w), tm, 12)


def test_sharded_vit_encoder_matches_jax(tmp_path):
    """vit_tiny towers of one checkpoint in both packages: the port's
    sharded encode (one module shared by the repeated CPU entries) equals
    its one-device encode and JAX's sharded encode, ragged batch."""
    from mmrs_tpu import config as j_config
    from mmrs_tpu import pipeline as j_pipeline
    from mmrs_tpu.models import checkpoint as j_checkpoint
    from mmrs_tpu.models import clip as j_clip
    from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
    from mmrs_tpu_torch import config as t_config
    from mmrs_tpu_torch import pipeline as t_pipeline

    ckpt = str(tmp_path / "tiny.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(3), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), ckpt)

    def cfg(mod):
        return mod.Config(model=mod.ModelConfig(
            image_tower="vit_tiny", dtype="float32", checkpoint_path=ckpt))

    jt = j_pipeline.build_towers(cfg(j_config))
    tt = t_pipeline.build_towers(cfg(t_config), device="cpu")
    jm, tm = _meshes(4)
    px = np.random.default_rng(5).integers(0, 255, (6, 224, 224, 3),
                                           dtype=np.uint8)
    got = embed.make_sharded_encoder(tt.params_encode_fn, tt.params, tm,
                                     8)(px)
    one = tt.image_encode(px)
    want = j_embed.make_sharded_encoder(jt.encode_fn, jt.params, jm, 8)(px)
    np.testing.assert_allclose(got, one, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-4)


# -- the slot-sharded IVF -----------------------------------------------------------

def _blobs(rng, n, d, n_blobs, sigma=0.15):
    centers = _normed(rng, n_blobs, d)
    which = rng.integers(0, n_blobs, n)
    x = centers[which] + sigma * rng.standard_normal((n, d)).astype(
        np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(30)
    g = _blobs(rng, 1000, 64, 16)
    g[100] = g[7]
    g[900] = g[7]
    cents = np.asarray(J_ivf.train_centroids(g, 16, iters=4, seed=0))
    return g, cents, _normed(rng, 5, 64)


IVF_RUNGS = [("", jnp.float32, torch.float32, 24, 8),
             ("", jnp.float32, torch.float32, 40, 3),
             ("int8", jnp.bfloat16, torch.bfloat16, 48, 8),
             ("int8", jnp.bfloat16, torch.bfloat16, 24, 4),
             ("int4", jnp.bfloat16, torch.bfloat16, 0, 8),
             ("int4", jnp.bfloat16, torch.bfloat16, 128, 3)]


def _separated(vals, eps=1e-6):
    """[Q, k] True where a value is more than eps from its neighbours."""
    v = vals.astype(np.float64)
    gap = np.abs(np.diff(v, axis=1)) > eps
    left = np.concatenate([np.ones_like(gap[:, :1]), gap], axis=1)
    right = np.concatenate([gap, np.ones_like(gap[:, :1])], axis=1)
    return left & right


@pytest.mark.parametrize("quant,jdt,tdt,cap,s", IVF_RUNGS)
def test_sharded_ivf_matches_jax_and_one_device(blobs, quant, jdt, tdt, cap,
                                                s):
    g, cents, q = blobs
    jm, tm = _meshes(s)
    ji = J_ivf.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                         dtype=jdt, bucket_cap=cap)
    ti = T_ivf.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                         dtype=tdt, bucket_cap=cap, device=CPU)
    jsi = j_pivf.place_ivf(ji, jm)
    tsi = pivf.place_ivf(ti, tm)
    assert tsi.bucket_cap % s == 0 and tsi.n_clusters == 16
    assert all(sh.buckets.is_contiguous() for sh in tsi.shards)
    k = 7
    for nprobe in (2, 5, 16):
        jv, jids = j_pivf.sharded_ivf_topk(jnp.asarray(q), jsi, k=k,
                                           nprobe=nprobe, mesh=jm,
                                           impl="xla")
        tv, tids = pivf.sharded_ivf_topk(_t(q), tsi, k=k, nprobe=nprobe,
                                         mesh=tm)
        ov, oids = T_ivf.ivf_topk(_t(q), ti, k=k, nprobe=nprobe)
        tv, tids, ov, oids = (x.numpy() for x in (tv, tids, ov, oids))
        jv, jids = np.asarray(jv), np.asarray(jids)
        if quant == "int4":
            np.testing.assert_array_equal(tv, ov)
            np.testing.assert_allclose(tv, jv, atol=1e-6)
        else:
            np.testing.assert_allclose(tv, ov, atol=1e-6)
            np.testing.assert_allclose(tv, jv, atol=1e-5)
        sep = _separated(ov)
        np.testing.assert_array_equal(tids[sep], oids[sep])
        np.testing.assert_array_equal(tids[_separated(jv)],
                                      jids[_separated(jv)])
    # nprobe == C through the mesh is the flat scan
    tv, tids = pivf.sharded_ivf_topk(_t(q), tsi, k=k, nprobe=16, mesh=tm)
    rows = l2_normalize(_t(g))        # the index's fill normalizes again
    if quant == "int4":
        fv, fi = t_quant4.cosine_topk_int4(
            _t(q), *t_quant4.quantize_rows_int4(rows), k)
        np.testing.assert_array_equal(tv.numpy(), fv.numpy())
    else:
        if quant == "int8":   # the unquantized query against the codes
            codes, sc = t_quant.quantize_rows(rows)
            scores = (_t(q).to(torch.bfloat16).float() @ codes.float().T
                      * sc[None, :])
            fv, fi = sorted_topk(scores, k)
        else:
            fv, fi = cosine_topk(_t(q), _t(g), k)
        np.testing.assert_allclose(tv.numpy(), fv.numpy(), atol=1e-6)
    sep = _separated(fv.numpy())
    np.testing.assert_array_equal(tids.numpy()[sep], fi.numpy()[sep])


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_sharded_build_equals_placed_build(blobs, quant):
    """build_ivf(mesh=) streams rows straight into the strips; at a cap
    the mesh rounding leaves as it is (a multiple of 8 S, int4 128 S), its
    strips are place_ivf(build_ivf())'s, and its global slot maps JAX's
    sharded build's."""
    g, cents, q = blobs
    s = 4
    cap = 512 if quant == "int4" else 64
    dt = torch.float32 if quant == "" else torch.bfloat16
    jm, tm = _meshes(s)
    a = pivf.place_ivf(T_ivf.build_ivf(g, n_clusters=16, centroids=cents,
                                       bucket_cap=cap, quantize=quant,
                                       dtype=dt, device=CPU), tm)
    b = T_ivf.build_ivf(g, n_clusters=16, centroids=cents, bucket_cap=cap,
                        quantize=quant, dtype=dt, device=CPU, mesh=tm)
    assert isinstance(b, pivf.ShardedIVF) and b.build_seconds is not None
    for sa, sb in zip(a.shards, b.shards):
        for name in ("buckets", "bucket_ids", "bucket_scales", "spill",
                     "spill_ids", "spill_scales"):
            x, y = getattr(sa, name), getattr(sb, name)
            assert (x is None) == (y is None), name
            if x is not None:
                assert torch.equal(x, y), name
    jb = J_ivf.build_ivf(g, n_clusters=16, centroids=cents, bucket_cap=cap,
                         quantize=quant, dtype=jnp.float32 if quant == ""
                         else jnp.bfloat16, mesh=jm)
    np.testing.assert_array_equal(b.bucket_ids.numpy(),
                                  np.asarray(jb.bucket_ids))
    np.testing.assert_array_equal(b.spill_ids.numpy(),
                                  np.asarray(jb.spill_ids))
    # the auto cap rounds to 8 S (int4: 128 S), as JAX's sharded build
    c = T_ivf.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                        dtype=dt, device=CPU, mesh=tm)
    jc = J_ivf.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                         mesh=jm, dtype=jnp.float32 if quant == ""
                         else jnp.bfloat16)
    assert c.bucket_cap == jc.bucket_ids.shape[1]
    np.testing.assert_array_equal(c.bucket_ids.numpy(),
                                  np.asarray(jc.bucket_ids))
    v1, i1 = pivf.sharded_ivf_topk(_t(q), a, k=6, nprobe=3, mesh=tm)
    v2, i2 = pivf.sharded_ivf_topk(_t(q), b, k=6, nprobe=3, mesh=tm)
    assert torch.equal(v1, v2) and torch.equal(i1, i2)


def test_sharded_ivf_needs_a_mesh_and_reports_its_size(blobs):
    g, cents, q = blobs
    ti = T_ivf.build_ivf(g, n_clusters=16, centroids=cents, bucket_cap=24,
                         quantize="int8", device=CPU)
    _, tm = _meshes(5)
    tsi = pivf.place_ivf(ti, tm)
    with pytest.raises(ValueError, match="needs a mesh"):
        pivf.sharded_ivf_topk(_t(q), tsi, k=3)
    # dead slots pad the cap to 25 and the spill to a multiple of 5
    assert tsi.bucket_cap == 25 and tsi.spill_ids.shape[0] % 5 == 0
    ids = tsi.bucket_ids.numpy()
    np.testing.assert_array_equal(ids[:, :24], ti.bucket_ids.numpy())
    assert (ids[:, 24:] == -1).all()
    assert tsi.hbm_bytes() >= ti.hbm_bytes()
