"""The port's int8 / int4 galleries (ops/quant.py, ops/quant4.py,
SearchEngine's residency ladder, the CLI flags) against mmrs_tpu's.

The same seeded numpy rows go through both packages. Gallery codes and
scales must be bit-identical; the plain versions of the two top-k kernels
(K4, K5) must give identical ids and values within 1e-6 against the JAX
Pallas kernels in interpret mode and their XLA forms, including a ragged
tile, N < k and duplicated rows (equal scores: lowest row first). The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda.py).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrs_tpu.cli.main import main as j_main
from mmrs_tpu.index import gallery as j_gallery
from mmrs_tpu.ops import quant as j_quant
from mmrs_tpu.ops import quant4 as j_quant4
from mmrs_tpu.search import engine as j_engine
from mmrs_tpu_torch.cli.main import main as t_main
from mmrs_tpu_torch.index import gallery as t_gallery
from mmrs_tpu_torch.ops import quant, quant4
from mmrs_tpu_torch.search import engine as t_engine

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _j_codes_int4(packed):
    """The JAX package's [D/8, N] words -> int4 codes [N, D]."""
    lo, hi = j_quant4._unpack_planes_xla(packed)
    lo, hi = np.asarray(lo, np.int32), np.asarray(hi, np.int32)
    return np.concatenate([lo - 8, hi // 16], axis=0).T


def _t_codes_int4(packed):
    lo, hi = quant4.planes(packed)
    return torch.cat([lo.int() - 8, hi.int() // 16], dim=1).numpy()


# -- quantization: codes and scales -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = _unit_rows(rng, 300, 64) * rng.uniform(0.1, 3.0, (300, 1))
    x[7] = 0.0                                    # an all-zero row
    jq, js = j_quant.quantize_rows(jnp.asarray(x).astype(dtype))
    tq, ts = quant.quantize_rows(torch.from_numpy(x).to(getattr(torch,
                                                                 dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rows_int4_unpacked_codes_bit_identical_to_jax():
    rng = np.random.default_rng(1)
    x = _unit_rows(rng, 257, 96)
    x[3] = 0.0
    jp, js = j_quant4.quantize_rows_int4(jnp.asarray(x))
    tp, ts = quant4.quantize_rows_int4(torch.from_numpy(x))
    assert tp.shape == (257, 48) and tp.dtype == torch.uint8
    np.testing.assert_array_equal(_t_codes_int4(tp), _j_codes_int4(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="multiple of 8"):
        quant4.quantize_rows_int4(torch.zeros((2, 12)))


# -- K4 / K5 plain versions against the JAX kernels ---------------------------

CASES = [
    (3, 300, 64, 10, 128),       # ragged last tile
    (1, 1000, 128, 16, 256),
    (4, 5, 64, 10, 128),         # N < k: (-inf, -1) sentinels
]


def _gallery(q, n, d, seed, dup=False):
    rng = np.random.default_rng(seed)
    gal, qs = _unit_rows(rng, n, d), _unit_rows(rng, q, d)
    if dup:                                 # exact copies across tiles
        for r in (150, 260, min(399, n - 1)):
            gal[r] = gal[40]
        qs[0] = gal[40]
    return gal, qs


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("q,n,d,k,tile_n", CASES)
def test_int8_topk_matches_jax(jax_impl, q, n, d, k, tile_n):
    gal, qs = _gallery(q, n, d, seed=n)
    jk = min(k, n) if jax_impl == "xla" else k   # lax.top_k needs k <= N
    jg, js = j_quant.quantize_rows(jnp.asarray(gal))
    jv, ji = j_quant.cosine_topk_quantized(jnp.asarray(qs), jg, js, k=jk,
                                           impl=jax_impl, tile_n=tile_n)
    tg, ts = quant.quantize_rows(torch.from_numpy(gal))
    tv, ti = quant.cosine_topk_quantized(torch.from_numpy(qs), tg, ts, k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    if jk < k:                         # no sentinels to compare
        assert (ti[:, n:] == -1).all() and torch.isinf(tv[:, n:]).all()
        tv, ti = tv[:, :n], ti[:, :n]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("q,n,d,k,tile_n", CASES)
def test_int4_topk_matches_jax(jax_impl, q, n, d, k, tile_n):
    gal, qs = _gallery(q, n, d, seed=n + 1)
    jk = min(k, n) if jax_impl == "xla" else k
    jp, js = j_quant4.quantize_rows_int4(jnp.asarray(gal))
    jv, ji = j_quant4.cosine_topk_int4(jnp.asarray(qs), jp, js, k=jk,
                                       impl=jax_impl, tile_n=tile_n)
    tp, ts = quant4.quantize_rows_int4(torch.from_numpy(gal))
    tv, ti = quant4.cosine_topk_int4(torch.from_numpy(qs), tp, ts, k)
    if jk < k:
        assert (ti[:, n:] == -1).all() and torch.isinf(tv[:, n:]).all()
        tv, ti = tv[:, :n], ti[:, :n]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_ties_return_lowest_row_first(mode):
    gal, qs = _gallery(2, 400, 64, seed=3, dup=True)
    if mode == "int8":
        jg, js = j_quant.quantize_rows(jnp.asarray(gal))
        jv, ji = j_quant.cosine_topk_quantized(
            jnp.asarray(qs), jg, js, k=6, impl="pallas_interpret", tile_n=128)
        tv, ti = quant.cosine_topk_quantized(
            torch.from_numpy(qs), *quant.quantize_rows(torch.from_numpy(gal)),
            6)
    else:
        jp, js = j_quant4.quantize_rows_int4(jnp.asarray(gal))
        jv, ji = j_quant4.cosine_topk_int4(
            jnp.asarray(qs), jp, js, k=6, impl="pallas_interpret", tile_n=128)
        tv, ti = quant4.cosine_topk_int4(
            torch.from_numpy(qs),
            *quant4.quantize_rows_int4(torch.from_numpy(gal)), 6)
    assert ti[0, :4].tolist() == [40, 150, 260, 399]
    assert len(set(tv[0, :4].tolist())) == 1             # bit-equal scores
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)


def test_similarities_int4_and_int8_scores_match_jax():
    rng = np.random.default_rng(4)
    gal, qs = _unit_rows(rng, 200, 128), _unit_rows(rng, 3, 128)
    jp, js = j_quant4.quantize_rows_int4(jnp.asarray(gal))
    tp, ts = quant4.quantize_rows_int4(torch.from_numpy(gal))
    np.testing.assert_array_equal(
        quant4.similarities_int4(torch.from_numpy(qs), tp, ts).numpy(),
        np.asarray(j_quant4.similarities_int4(jnp.asarray(qs), jp, js)))
    jg, jgs = j_quant.quantize_rows(jnp.asarray(gal))
    jq, jqs = j_quant.quantize_rows(jnp.asarray(qs))
    want = np.asarray(j_quant._topk_quant_xla(jq, jqs, jg, jgs, 200)[0])
    got = quant.scores_q8(*quant.quantize_rows(torch.from_numpy(qs)),
                          *quant.quantize_rows(torch.from_numpy(gal)))
    np.testing.assert_array_equal(-np.sort(-got.numpy(), axis=1), want)


# -- SearchEngine's residency ladder ------------------------------------------

@pytest.fixture(scope="module")
def index_pair():
    rng = np.random.default_rng(5)
    n, d = 600, 64
    centers = _unit_rows(rng, 3, d)
    cls = rng.integers(0, 3, n)
    rows = centers[cls] + 0.6 * rng.standard_normal((n, d)) / np.sqrt(d)
    rows = rows.astype(np.float32)
    paths = [f"/data/c{c}/{i}.jpg" for i, c in enumerate(cls)]
    classes = [f"c{c}" for c in cls]
    return (j_gallery.GalleryIndex(rows, paths, classes),
            t_gallery.GalleryIndex(rows, paths, classes), rows, cls)


@pytest.mark.parametrize("mode", [True, "int8", "int4"])
def test_engine_ladder_matches_jax(index_pair, mode):
    j_idx, t_idx, rows, cls = index_pair
    j_eng = j_engine.SearchEngine(j_idx, quantize=mode)
    t_eng = t_engine.SearchEngine(t_idx, quantize=mode, device="cpu")
    assert t_eng.quantized == j_eng.quantized
    if j_eng.quantized == "int4":
        np.testing.assert_array_equal(_t_codes_int4(t_eng.gallery),
                                      _j_codes_int4(j_eng.gallery))
    else:
        np.testing.assert_array_equal(t_eng.gallery.numpy(),
                                      np.asarray(j_eng.gallery))
    np.testing.assert_array_equal(t_eng.gallery_scales.numpy(),
                                  np.asarray(j_eng.gallery_scales))

    rng = np.random.default_rng(6)
    qv = rows[[0, 5, 77]] + 0.05 * rng.standard_normal((3, 64)).astype(
        np.float32)
    for j_hits, t_hits in zip(j_eng.query_vectors(qv, top_k=10),
                              t_eng.query_vectors(qv, top_k=10)):
        assert [h.path for h in t_hits] == [h.path for h in j_hits]
        np.testing.assert_allclose([h.score for h in t_hits],
                                   [h.score for h in j_hits], atol=1e-4)
    np.testing.assert_allclose(
        t_eng.device_similarities(qv).numpy(),
        np.asarray(j_eng.device_similarities(jnp.asarray(qv))), atol=1e-6)

    labels = cls == 1
    proto = rows[labels][:8].mean(0)
    j_res = j_eng.sweep_class(jnp.asarray(proto), labels)
    t_res = t_eng.sweep_class(proto, labels)
    assert abs(t_res.best_threshold - j_res.best_threshold) <= 1e-3
    assert abs(t_res.best_f1 - j_res.best_f1) <= 1e-9


def test_engine_quantized_chunked_upload_equals_one_chunk(index_pair):
    _, t_idx, rows, _ = index_pair
    for mode in ("int8", "int4"):
        whole = t_engine._quantize_gallery_chunked(rows, mode,
                                                   torch.device("cpu"))
        chunked = t_engine._quantize_gallery_chunked(
            rows, mode, torch.device("cpu"), chunk=77)
        for a, b in zip(whole, chunked):
            assert torch.equal(a, b)


def test_engine_unknown_quantize_mode_raises(index_pair):
    _, t_idx, _, _ = index_pair
    with pytest.raises(ValueError, match="quantize mode"):
        t_engine.SearchEngine(t_idx, quantize="int2", device="cpu")


# -- the CLI flags ----------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_index(tmp_path_factory, index_pair):
    _, _, rows, cls = index_pair
    out = str(tmp_path_factory.mktemp("quant_cli") / "idx")
    import os
    os.makedirs(out)
    samples = [(f"/data/c{c}/{i}.jpg", f"c{c}") for i, c in enumerate(cls)]
    shard = t_gallery._write_shard(out, 0, rows, samples)
    t_gallery._write_manifest(out, [shard], rows.shape[1])
    return out


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    out = capsys.readouterr().out
    assert exit_info.value.code == 0, out
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [["--gallery-quant", "int4"],
                                   ["--gallery-quant", "int8"],
                                   ["--gallery-int8"]])
def test_calibrate_gallery_quant_flags_match_jax_cli(cli_index, capsys,
                                                     flags):
    argv = ["calibrate", "--index", cli_index, "--positive-class", "c2",
            "--shots", "5", *flags]
    want, got = _run(j_main, argv, capsys), _run(t_main, argv, capsys)
    assert list(got) == list(want)
    assert abs(got["best_threshold"] - want["best_threshold"]) <= 1e-3
    assert abs(got["best_f1"] - want["best_f1"]) <= 1e-9


@pytest.mark.parametrize("flags", [["--gallery-quant", "int4"],
                                   ["--gallery-int8"]])
def test_search_gallery_quant_flags_match_jax_cli(cli_index, tmp_path,
                                                  capsys, flags):
    """`search --image` through the vit_tiny towers (one f32 checkpoint for
    both CLIs) against the quantized gallery: the same hits."""
    import jax
    from PIL import Image

    from mmrs_tpu.models import checkpoint as j_checkpoint
    from mmrs_tpu.models import clip as j_clip
    from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY

    ckpt = str(tmp_path / "tiny.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(2), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), ckpt)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(f"model:\n  image_tower: vit_tiny\n  dtype: float32\n"
                   f"  checkpoint_path: {ckpt}\n")
    img = str(tmp_path / "q.jpg")
    Image.fromarray(np.random.default_rng(9).integers(
        0, 256, (48, 48, 3), dtype=np.uint8)).save(img)
    argv = ["search", "--index", cli_index, "--image", img, "-k", "5",
            "--config", str(cfg), *flags]
    lines = []
    for main in (j_main, t_main):
        with pytest.raises(SystemExit) as exit_info:
            main(argv)
        assert exit_info.value.code == 0
        lines.append([line.split("\t") for line in
                      capsys.readouterr().out.strip().splitlines()])
    want, got = lines
    assert len(got) == len(want) == 5
    for j, t in zip(want, got):
        assert t[:2] == j[:2] and t[3:] == j[3:]       # query, rank, class, path
        assert abs(float(t[2]) - float(j[2])) <= 2e-2


def test_quant_mode_resolution():
    from mmrs_tpu_torch.cli.main import _quant_mode, build_parser

    p = build_parser()
    base = ["search", "--index", "x"]
    assert _quant_mode(p.parse_args(base)) == ""
    assert _quant_mode(p.parse_args(base + ["--gallery-int8"])) == "int8"
    assert _quant_mode(p.parse_args(
        base + ["--gallery-int8", "--gallery-quant", "int4"])) == "int4"
    with pytest.raises(SystemExit):
        p.parse_args(base + ["--gallery-quant", "int2"])
