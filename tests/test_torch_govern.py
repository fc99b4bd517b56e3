"""The port's governance modules (mmrs_tpu_torch/govern) against
mmrs_tpu's, on the CPU.

Counterparts of tests/test_govern.py (hashing, dedup, leakage, normalize,
manifest, VQA) and tests/test_native.py: both packages run on the same
tmp trees, or on two copies of one tree where a command changes it, and
their reports, hashes and written files must be equal. The embedding mode
runs the first-match kernel's plain version here (the port on the CPU, as
MMRS_TORCH_DEVICE=cpu asks); K9 itself is held against it on the card.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from mmrs_tpu.govern import dedup as j_dedup
from mmrs_tpu.govern import hashing as j_hashing
from mmrs_tpu.govern import manifest as j_manifest
from mmrs_tpu.govern import native as j_native
from mmrs_tpu.govern import normalize as j_normalize
from mmrs_tpu.govern import vqa as j_vqa
from mmrs_tpu_torch.govern import dedup, hashing, manifest, native, \
    normalize, vqa

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _gradient_img(seed=0, size=(64, 64)):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (8, 8, 3), np.uint8)
    return Image.fromarray(base).resize(size, Image.BILINEAR)


def _noise_img(seed, size=(40, 32)):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (size[1], size[0], 3),
                                        np.uint8))


def _rel(report_pairs, root):
    return [tuple(os.path.relpath(p, root) for p in pair)
            for pair in report_pairs]


# -- hashing -----------------------------------------------------------------

HASHES = ("exact_pixel_hash", "ahash", "dhash", "phash", "whash")


@pytest.mark.parametrize("fn", HASHES)
@pytest.mark.parametrize("make", [lambda: _gradient_img(3),
                                  lambda: _gradient_img(4, (128, 96)),
                                  lambda: _noise_img(5)])
def test_hashes_equal_jax(fn, make):
    img = make()
    assert getattr(hashing, fn)(img) == getattr(j_hashing, fn)(img)


def test_perceptual_hashes_and_compare_equal_jax():
    a, b = _gradient_img(0), _gradient_img(1)
    ta, tb = hashing.perceptual_hashes(a), hashing.perceptual_hashes(b)
    ja, jb = j_hashing.perceptual_hashes(a), j_hashing.perceptual_hashes(b)
    assert ta.to_hex() == ja.to_hex() and tb.to_hex() == jb.to_hex()
    assert hashing.compare_hashes(ta, hashing.perceptual_hashes(a))
    assert not hashing.compare_hashes(ta, tb)
    assert hashing.compare_hashes(ta, tb, 64) == j_hashing.compare_hashes(
        ja, jb, 64)


def test_packed_hamming_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 63, 10, dtype=np.uint64)
    b = rng.integers(0, 2 ** 63, 7, dtype=np.uint64)
    np.testing.assert_array_equal(hashing.packed_hamming(a, b),
                                  j_hashing.packed_hamming(a, b))
    assert hashing.hamming(a[0], b[0]) == j_hashing.hamming(a[0], b[0])


# -- dedup -------------------------------------------------------------------

@pytest.fixture()
def dup_tree(tmp_path):
    ref = tmp_path / "ref"
    tgt = tmp_path / "tgt"
    ref.mkdir()
    tgt.mkdir()
    _gradient_img(10).save(ref / "a.png")
    _gradient_img(10).save(tgt / "a_copy.png")     # exact pixel dup
    _gradient_img(11).save(tgt / "b.png")
    _gradient_img(12).save(tgt / "c.png")
    return ref, tgt


def _paths(d):
    return [str(p) for p in sorted(d.iterdir())]


def test_exact_dedup_equal_jax_then_delete(dup_tree):
    ref, tgt = dup_tree
    rep = dedup.exact_dedup(_paths(ref), _paths(tgt), dry_run=True)
    want = j_dedup.exact_dedup(_paths(ref), _paths(tgt), dry_run=True)
    assert rep.duplicates == want.duplicates and rep.summary() == \
        want.summary()
    assert rep.num_duplicates == 1
    assert rep.duplicates[0][0].endswith("a_copy.png")
    assert os.path.exists(rep.duplicates[0][0])
    rep2 = dedup.exact_dedup(_paths(ref), _paths(tgt), dry_run=False)
    assert rep2.removed == [rep.duplicates[0][0]]
    assert not os.path.exists(rep.duplicates[0][0])
    assert os.path.exists(str(ref / "a.png"))


def test_perceptual_dedup_equal_jax_keeps_largest(tmp_path):
    img = _gradient_img(20, (128, 128))
    img.save(tmp_path / "big.jpg", quality=98)
    img.save(tmp_path / "small.jpg", quality=40)
    _gradient_img(21, (128, 128)).save(tmp_path / "other.jpg", quality=95)
    paths = _paths(tmp_path)
    rep = dedup.perceptual_dedup(paths, dry_run=True)
    want = j_dedup.perceptual_dedup(paths, dry_run=True)
    assert rep.duplicates == want.duplicates
    assert len(rep.duplicates) == 1
    dup, keeper = rep.duplicates[0]
    assert dup.endswith("small.jpg") and keeper.endswith("big.jpg")


def test_perceptual_dedup_keeps_transitive_nonmatches(tmp_path, monkeypatch):
    sizes = {"A.jpg": 300, "B.jpg": 200, "C.jpg": 100}
    for name, size in sizes.items():
        (tmp_path / name).write_bytes(b"x" * size)
    hashes = {"A.jpg": np.uint64(0), "B.jpg": np.uint64(0x7),
              "C.jpg": np.uint64(0xF7)}

    def fake_hash_one(path, fn):
        h = hashes[os.path.basename(path)]
        return hashing.PerceptualHashes(phash=h, dhash=h, whash=h)

    monkeypatch.setattr(dedup, "_hash_one", fake_hash_one)
    rep = dedup.perceptual_dedup([str(tmp_path / n) for n in sizes],
                                 threshold=5, dry_run=True)
    assert {os.path.basename(d): os.path.basename(k)
            for d, k in rep.duplicates} == {"B.jpg": "A.jpg"}


@pytest.mark.parametrize("tolerance", [0, 3])
def test_leakage_removal_equal_jax(tmp_path, tolerance):
    train = tmp_path / "train"
    test = tmp_path / "test"
    train.mkdir()
    test.mkdir()
    _gradient_img(30).save(test / "t1.png")
    _gradient_img(32).save(test / "t2.png")
    _gradient_img(30).save(train / "leaked.png")
    _gradient_img(31).save(train / "clean.png")
    rep = dedup.leakage_removal(_paths(train), _paths(test),
                                tolerance=tolerance, dry_run=True)
    want = j_dedup.leakage_removal(_paths(train), _paths(test),
                                   tolerance=tolerance, dry_run=True)
    assert rep.duplicates == want.duplicates
    assert [d for d, _ in rep.duplicates] == [str(train / "leaked.png")]


def test_parallel_hashing_matches_sequential(tmp_path):
    paths = []
    for i in range(12):
        p = tmp_path / f"im{i}.png"
        _noise_img(i).save(p)
        paths.append(str(p))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    paths.insert(5, str(bad))
    err_seq, err_par = [], []
    seq = list(dedup._iter_hashes(paths, hashing.perceptual_hashes, err_seq,
                                  workers=1))
    par = list(dedup._iter_hashes(paths, hashing.perceptual_hashes, err_par,
                                  workers=8))
    assert [p for p, _ in par] == [p for p, _ in seq]
    assert [h.to_hex() for _, h in par] == [h.to_hex() for _, h in seq]
    assert len(err_seq) == len(err_par) == 1
    assert err_par[0][0].endswith("bad.png")


@pytest.mark.parametrize("n,d", [(50, 16), (333, 64)])
def test_embedding_dedup_chains_equal_jax(n, d):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[20] = x[5]
    x[40] = x[20]                       # chain 40 -> 20 -> 5
    x[n - 1] = x[7]
    paths = [f"img{i}.jpg" for i in range(n)]
    rep = dedup.embedding_dedup(x, paths, tau=0.999)
    want = j_dedup.embedding_dedup(x, paths, tau=0.999, impl="xla")
    assert rep.duplicates == want.duplicates
    assert rep.summary() == want.summary()
    got = dict(rep.duplicates)
    assert got["img20.jpg"] == got["img40.jpg"] == "img5.jpg"
    assert got[f"img{n - 1}.jpg"] == "img7.jpg"


def test_embedding_dedup_refuses_mesh():
    x = np.eye(4, dtype=np.float32)
    with pytest.raises(NotImplementedError, match="A.12"):
        dedup.embedding_dedup(x, list("abcd"), mesh=object())


# -- normalize / manifest ------------------------------------------------------

def _tree_pair(tmp_path, build):
    """Two identical copies of a tree built by `build(root)`."""
    a, b = tmp_path / "j", tmp_path / "t"
    a.mkdir()
    build(a)
    shutil.copytree(a, b)
    return a, b


def _listing(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.md5(
                    fh.read()).hexdigest()
    return out


def _mixed_tree(root):
    rgba = np.zeros((10, 10, 4), np.uint8)
    rgba[..., 0] = 200
    Image.fromarray(rgba, "RGBA").save(root / "t.png")
    _gradient_img(1).save(root / "keep.jpg")
    (root / "sub").mkdir()
    _gradient_img(2).save(root / "sub" / "drop.bmp")
    Image.fromarray(np.full((8, 8, 3), 10, np.uint8)).save(root / "photo.png")
    Image.fromarray(np.full((8, 8, 3), 200, np.uint8)).save(root / "photo.jpg")
    (root / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("dry_run", [True, False])
def test_convert_to_jpeg_equal_jax(tmp_path, dry_run):
    a, b = _tree_pair(tmp_path, _mixed_tree)
    want = j_normalize.convert_to_jpeg(str(a), dry_run=dry_run)
    rep = normalize.convert_to_jpeg(str(b), dry_run=dry_run)
    assert _rel(rep.converted, b) == _rel(want.converted, a)
    assert [(os.path.relpath(p, b), e) for p, e in rep.errors] == \
        [(os.path.relpath(p, a), e.replace(str(a), str(b)))
         for p, e in want.errors]
    assert _listing(b) == _listing(a)
    assert len(rep.converted) == 2 and any(
        "not overwriting" in e for _, e in rep.errors)


@pytest.mark.parametrize("dry_run", [True, False])
def test_delete_non_jpeg_equal_jax(tmp_path, dry_run):
    a, b = _tree_pair(tmp_path, _mixed_tree)
    want = j_normalize.delete_non_jpeg(str(a), dry_run=dry_run)
    rep = normalize.delete_non_jpeg(str(b), dry_run=dry_run)
    assert [os.path.relpath(p, b) for p in rep.deleted] == \
        [os.path.relpath(p, a) for p in want.deleted]
    assert sorted(os.path.basename(p) for p in rep.deleted) == [
        "drop.bmp", "photo.png", "t.png"]
    assert _listing(b) == _listing(a)


def _class_tree(root):
    for cls, n in [("cat", 3), ("猫", 2), ("dog", 2)]:
        d = root / cls
        d.mkdir()
        for i in range(n):
            _gradient_img(i + len(cls)).save(d / f"whatever_{i}.jpg")
    (root / "dog" / "zeta.PNG").write_bytes(b"png bytes")


@pytest.mark.parametrize("dry_run", [True, False])
def test_canonical_rename_equal_jax(tmp_path, dry_run):
    a, b = _tree_pair(tmp_path, _class_tree)
    want = j_manifest.canonical_rename(str(a), dry_run=dry_run)
    rep = manifest.canonical_rename(str(b), dry_run=dry_run)
    assert _rel(rep.renamed, b) == _rel(want.renamed, a)
    assert _listing(b) == _listing(a)
    if not dry_run:
        assert sorted(os.listdir(b / "cat")) == ["cat1.jpg", "cat2.jpg",
                                                 "cat3.jpg"]


@pytest.mark.parametrize("dry_run", [True, False])
def test_merge_folders_equal_jax(tmp_path, dry_run):
    a, b = _tree_pair(tmp_path, _class_tree)
    mapping = {"猫": "cat", "dog": "canine"}
    want = j_manifest.merge_folders(str(a), mapping, dry_run=dry_run)
    rep = manifest.merge_folders(str(b), mapping, dry_run=dry_run)
    assert _rel(rep.moved, b) == _rel(want.moved, a)
    assert _rel(rep.renamed, b) == _rel(want.renamed, a)
    assert _listing(b) == _listing(a)
    assert len(rep.moved) == 5


# -- VQA builders ---------------------------------------------------------------

@pytest.fixture()
def img_classes():
    return {
        "cat": [f"cat/cat{i}.jpg" for i in range(6)],
        "dog": [f"dog/dog{i}.jpg" for i in range(4)],
        "horse": [f"horse/horse{i}.jpg" for i in range(5)],
        "lynx": [f"lynx/l{i}.jpg" for i in range(3)],
    }


def _read(path):
    with open(path, encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v5"])
@pytest.mark.parametrize("seed", [0, 3])
def test_vqa_records_equal_jax_file_for_file(img_classes, tmp_path, variant,
                                             seed):
    easy = [f"ez_negative/ez{i}.jpg" for i in range(5)]
    outs = {}
    for name, mod in (("jax", j_vqa), ("torch", vqa)):
        out = str(tmp_path / f"{name}_{variant}.json")
        build = getattr(mod, f"build_{variant}")
        if variant == "v3":
            recs = build(img_classes, easy, out, seed=seed)
        elif variant == "v5":
            recs = build(img_classes, out_path=out, seed=seed)
        else:
            recs = build(img_classes, out, seed=seed)
        outs[name] = (recs, _read(out))
    assert outs["torch"][0] == outs["jax"][0]          # ids included
    assert outs["torch"][1] == outs["jax"][1]
    assert vqa.verify_balance(outs["torch"][0]) == j_vqa.verify_balance(
        outs["jax"][0])


def test_vqa_v4_files_equal_jax(img_classes, tmp_path):
    easy = [f"ez_negative/ez{i}.jpg" for i in range(20)]
    hard = {c: [f"{c}_negative/h{i}.jpg" for i in range(10)]
            for c in img_classes}
    want = j_vqa.build_v4(img_classes, easy, hard,
                          out_dir=str(tmp_path / "j"), seed=2)
    got = vqa.build_v4(img_classes, easy, hard, out_dir=str(tmp_path / "t"),
                       seed=2)
    assert got.with_hard == want.with_hard
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 4
    for key in got.files:
        assert _read(got.files[key]) == _read(want.files[key])
        assert all("_meta" not in r for r in json.loads(
            _read(got.files[key])))
    assert vqa.verify_cross_negative_source_balance(got.with_cross) == \
        j_vqa.verify_cross_negative_source_balance(want.with_cross)


# -- native core --------------------------------------------------------------

def _rand_hashes(h, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 63, (h, n), dtype=np.uint64)


def test_native_library_lands_in_the_port_build_dir():
    lib = native.load_library()
    if lib is None:
        pytest.skip("no g++ here: the numpy fallbacks cover the API")
    build_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))), "_build")
    assert os.path.dirname(native.library_path()) == build_dir
    assert os.path.basename(native.library_path()).startswith(
        "libmmrs_govern_")
    assert lib._name == native.library_path()
    assert os.path.exists(native.library_path())
    assert native.SOURCE.endswith(os.path.join("mmrs_tpu_torch", "csrc",
                                               "govern_core.cpp"))


def test_md5_equal_jax(tmp_path):
    for data in [b"", b"abc", b"x" * 1000, bytes(range(70))]:
        assert native.md5_buffer(data) == j_native.md5_buffer(data) == \
            hashlib.md5(data).hexdigest()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(16):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(rng.integers(0, 256, int(rng.integers(0, 5000)),
                                   dtype=np.uint8).tobytes())
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.bin"))
    hexes, ok = native.md5_files(paths, threads=4)
    j_hexes, j_ok = j_native.md5_files(paths, threads=4)
    assert hexes == j_hexes and (ok == j_ok).all()
    assert ok[:16].all() and not ok[16] and hexes[16] == ""


@pytest.mark.parametrize("fallback", [False, True])
def test_hamming_scans_equal_jax(monkeypatch, fallback):
    hashes = _rand_hashes(3, 200, seed=1)
    hashes[0, 150] = hashes[0, 3]
    hashes[1, 180] = hashes[1, 150] ^ np.uint64(0b111)
    a = _rand_hashes(2, 50, seed=2)
    b = _rand_hashes(2, 80, seed=3)
    a[0, 10] = b[0, 40]
    want_first = j_native.hamming_first_match(hashes, threshold=5)
    want_cross = j_native.hamming_cross_any(a, b, threshold=0)
    if fallback:
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
    out = native.hamming_first_match(hashes, threshold=5)
    np.testing.assert_array_equal(out, want_first)
    assert out[150] == 3 and out[180] == 150
    cross = native.hamming_cross_any(a, b, threshold=0)
    np.testing.assert_array_equal(cross, want_cross)
    assert cross[10] == 40


def test_md5_files_non_utf8_filename(tmp_path):
    good = tmp_path / "ok.jpg"
    good.write_bytes(b"hello")
    weird = os.fsdecode(bytes(tmp_path) + b"/img_\xff.jpg")
    with open(weird, "wb") as f:
        f.write(b"world")
    hexes, ok = native.md5_files([str(good), weird])
    assert ok.all()
    assert hexes == [hashlib.md5(b"hello").hexdigest(),
                     hashlib.md5(b"world").hexdigest()]
