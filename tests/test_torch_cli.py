"""`mmrs-torch index build | search | calibrate` and the governance
commands against `mmrs`, in process.

Both CLIs run on one tiny tree of images with one f32 weight checkpoint
(written by mmrs_tpu's save_npz, loaded by both through `--config`). The
port's output lines must have the JAX CLI's format and content: the same
JSON keys, the same hits in the same order, scores and thresholds within
float tolerance. The governance commands (dedup, leakage, convert, clean,
rename, merge, dataset make) must print identical lines and write
identical files. Without a card and without MMRS_TORCH_DEVICE=cpu, the
entry points must refuse to run rather than fall back to the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from mmrs_tpu.cli.main import main as j_main
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
from mmrs_tpu_torch.cli.main import main as t_main

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_torch")
    rng = np.random.default_rng(0)
    root = base / "tree"
    for cls, color in (("red", (255, 0, 0)), ("blue", (0, 0, 255))):
        (root / cls).mkdir(parents=True)
        for i in range(3):
            arr = np.zeros((40, 40, 3), np.uint8) + np.uint8(color)
            arr = np.clip(arr.astype(int) + rng.integers(0, 60, arr.shape),
                          0, 255).astype(np.uint8)
            Image.fromarray(arr).save(root / cls / f"{cls}{i}.jpg")
    ckpt = str(base / "w.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(1), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), ckpt)
    cfg = base / "tiny.yaml"
    cfg.write_text(f"model:\n  image_tower: vit_tiny\n  dtype: float32\n"
                   f"  checkpoint_path: {ckpt}\n")
    merges = base / "merges.txt"
    merges.write_text("#version: 0.2\nr e\nre d</w>\nb l\nbl u\nblu e</w>\n")
    return str(root), str(cfg), str(merges), base


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    out = capsys.readouterr().out
    assert exit_info.value.code == 0, out
    return out.strip().splitlines()


def _rows(lines):
    return [line.split("\t") for line in lines]


def test_index_search_calibrate_match_jax_cli(setup, capsys):
    root, cfg, merges, base = setup
    outs = {}
    for name, main in (("jax", j_main), ("torch", t_main)):
        index = str(base / f"idx_{name}")
        build = json.loads(_run(main, ["index", "build", "--root", root,
                                       "--out", index, "--config", cfg,
                                       "--workers", "2"], capsys)[-1])
        query = os.path.join(root, "red", "red1.jpg")
        image = _run(main, ["search", "--index", index, "--image", query,
                            "-k", "3", "--config", cfg], capsys)
        proto = _run(main, ["search", "--index", index, "--image", query,
                            os.path.join(root, "red", "red2.jpg"),
                            "--prototype", "mean", "-k", "4",
                            "--config", cfg], capsys)
        text = _run(main, ["search", "--index", index, "--text", "red",
                           "--merges", merges, "-k", "2",
                           "--config", cfg], capsys)
        calib = json.loads(_run(main, ["calibrate", "--index", index,
                                       "--positive-class", "red",
                                       "--shots", "3", "--config", cfg],
                                capsys)[-1])
        outs[name] = (build, image, proto, text, calib)

    (jb, ji, jp, jt, jc), (tb, ti, tp, tt, tc) = outs["jax"], outs["torch"]
    assert set(tb) == set(jb) and tb["entries"] == jb["entries"] == 6
    assert tb["dim"] == jb["dim"]
    for j_lines, t_lines in ((ji, ti), (jp, tp), (jt, tt)):
        assert len(t_lines) == len(j_lines) > 0
        for j, t in zip(_rows(j_lines), _rows(t_lines)):
            assert len(t) == 5 and t[0] == j[0] and t[1] == j[1]
            assert t[3:] == j[3:]                        # class, path
            assert len(t[2].split(".")[1]) == 4          # score: %.4f
            assert abs(float(t[2]) - float(j[2])) <= 2e-2
    assert list(tc) == list(jc) and tc["class"] == "red"
    assert abs(tc["best_threshold"] - jc["best_threshold"]) <= 1e-3
    assert abs(tc["best_f1"] - jc["best_f1"]) <= 1e-9


def test_search_needs_image_or_text(setup, capsys):
    root, cfg, _, base = setup
    index = str(base / "idx_only")
    _run(t_main, ["index", "build", "--root", root, "--out", index,
                  "--config", cfg, "--workers", "2"], capsys)
    with pytest.raises(SystemExit) as e:
        t_main(["search", "--index", index, "--config", cfg])
    assert e.value.code == 2


# -- no silent CPU: entry points need a card or an explicit CPU request -------

@pytest.fixture(scope="module")
def torch_index(setup):
    root, cfg, _, base = setup
    index = str(base / "idx_device")
    with pytest.raises(SystemExit) as e:
        t_main(["index", "build", "--root", root, "--out", index,
                "--config", cfg, "--workers", "2"])
    assert e.value.code == 0
    return index


def _entry_point(name, setup, index):
    from mmrs_tpu_torch.config import Config, ModelConfig
    from mmrs_tpu_torch.govern.dedup import embedding_dedup
    from mmrs_tpu_torch.index import ivf as t_ivf
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.index.stream import streaming_topk
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.search.engine import SearchEngine
    from mmrs_tpu_torch.adapt.tip_adapter import train_tip_adapter_f

    root, cfg, _, _ = setup
    rows = np.eye(4, 8, dtype=np.float32)
    return {
        "build_towers": lambda: build_towers(
            Config(model=ModelConfig(image_tower="vit_tiny"))),
        "SearchEngine": lambda: SearchEngine(
            GalleryIndex(rows, list("abcd"), ["c"] * 4)),
        "streaming_topk": lambda: streaming_topk(rows, rows[:1], k=2),
        "build_ivf": lambda: t_ivf.build_ivf(torch.from_numpy(rows),
                                             n_clusters=2),
        "embedding_dedup": lambda: embedding_dedup(rows, list("abcd")),
        "mmrs-torch search": lambda: t_main([
            "search", "--index", index, "--image",
            os.path.join(root, "red", "red1.jpg"), "--config", cfg]),
        "train_tip_adapter_f": lambda: train_tip_adapter_f(
            rows[:2], [0, 1], rows[2:], [0, 1], rows[:2], np.eye(2),
            rows[:2].T, 2, epochs=1),
        "mmrs-torch adapter train": lambda: t_main([
            "adapter", "train", "--root", root, "--config", cfg]),
        "mmrs-torch serve": lambda: t_main([
            "serve", "--index", index, "--config", cfg]),
    }[name]


@pytest.mark.parametrize("name", ["build_towers", "SearchEngine",
                                  "streaming_topk", "build_ivf",
                                  "embedding_dedup", "mmrs-torch search",
                                  "train_tip_adapter_f",
                                  "mmrs-torch adapter train",
                                  "mmrs-torch serve"])
def test_entry_points_refuse_the_cpu_unless_asked(setup, torch_index,
                                                  monkeypatch, name):
    call = _entry_point(name, setup, torch_index)
    monkeypatch.delenv("MMRS_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MMRS_TORCH_DEVICE=cpu"):
        call()


def test_cli_without_a_card_exits_nonzero(setup, torch_index):
    import subprocess
    import sys

    root, cfg, _, _ = setup
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "MMRS_TORCH_DEVICE"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo)
    argv = [sys.executable, "-m", "mmrs_tpu_torch.cli.main", "search",
            "--index", torch_index, "--image",
            os.path.join(root, "red", "red1.jpg"), "--config", cfg]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                       env=env, cwd=repo)
    assert r.returncode != 0 and r.stdout == ""
    assert "MMRS_TORCH_DEVICE=cpu" in r.stderr
    r = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                       env=dict(env, MMRS_TORCH_DEVICE="cpu"), cwd=repo)
    assert r.returncode == 0 and r.stdout.count("\n") == 6, r.stderr[-2000:]


# -- governance commands: `mmrs` and `mmrs-torch` print the same lines --------

def _grad(seed, size=(64, 64)):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)).resize(
        size, Image.BILINEAR)


@pytest.fixture(scope="module")
def gov_tree(tmp_path_factory):
    from mmrs_tpu_torch.index.gallery import _write_manifest, _write_shard

    base = tmp_path_factory.mktemp("gov_cli")
    for d in ("ref", "tgt", "train", "test", "mixed/sub", "classes/cat",
              "classes/猫", "classes/dog", "vqa/cat", "vqa/dog", "vqa/horse",
              "vqa/lynx", "vqa/ez_negative", "vqa/cat_negative"):
        (base / d).mkdir(parents=True)
    _grad(10).save(base / "ref" / "a.png")
    _grad(10).save(base / "tgt" / "a_copy.png")
    _grad(11).save(base / "tgt" / "b.png")
    _grad(20, (128, 128)).save(base / "tgt" / "big.jpg", quality=98)
    _grad(20, (128, 128)).save(base / "tgt" / "small.jpg", quality=40)
    _grad(30).save(base / "test" / "t1.png")
    _grad(30).save(base / "train" / "leaked.png")
    _grad(31).save(base / "train" / "clean.png")
    _grad(1).save(base / "mixed" / "keep.jpg")
    _grad(2).save(base / "mixed" / "t.png")
    _grad(3).save(base / "mixed" / "sub" / "drop.bmp")
    for cls, n in (("cat", 3), ("猫", 2), ("dog", 2)):
        for i in range(n):
            _grad(i + 40).save(base / "classes" / cls / f"w_{i}.jpg")
    for cls, n in (("cat", 6), ("dog", 4), ("horse", 5), ("lynx", 3),
                   ("ez_negative", 12), ("cat_negative", 4)):
        for i in range(n):
            (base / "vqa" / cls / f"{cls}{i}.jpg").write_bytes(b"")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((60, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[20] = x[5]
    x[40] = x[20]
    x[59] = x[7]
    index = base / "emb_index"
    index.mkdir()
    shard = _write_shard(str(index), 0, x.astype(np.float16),
                         [(f"img{i}.jpg", "c") for i in range(60)])
    _write_manifest(str(index), [shard], 16)
    return base


GOV_COMMANDS = {
    "dedup exact": ["dedup", "--mode", "exact", "--reference", "{b}/ref",
                    "--target", "{b}/tgt", "--workers", "2"],
    "dedup perceptual": ["dedup", "--mode", "perceptual", "--target",
                         "{b}/tgt", "--hamming", "5"],
    "dedup embedding": ["dedup", "--mode", "embedding", "--index",
                        "{b}/emb_index", "--tau", "0.999"],
    "leakage": ["leakage", "--train", "{b}/train", "--test", "{b}/test"],
    "leakage tolerance": ["leakage", "--train", "{b}/train", "--test",
                          "{b}/test", "--tolerance", "3"],
    "convert": ["convert", "--root", "{b}/mixed"],
    "clean": ["clean", "--root", "{b}/mixed"],
    "rename": ["rename", "--root", "{b}/classes"],
    "merge": ["merge", "--root", "{b}/classes", "--map", "猫=cat",
              "dog=canine"],
}


@pytest.mark.parametrize("name", sorted(GOV_COMMANDS))
def test_governance_commands_print_the_jax_lines(gov_tree, capsys, name):
    argv = [a.format(b=gov_tree) for a in GOV_COMMANDS[name]]
    want = _run(j_main, argv, capsys)
    got = _run(t_main, argv, capsys)
    assert got == want and len(got) >= 1
    if name.startswith(("dedup", "leakage")):
        assert any(line.startswith(("DUP\t", "LEAK\t")) for line in got)


@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4", "v5"])
def test_dataset_make_writes_the_jax_files(gov_tree, capsys, variant):
    out = gov_tree / f"vqa_{variant}" / ("out" if variant == "v4" else
                                         "dataset.json")
    argv = ["dataset", "make", "--variant", variant, "--root",
            str(gov_tree / "vqa"), "--out", str(out), "--seed", "3"]

    def written():
        files = [out] if out.is_file() else sorted(out.iterdir())
        return {f.name: f.read_text(encoding="utf-8") for f in files}

    want = _run(j_main, argv, capsys)
    want_files = written()
    got = _run(t_main, argv, capsys)
    assert got == want and written() == want_files
    assert len(want_files) == (4 if variant == "v4" else 1)


@pytest.mark.parametrize("argv", [
    ["dedup", "--mode", "exact", "--target", "x"],     # needs --reference
    ["dedup", "--mode", "perceptual"],                  # needs --target
    ["dedup", "--mode", "embedding"],                   # needs --index
    ["dedup", "--mode", "fuzzy", "--target", "x"],
    ["leakage", "--train", "x"],
    ["merge", "--root", "x"],
    ["dataset", "make", "--variant", "v9", "--root", "x", "--out", "y"],
    ["convert"],
])
def test_governance_usage_errors_exit_2(capsys, argv):
    for main in (j_main, t_main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    capsys.readouterr()


@pytest.mark.parametrize("shards", ["2", "3", "8"])
def test_dedup_gallery_shards_prints_the_jax_lines(gov_tree, capsys, shards):
    """`dedup --mode embedding --gallery-shards N`: the ring over N CPU
    entries prints `mmrs`'s lines (its ring over N of the 8 CPU devices),
    which are the one-device run's."""
    argv = ["dedup", "--mode", "embedding", "--index",
            str(gov_tree / "emb_index"), "--tau", "0.999"]
    want = _run(j_main, argv + ["--gallery-shards", shards], capsys)
    got = _run(t_main, argv + ["--gallery-shards", shards], capsys)
    assert got == want == _run(t_main, argv, capsys)
    assert sum(line.startswith("DUP\t") for line in got) == 3


def test_gallery_shards_below_one_exits_2(setup, torch_index, capsys):
    _, cfg, _, _ = setup
    for main in (j_main, t_main):
        with pytest.raises(SystemExit) as e:
            main(["search", "--index", torch_index, "--config", cfg,
                  "--text", "red", "--gallery-shards", "0"])
        assert e.value.code == 2
    assert "--gallery-shards must be >= 1, got 0" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [[], ["--gallery-quant", "int8"],
                                   ["--gallery-quant", "int4"],
                                   ["--ann-nprobe", "2", "--ann-clusters",
                                    "2"]])
def test_search_calibrate_gallery_shards_match_jax_cli(setup, capsys,
                                                       tmp_path, flags):
    """`search|calibrate --gallery-shards 2` on both CLIs, each over its
    own index of the same tree: the same lines as the one-device runs
    (calibration takes the flat rungs only)."""
    root, cfg, merges, base = setup
    query = os.path.join(root, "red", "red1.jpg")
    outs = {}
    for name, main in (("jax", j_main), ("torch", t_main)):
        index = str(tmp_path / f"idx_{name}")
        _run(main, ["index", "build", "--root", root, "--out", index,
                    "--config", cfg, "--workers", "2"], capsys)
        runs = []
        for shards in (["--gallery-shards", "2"], []):
            image = _run(main, ["search", "--index", index, "--image",
                                query, "-k", "4", "--config", cfg,
                                *shards, *flags], capsys)
            text = _run(main, ["search", "--index", index, "--text", "red",
                               "--merges", merges, "-k", "3", "--config",
                               cfg, *shards, *flags], capsys)
            calib = None
            if "--ann-nprobe" not in flags:
                calib = json.loads(_run(main, [
                    "calibrate", "--index", index, "--positive-class",
                    "red", "--shots", "3", "--config", cfg, *shards,
                    *flags], capsys)[-1])
            runs.append((image, text, calib))
        outs[name] = runs
    (t2, t1), (j2, _) = outs["torch"], outs["jax"]
    for t_lines, o_lines, j_lines in zip(t2[:2], t1[:2], j2[:2]):
        assert len(t_lines) == len(j_lines) == len(o_lines) > 0
        for t, o, j in zip(_rows(t_lines), _rows(o_lines), _rows(j_lines)):
            assert t[:2] == j[:2] and t[3:] == j[3:] and t == o
            assert abs(float(t[2]) - float(j[2])) <= 2e-2
    if t2[2] is not None:
        assert t2[2] == t1[2]
        assert abs(t2[2]["best_threshold"] - j2[2]["best_threshold"]) <= 1e-3
        assert abs(t2[2]["best_f1"] - j2[2]["best_f1"]) <= 1e-9


def test_index_build_sharded_matches_jax(setup, capsys, tmp_path):
    """`index build --sharded` (tests/test_cli_sharded.py): the port over
    a 4-entry CPU mesh (`mesh.data_size: 4`; JAX's over its 8 CPU
    devices) writes the rows of the one-device build; with one device it
    says so and uses it."""
    from mmrs_tpu_torch.index.gallery import GalleryIndex

    root, cfg, _, _ = setup
    text = open(cfg).read() + "gallery:\n  batch_size: 8\n"
    jcfg, tcfg = tmp_path / "j.yaml", tmp_path / "t.yaml"
    jcfg.write_text(text)
    tcfg.write_text(text + "mesh:\n  data_size: 4\n")
    outs = {}
    for name, main, c, extra in (("j", j_main, jcfg, ["--sharded"]),
                                 ("t", t_main, tcfg, ["--sharded"]),
                                 ("one", t_main, jcfg, [])):
        out = str(tmp_path / name)
        _run(main, ["index", "build", "--root", root, "--out", out,
                    "--config", str(c), "--workers", "2", *extra], capsys)
        outs[name] = GalleryIndex.load(out)
    assert outs["t"].paths == outs["j"].paths == outs["one"].paths
    np.testing.assert_allclose(outs["t"].embeddings, outs["one"].embeddings,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(outs["t"].embeddings, outs["j"].embeddings,
                               atol=2e-3)
    with pytest.raises(SystemExit) as e:
        t_main(["index", "build", "--root", root, "--out",
                str(tmp_path / "solo"), "--config", str(jcfg), "--workers",
                "2", "--sharded"])
    assert e.value.code == 0
    assert "--sharded requested but only one device; using it" in \
        capsys.readouterr().err


# -- adapter train, serve: the JAX CLI's lines; the --tp usage errors --------

def test_adapter_train_root_prints_the_jax_json(setup, capsys, tmp_path):
    root, cfg, merges, _ = setup
    argv = ["adapter", "train", "--root", root, "--config", cfg,
            "--merges", merges, "--shots", "2", "--augment-epochs", "2",
            "--epochs", "3", "--alpha", "30", "--beta", "5", "--search-hp"]
    want = json.loads(_run(j_main, argv + ["--out", str(tmp_path / "j.npz")],
                           capsys)[-1])
    got = json.loads(_run(t_main, argv + ["--out", str(tmp_path / "t.npz")],
                          capsys)[-1])
    assert list(got) == list(want)
    assert got["classes"] == want["classes"] == ["blue", "red"]
    for key in ("zero_shot_f1", "tip_f1", "best_f1", "best_epoch"):
        assert got[key] == want[key], key
    assert got["hp"]["f1"] == want["hp"]["f1"]
    assert (got["hp"]["beta"], got["hp"]["alpha"]) == \
        (want["hp"]["beta"], want["hp"]["alpha"])
    jz, tz = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(tz.files) == sorted(jz.files)
    np.testing.assert_allclose(tz["adapter_keys"], jz["adapter_keys"],
                               atol=1e-5)
    np.testing.assert_array_equal(tz["classes"], jz["classes"])


def test_adapter_train_features_prints_the_jax_json(capsys, tmp_path):
    rng = np.random.default_rng(3)

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    feats = tmp_path / "f.npz"
    np.savez(feats, aug_features=unit(2, 12, 16),
             train_features=unit(12, 16),
             train_labels=np.arange(12) % 3, test_features=unit(30, 16),
             test_labels=np.arange(30) % 3, clip_weights=unit(3, 16).T,
             num_classes=3)
    argv = ["adapter", "train", "--features", str(feats), "--epochs", "4",
            "--search-hp"]
    want = json.loads(_run(j_main, argv, capsys)[-1])
    got = json.loads(_run(t_main, argv, capsys)[-1])
    assert list(got) == list(want) == ["best_f1", "best_epoch", "hp"]
    assert (got["best_f1"], got["best_epoch"]) == (want["best_f1"],
                                                   want["best_epoch"])
    assert got["hp"]["f1"] == pytest.approx(want["hp"]["f1"], abs=1e-6)


def test_adapter_train_needs_an_input(capsys):
    for main in (j_main, t_main):
        with pytest.raises(SystemExit) as e:
            main(["adapter", "train"])
        assert e.value.code == 2
    assert "need --features or --root" in capsys.readouterr().err


@pytest.mark.parametrize("spec,needle", [
    ("abc", "--tp must be N or DxT"), ("0", "--tp sizes must be >= 1"),
    ("4096", "does not divide"), ("6", "does not divide"),
    ("2x3", "does not divide")])
@pytest.mark.parametrize("cmd", ["cascade", "serve"])
def test_tp_usage_errors_exit_2_before_the_checkpoint(capsys, cmd, spec,
                                                      needle):
    """--tp N | DxT is parsed, the device count checked and the 7B
    decoder's Megatron divisibility checked before any checkpoint is read
    (the paths do not exist): both packages' _make_verifier give 2. On
    the CPU the port has as many entries as asked, so 4096 fails the
    divisibility check (JAX's 8-device mesh fails the count first)."""
    from mmrs_tpu.cli.main import _make_verifier as j_make
    from mmrs_tpu.cli.main import build_parser as j_parser
    from mmrs_tpu_torch.cli.main import _make_verifier as t_make
    from mmrs_tpu_torch.cli.main import build_parser as t_parser

    extra = (["--root", "r", "--positive-class", "c", "--class-embed",
              "e.npy", "--threshold", "0"] if cmd == "cascade"
             else ["--index", "idx"])
    argv = [cmd, *extra, "--verifier", "llava", "--llava-checkpoint",
            "missing.npz", "--tokenizer-model", "missing.model", "--tp",
            spec]
    assert j_make(j_parser().parse_args(argv)) == 2
    capsys.readouterr()
    assert t_make(t_parser().parse_args(argv)) == 2
    assert needle in capsys.readouterr().err


@pytest.mark.parametrize("shards", [1, 2])
def test_serve_command_answers_over_http(setup, torch_index, shards):
    """`mmrs-torch serve [--gallery-shards 2]` in its own process
    (MMRS_TORCH_DEVICE=cpu): it answers /healthz, reporting its shards,
    and a text search, then stops on SIGTERM."""
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    root, cfg, merges, _ = setup
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mmrs_tpu_torch.cli.main", "serve",
         "--index", torch_index, "--config", cfg, "--merges", merges,
         "--port", str(port), "--gallery-shards", str(shards)], cwd=repo,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=repo, MMRS_TORCH_DEVICE="cpu"))
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()[1][-2000:]
                assert time.time() < deadline, "server never came up"
                time.sleep(0.2)
        assert health["rows"] == 6 and health["gallery_quant"] == "bf16"
        assert health["gallery_shards"] == shards
        req = urllib.request.Request(
            base + "/v1/search",
            data=json.dumps({"text": "red", "k": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            hits = json.loads(r.read())["hits"]
        assert len(hits) == 1 and len(hits[0]) == 3
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    assert out.startswith(f"serving 6 rows on {base}")
