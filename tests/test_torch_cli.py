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
    }[name]


@pytest.mark.parametrize("name", ["build_towers", "SearchEngine",
                                  "streaming_topk", "build_ivf",
                                  "embedding_dedup", "mmrs-torch search"])
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


def test_dedup_gallery_shards_waits_for_the_ring(gov_tree, capsys):
    with pytest.raises(SystemExit) as e:
        t_main(["dedup", "--mode", "embedding", "--index",
                str(gov_tree / "emb_index"), "--gallery-shards", "2"])
    assert e.value.code == 2 and "A.12" in capsys.readouterr().err
