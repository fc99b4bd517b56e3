"""`mmrs-torch index build | search | calibrate` against `mmrs`, in process.

Both CLIs run on one tiny tree of images with one f32 weight checkpoint
(written by mmrs_tpu's save_npz, loaded by both through `--config`). The
port's output lines must have the JAX CLI's format and content: the same
JSON keys, the same hits in the same order, scores and thresholds within
float tolerance.
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
