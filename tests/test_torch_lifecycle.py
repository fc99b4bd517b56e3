"""The port's one-command lifecycle (mmrs_tpu_torch/lifecycle.py,
`mmrs-torch lifecycle`) against mmrs_tpu's (tests/test_lifecycle.py).

Both packages run on test_lifecycle.py's tree (unique basenames, a
planted exact duplicate, a PNG, easy and hard negative pools, a held-out
tree with a leaked file) at vit_tiny f32 from one npz that mmrs_tpu's
save_npz wrote. Their manifests agree: index rows, the best threshold
within 1e-3, the union, gate, dedup and leakage counts, the VQA files
byte for byte, both cross-checks true; every artifact family exists with
the JAX package's file names, CSV columns and JSON keys.
"""

import csv
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax

from test_lifecycle import tree  # noqa: F401 (the shared fixture)

torch.set_num_threads(2)

VQA_FILES = ("dataset_pos.json", "dataset_pos_cross.json",
             "dataset_pos_cross_simple.json",
             "dataset_pos_cross_simple_hard.json")


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):  # noqa: F811
    from mmrs_tpu import config as j_config
    from mmrs_tpu.lifecycle import run_lifecycle as j_run
    from mmrs_tpu.models import checkpoint as j_ckpt
    from mmrs_tpu.models import clip as j_clip
    from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
    from mmrs_tpu_torch import config
    from mmrs_tpu_torch.lifecycle import run_lifecycle as t_run

    root, test_root = tree
    base = tmp_path_factory.mktemp("lifecycle_pair")
    npz = str(base / "tiny.npz")
    j_ckpt.save_npz(j_clip.init(jax.random.key(0), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), npz)
    kw = dict(shots=4, test_root=test_root, dedup_tau=0.9999)
    jcfg = j_config.Config(model=j_config.ModelConfig(
        image_tower="vit_tiny", text_tower="clip_text_tiny",
        dtype="float32", checkpoint_path=npz))
    tcfg = config.Config(model=config.ModelConfig(
        image_tower="vit_tiny", dtype="float32", checkpoint_path=npz))
    j_out, t_out = str(base / "jax"), str(base / "torch")
    return (j_run(root, j_out, "lychee", cfg=jcfg, **kw),
            t_run(root, t_out, "lychee", cfg=tcfg, **kw), tcfg, kw)


def test_manifests_agree_with_jax(runs):
    jm, tm, _, _ = runs
    assert set(tm) == set(jm)
    for stage in jm:
        if isinstance(jm[stage], dict):
            assert set(tm[stage]) == set(jm[stage]), stage
    assert tm["index"]["rows"] == jm["index"]["rows"] >= 25
    assert tm["index"]["dim"] == jm["index"]["dim"]
    assert tm["normalize"]["would_convert"] == \
        jm["normalize"]["would_convert"] == 1
    assert tm["calibrate"]["best_threshold"] == pytest.approx(
        jm["calibrate"]["best_threshold"], abs=1e-3)
    assert tm["calibrate"]["rows"] == jm["calibrate"]["rows"]
    for stage, key in (("union", "en_pass"), ("union", "cn_pass"),
                       ("union", "union_pass"), ("union", "copied"),
                       ("cascade", "images"), ("cascade", "gate_passed"),
                       ("cascade", "final_positives"),
                       ("dedup", "duplicates"), ("leakage", "leaked")):
        assert tm[stage][key] == jm[stage][key], (stage, key)
    for key in ("positives", "with_cross", "with_simple", "with_hard"):
        assert tm["vqa"][key] == jm["vqa"][key], key
    assert tm["cross_checks"] == jm["cross_checks"] == {
        "union_en_pass_eq_cascade_gate": True,
        "calibration_rows_eq_index_rows": True}
    assert 0 < tm["cascade"]["gate_passed"] < tm["cascade"]["images"]


def test_artifacts_equal_jax(runs):
    jm, tm, _, _ = runs
    for f in VQA_FILES:
        assert filecmp.cmp(os.path.join(tm["vqa"]["dir"], f),
                           os.path.join(jm["vqa"]["dir"], f),
                           shallow=False), f
    for stage in ("dedup", "leakage"):
        with open(tm[stage]["report"]) as a, open(jm[stage]["report"]) as b:
            assert json.load(a) == json.load(b), stage
    dups = json.load(open(tm["dedup"]["report"]))["duplicates"]
    assert any("img_dup" in d or "img_dup" in k for d, k in dups)
    leaked = json.load(open(tm["leakage"]["report"]))["leaked"]
    assert any("img000" in d or "img_dup" in d for d, _ in leaked)
    with open(tm["normalize"]["report"]) as a, \
            open(jm["normalize"]["report"]) as b:
        assert json.load(a) == json.load(b)
    for path in (tm["calibrate"]["sweep_csv"], tm["cascade"]["audit_csv"],
                 tm["cascade"]["journal"], tm["union"]["audit_csv"]):
        want = path.replace(tm["out"], jm["out"])
        with open(path) as a, open(want) as b:
            ra, rb = list(csv.DictReader(a)), list(csv.DictReader(b))
        assert len(ra) == len(rb) and list(ra[0]) == list(rb[0]), path
    with open(tm["cascade"]["journal"]) as f:
        assert len(list(csv.DictReader(f))) == tm["cascade"]["images"]
    with open(os.path.join(tm["out"], "calibrate", "calibration.json")) as a:
        cal = json.load(a)
    with open(os.path.join(jm["out"], "calibrate", "calibration.json")) as b:
        jcal = json.load(b)
    assert set(cal) == set(jcal) and cal["rows"] == jcal["rows"]
    with open(os.path.join(tm["out"], "lifecycle.json")) as f:
        assert json.load(f)["cross_checks"] == tm["cross_checks"]
    with open(tm["calibrate"]["sweep_csv"]) as f:
        assert len(list(csv.DictReader(f))) >= 100


def test_plain_route_gives_the_same_manifest(runs, tree, tmp_path):  # noqa: F811
    """impl="torch" (the kernels' plain versions) is the same computation
    on the CPU: the same counts and threshold."""
    from mmrs_tpu_torch.lifecycle import run_lifecycle

    _, tm, tcfg, kw = runs
    pm = run_lifecycle(tree[0], str(tmp_path / "plain"), "lychee", cfg=tcfg,
                       impl="torch", **kw)
    assert pm["calibrate"]["best_threshold"] == \
        tm["calibrate"]["best_threshold"]
    for stage in ("union", "cascade", "dedup", "vqa"):
        assert {k: v for k, v in pm[stage].items()
                if not isinstance(v, str)} == \
            {k: v for k, v in tm[stage].items() if not isinstance(v, str)}


def test_cli_lifecycle_flags_and_output(runs, tree, tmp_path, capsys):  # noqa: F811
    from mmrs_tpu.cli.main import build_parser as j_parser
    from mmrs_tpu_torch.cli.main import build_parser, main

    flags = ["lifecycle", "--root", "r", "--out", "o", "--positive-class",
             "lychee", "--shots", "3", "--test-root", "t", "--dedup-tau",
             "0.98", "--seed", "2", "--config", "c.yaml"]
    got = {k: v for k, v in vars(build_parser().parse_args(flags)).items()
           if k != "fn"}
    want = {k: v for k, v in vars(j_parser().parse_args(flags)).items()
            if k != "fn"}
    assert got == want
    _, tm, tcfg, _ = runs
    yaml = tmp_path / "tiny.yaml"     # the run's towers and checkpoint
    yaml.write_text("model:\n  image_tower: vit_tiny\n  dtype: float32\n"
                    f"  checkpoint_path: {tcfg.model.checkpoint_path}\n")
    out = str(tmp_path / "cli")
    with pytest.raises(SystemExit) as e:
        main(["lifecycle", "--root", tree[0], "--out", out,
              "--positive-class", "lychee", "--shots", "4", "--test-root",
              tree[1], "--dedup-tau", "0.9999", "--config", str(yaml)])
    assert e.value.code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {
        "union_en_pass_eq_cascade_gate": True,
        "calibration_rows_eq_index_rows": True, "out": out,
        "index_rows": tm["index"]["rows"],
        "best_threshold": tm["calibrate"]["best_threshold"],
        "union_pass": tm["union"]["union_pass"],
        "gate_passed": tm["cascade"]["gate_passed"],
        "duplicates": tm["dedup"]["duplicates"],
        "vqa_positives": tm["vqa"]["positives"]}
    assert np.isfinite(line["best_threshold"])


def test_clip_tree_round_trips_through_jax(tmp_path):
    """convert_jax.clip_tree (the npz phase 4h's lifecycle loads) writes
    the JAX `clip.init` tree: mmrs_tpu's load_npz reads back its arrays."""
    from mmrs_tpu.models import checkpoint as j_ckpt
    from mmrs_tpu.models import clip as j_clip
    from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
    from mmrs_tpu_torch.models import checkpoint, convert_jax

    params = j_clip.init(jax.random.key(2), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY))
    src = str(tmp_path / "jax.npz")
    j_ckpt.save_npz(params, src)
    from mmrs_tpu_torch.models import configs
    from mmrs_tpu_torch.models.clip import CLIPConfig

    model = convert_jax.load_npz(src, CLIPConfig(
        vision=configs.VIT_TINY, text=configs.CLIP_TEXT_TINY))
    out = str(tmp_path / "port.npz")
    checkpoint.save_npz(convert_jax.clip_tree(model), out)
    back = j_ckpt.load_npz(out)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(
            np.asarray(got[path]).reshape(np.shape(leaf)),
            np.asarray(leaf), err_msg=str(path))
