"""The port's bilingual path — the Taiyi pair (models/bert.py,
models/clip.py's Taiyi half, pipeline.build_towers' `taiyi_roberta`
route), govern/bilingual.py, govern/union_report.py and `mmrs-torch
union` — against mmrs_tpu's.

One tree from `mmrs_tpu.models.clip.taiyi_init` (and one from
`clip.init` for the EN pair), written by mmrs_tpu's save_npz, feeds both
packages. f32 text embeddings agree to 1e-5; the union driver and both
CLIs, on one folder of seeded JPEGs, give the same thresholds, decisions
and report files.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mmrs_tpu import config as j_config
from mmrs_tpu import pipeline as j_pipeline
from mmrs_tpu.cli.main import main as j_main
from mmrs_tpu.govern import bilingual as j_bilingual
from mmrs_tpu.govern import union_report as j_union
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models.configs import CLIP_TEXT_TINY, TAIYI_TINY, VIT_TINY
from mmrs_tpu.models.tokenizer import BertWordPieceTokenizer as JTokenizer
from mmrs_tpu_torch import config, pipeline
from mmrs_tpu_torch.cli.main import main as t_main
from mmrs_tpu_torch.govern import bilingual, union_report
from mmrs_tpu_torch.models import clip, configs, convert_jax
from mmrs_tpu_torch.models.tokenizer import BertWordPieceTokenizer

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "一", "张", "荔", "枝",
         "的", "图", "片", "狗", "猫", "a", "photo", "of", "lychee", "##s"]
J_TAIYI = j_clip.TaiyiCLIPConfig(vision=VIT_TINY, text=TAIYI_TINY)
T_TAIYI = clip.TaiyiCLIPConfig(vision=configs.VIT_TINY,
                               text=configs.TAIYI_TINY)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("bilingual")
    rng = np.random.default_rng(0)
    root = base / "tree"
    for cls, color in (("lychee", (250, 30, 30)), ("other", (30, 30, 250))):
        (root / cls).mkdir(parents=True)
        for i in range(5):
            arr = np.clip(np.full((40, 40, 3), color, int)
                          + rng.integers(0, 60, (40, 40, 3)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(
                root / cls / f"{cls}{i}.jpg")
    cn = str(base / "cn.npz")
    j_checkpoint.save_npz(j_clip.taiyi_init(jax.random.key(3), J_TAIYI), cn)
    en = str(base / "en.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(1), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), en)
    cfg = base / "en.yaml"
    cfg.write_text(f"model:\n  image_tower: vit_tiny\n  dtype: float32\n"
                   f"  checkpoint_path: {en}\n")
    cn_cfg = base / "cn.yaml"
    cn_cfg.write_text(f"model:\n  image_tower: vit_tiny\n"
                      f"  text_tower: taiyi_roberta\n  dtype: float32\n"
                      f"  checkpoint_path: {cn}\n")
    vocab = base / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    merges = base / "merges.txt"
    merges.write_text("#version: 0.2\nl y\nly c\nlyc h\nlych e\nlyche e</w>\n")
    return dict(root=str(root), cn=cn, en=en, cfg=str(cfg),
                cn_cfg=str(cn_cfg), vocab=str(vocab), merges=str(merges),
                base=base)


def _tokens():
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 21128, (4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 7:] = 0
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_taiyi_text_tower_matches_jax(setup, dtype, tol):
    tree = jax.tree.map(np.asarray, j_checkpoint.load_npz(setup["cn"]))
    model = convert_jax.from_jax_taiyi(tree, T_TAIYI)
    ids, mask = _tokens()
    cd = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(j_clip.taiyi_encode_text(
        tree, jnp.asarray(ids), jnp.asarray(mask), J_TAIYI,
        compute_dtype=cd[0]))
    got = clip.taiyi_encode_text(model, torch.from_numpy(ids),
                                 torch.from_numpy(mask), cd[1]).numpy()
    assert got.shape == want.shape == (4, 64)
    np.testing.assert_allclose(got, want, atol=tol)
    # padding: the masked tail does not reach the embedding
    ids2 = ids.copy()
    ids2[0, 7:] = 9
    again = clip.taiyi_encode_text(model, torch.from_numpy(ids2),
                                   torch.from_numpy(mask), cd[1]).numpy()
    np.testing.assert_array_equal(again[0], got[0])


def test_build_towers_taiyi_route_matches_jax(setup):
    tok_j = JTokenizer.from_vocab_file(setup["vocab"])
    tok_t = BertWordPieceTokenizer.from_vocab_file(setup["vocab"])
    j_towers = j_pipeline.build_towers(j_config.load(setup["cn_cfg"]),
                                       tokenizer=tok_j)
    t_towers = pipeline.build_towers(config.load(setup["cn_cfg"]),
                                     tokenizer=tok_t)
    assert isinstance(t_towers.params, clip.TaiyiCLIP)
    texts = ["一张荔枝的图片", "狗", "a photo of lychees"]
    np.testing.assert_allclose(t_towers.text_encode(texts),
                               j_towers.text_encode(texts), atol=1e-5)
    px = np.random.default_rng(1).integers(0, 256, (3, 224, 224, 3),
                                           dtype=np.uint8)
    np.testing.assert_allclose(t_towers.image_encode(px),
                               j_towers.image_encode(px), atol=1e-4)


def test_build_towers_refuses_a_mismatched_taiyi_pair():
    """Taiyi projects to 768-d; ViT-B/32 embeds 512-d: the same message as
    the JAX pipeline's, before any weight is made."""
    model = dict(image_tower="vit_b32", text_tower="taiyi_roberta")
    with pytest.raises(ValueError) as j_err:
        j_pipeline.build_towers(j_config.Config(
            model=j_config.ModelConfig(**model)))
    with pytest.raises(ValueError) as t_err:
        pipeline.build_towers(config.Config(model=config.ModelConfig(
            **model)))
    assert str(t_err.value) == str(j_err.value)


def _color_encoder(pixels_u8):
    x = pixels_u8.astype(np.float32) / 255.0
    f = x.mean(axis=(1, 2))
    f = np.concatenate([f, 0.05 * np.ones((len(f), 3), np.float32)], 1)
    return f / np.linalg.norm(f, axis=1, keepdims=True)


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("thresholds", [(None, None), (0.9, 0.95)])
def test_bilingual_union_matches_jax(setup, tmp_path, thresholds):
    red = np.array([1.0, 0.05, 0.05, 0.0, 0.0, 0.0], np.float32)
    blue = np.array([0.3, 0.05, 1.0, 0.0, 0.0, 0.0], np.float32)
    results = {}
    for name, fn in (("jax", j_bilingual.bilingual_union),
                     ("torch", bilingual.bilingual_union)):
        results[name] = fn(
            setup["root"], "lychee", en_encode=_color_encoder,
            en_text_embed=red, cn_encode=_color_encoder, cn_text_embed=blue,
            out_root=str(tmp_path / name), en_threshold=thresholds[0],
            cn_threshold=thresholds[1], image_size=32, batch_size=3)
    j, t = results["jax"], results["torch"]
    for field in ("cls", "en_threshold", "cn_threshold"):
        assert getattr(t, field) == getattr(j, field)
    for field in ("en_best_f1", "cn_best_f1"):
        a, b = getattr(t, field), getattr(j, field)
        assert a == b or (np.isnan(a) and np.isnan(b))
    assert sorted(t.report.union_basenames) == sorted(j.report.union_basenames)
    assert (t.report.en_pass, t.report.cn_pass, t.report.union_pass) == (
        j.report.en_pass, j.report.cn_pass, j.report.union_pass)
    assert dataclasses.astuple(t.report.metrics) == dataclasses.astuple(
        j.report.metrics)
    assert _files(tmp_path / "torch" / "lychee") == _files(
        tmp_path / "jax" / "lychee")


def test_union_report_matches_jax(setup, tmp_path):
    paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(setup["root"])
                   for f in fs)
    rng = np.random.default_rng(7)
    kw = [dict(path=p, basename=os.path.basename(p),
               is_positive="lychee" in p, en_sim=float(rng.uniform(0, 40)),
               cn_sim=float(rng.uniform(0, 20))) for p in paths]
    reps = {}
    for name, mod in (("jax", j_union), ("torch", union_report)):
        samples = [mod.UnionSample(**k) for k in kw]
        reps[name] = mod.save_union_samples(samples, "lychee", 25.0, 11.0,
                                            str(tmp_path / name))
        reps[name + "_m"] = mod.combined_metrics(samples, 25.0, 11.0)
    assert sorted(reps["torch"].union_basenames) == sorted(
        reps["jax"].union_basenames)
    assert dataclasses.astuple(reps["torch_m"]) == dataclasses.astuple(
        reps["jax_m"])
    assert _files(tmp_path / "torch" / "lychee") == _files(
        tmp_path / "jax" / "lychee")


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    out = capsys.readouterr().out
    assert exit_info.value.code == 0, out
    return out.strip().splitlines()


@pytest.mark.parametrize("given", [False, True])
def test_union_cli_matches_jax(setup, tmp_path, capsys, given):
    """`mmrs-torch union` and `mmrs union` on one folder: EN tiny CLIP
    (--prompt, --merges), CN tiny Taiyi (--cn-checkpoint, --cn-prompt,
    --vocab): the same line and the same report files."""
    lines = {}
    for name, main in (("jax", j_main), ("torch", t_main)):
        argv = ["union", "--root", setup["root"], "--positive-class",
                "lychee", "--out", str(tmp_path / name), "--config",
                setup["cfg"], "--prompt", "a photo of {}", "--merges",
                setup["merges"], "--cn-prompt", "一张荔枝的图片", "--vocab",
                setup["vocab"], "--cn-checkpoint", setup["cn"],
                "--cn-image-tower", "vit_tiny"]
        if given:
            argv += ["--en-threshold", "0.05", "--cn-threshold", "0.02"]
        lines[name] = json.loads(_run(main, argv, capsys)[-1])
    j, t = lines["jax"], lines["torch"]
    assert list(t) == list(j) and t["class"] == "lychee"
    assert t["union_pass"] == j["union_pass"]
    for key in ("en_threshold", "cn_threshold"):
        assert abs(t[key] - j[key]) <= 1e-3
    assert abs(t["f1"] - j["f1"]) <= 1e-9
    t_files = sorted(os.listdir(tmp_path / "torch" / "lychee"))
    assert t_files == sorted(os.listdir(tmp_path / "jax" / "lychee"))


def test_search_with_vocab_reaches_the_taiyi_tower(setup, tmp_path, capsys):
    """`search --text ... --vocab` on a Taiyi index: the same hits as the
    JAX CLI."""
    out = {}
    for name, main in (("jax", j_main), ("torch", t_main)):
        index = str(tmp_path / f"idx_{name}")
        _run(main, ["index", "build", "--root", setup["root"], "--out",
                    index, "--config", setup["cn_cfg"], "--workers", "2"],
             capsys)
        out[name] = [line.split("\t") for line in _run(
            main, ["search", "--index", index, "--text", "一张荔枝的图片",
                   "--vocab", setup["vocab"], "-k", "4", "--config",
                   setup["cn_cfg"]], capsys)]
    assert len(out["torch"]) == len(out["jax"]) == 4
    for t, j in zip(out["torch"], out["jax"]):
        assert t[:2] == j[:2] and t[3:] == j[3:]
        assert abs(float(t[2]) - float(j[2])) <= 1e-3
