"""The port's parity gates (mmrs_tpu_torch/eval/parity.py, `mmrs-torch
parity`) against mmrs_tpu's (tests/test_parity.py, tests/test_release.py).

The rank gate draws its gallery from numpy's seeded rng as JAX's does, so
both packages see the same rows: counts, flips and violations are equal
(the bf16 top-k is the port's plain K1 here, JAX's XLA form there). The
goldens, the smoke check and threshold parity are the same values and
logic. The int8 tower gate on one converted vit_tiny tree and the same
images agrees with JAX's within 1e-4. The three tokenizer differentials
run on tiny vocab files written here and report what JAX's report (a
missing `transformers` is recorded as a skip by both). The drop-in release gate over one OpenAI
archive pack and over an HF CLIP + Taiyi pack finds the same artifacts
and, on the same weights, the same smoke probabilities and calibrated
threshold within 1e-4 / 1e-3.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mmrs_tpu.eval import parity as j_parity
from mmrs_tpu_torch.eval import parity as t_parity
from test_release import (module_from_flat, openai_flat_state,  # noqa: E402
                          write_bpe_gz, write_sp_model)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _fields(r):
    return (r.n, r.queries, r.k, r.exact_queries, r.tie_flips, r.violations,
            r.planted_exact, r.ok)


@pytest.mark.parametrize("kw", [
    dict(n=20_000, d=512, queries=16, k=10, planted=4),
    dict(n=20_000, d=128, queries=16, k=10, planted=0, tie_tol=0.0),
    dict(n=20_000, d=256, queries=8, k=16, planted=2, seed=3),
])
def test_rank_gate_equals_jax(kw):
    want = j_parity.rank_parity_report(impl="xla", **kw)
    got = t_parity.rank_parity_report(**kw)
    assert _fields(got) == _fields(want)
    assert got.max_tie_gap == pytest.approx(want.max_tie_gap, abs=1e-6)
    if kw.get("tie_tol") == 0.0:        # a gate that can fail does
        assert got.violations > 0 and not got.ok
    else:
        assert got.ok and got.planted_exact is not False
    # the plain route asked for by name is the same answer on the CPU
    assert _fields(t_parity.rank_parity_report(impl="torch", **kw)) == \
        _fields(want)


def test_goldens_smoke_check_and_threshold_parity_equal_jax():
    for name in ("GOLDEN_SMOKE_PROBS", "GOLDEN_SMOKE_TEXTS",
                 "GOLDEN_EN_LYCHEE", "GOLDEN_CN_LYCHEE", "BF16_EPS",
                 "DIFFERENTIAL_TEXTS", "DIFFERENTIAL_TEXTS_CN"):
        assert getattr(t_parity, name) == getattr(j_parity, name), name
    for probs in (np.asarray(j_parity.GOLDEN_SMOKE_PROBS, np.float32),
                  np.asarray([0.5, 0.3, 0.2], np.float32),
                  np.asarray([0.99, 0.006, 0.004], np.float32)):
        a, b = t_parity.check_smoke(probs), j_parity.check_smoke(probs)
        assert (a.ok, a.max_abs_diff, a.golden) == \
            (b.ok, b.max_abs_diff, b.golden)
    from mmrs_tpu_torch.search.calibrate import find_thresholds

    rng = np.random.default_rng(0)
    pos = rng.normal(28.0, 0.2, 200).astype(np.float32)
    neg = rng.normal(20.0, 2.0, 400).astype(np.float32)
    res = find_thresholds(pos, neg)
    for gold in (j_parity.GOLDEN_CN_LYCHEE, j_parity.GOLDEN_EN_LYCHEE,
                 {"threshold": res.best_threshold, "f1": res.best_f1}):
        assert t_parity.threshold_parity(res, gold) == \
            j_parity.threshold_parity(res, gold)
    assert t_parity.threshold_parity(
        res, {"threshold": res.best_threshold, "f1": res.best_f1})["ok"]


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    """One vit_tiny CLIP tree from mmrs_tpu's init, written by its
    save_npz, loaded by both packages."""
    from mmrs_tpu.models import checkpoint as j_ckpt
    from mmrs_tpu.models import clip as j_clip
    from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY

    ccfg = j_clip.CLIPConfig(vision=VIT_TINY, text=CLIP_TEXT_TINY)
    params = j_clip.init(jax.random.key(0), ccfg)
    path = str(tmp_path_factory.mktemp("parity") / "tiny.npz")
    j_ckpt.save_npz(params, path)
    return path, j_ckpt.load_npz(path), ccfg


def _t_cfg():
    from mmrs_tpu_torch.models import configs
    from mmrs_tpu_torch.models.clip import CLIPConfig

    return CLIPConfig(vision=configs.VIT_TINY, text=configs.CLIP_TEXT_TINY)


def test_int8_geometry_gate_matches_jax(tiny_tree):
    from mmrs_tpu_torch.models import convert_jax

    path, params, jcfg = tiny_tree
    want = j_parity.int8_geometry_gate(params, jcfg)
    size = jcfg.vision.image_size
    imgs = np.asarray(jax.random.normal(jax.random.key(1),
                                        (16, size, size, 3)) * 0.5)
    gal = np.asarray(jax.random.normal(jax.random.key(2),
                                       (1000, jcfg.vision.embed_dim)))
    model = convert_jax.load_npz(path, _t_cfg())
    got = t_parity.int8_geometry_gate(model, _t_cfg(), images=imgs,
                                      gallery=gal)
    assert got["min_cosine_vs_f32"] == pytest.approx(
        want["min_cosine_vs_f32"], abs=1e-4)
    assert got["top1_agreement"] == want["top1_agreement"]
    assert got["ok"] == want["ok"]
    # the weights were not quantized in place (the gate quantizes a copy)
    from mmrs_tpu_torch.models.layers import QLinear

    assert not any(isinstance(m, QLinear) for m in model.modules())
    # its own seeded inputs, and the plain route on them: the same answer
    # on the CPU
    a = t_parity.int8_geometry_gate(model, _t_cfg())
    b = t_parity.int8_geometry_gate(model, _t_cfg(), impl="torch")
    assert a == b and set(a) == {"min_cosine_vs_f32", "top1_agreement",
                                 "ok"}
    imgs2, gal2 = t_parity.gate_inputs(_t_cfg())
    assert imgs2.shape == (16, size, size, 3) and gal2.shape == (1000, 64)


def test_smoke_probs_match_jax(tiny_tree, tmp_path):
    from mmrs_tpu import config as j_config
    from mmrs_tpu import pipeline as j_pipeline
    from mmrs_tpu.models.tokenizer import CLIPTokenizer as JTok
    from mmrs_tpu_torch import config, pipeline
    from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer

    path = tiny_tree[0]
    words = ["diagram", "dog", "cat"]
    jc = j_config.Config()
    jc.model.image_tower, jc.model.dtype = "vit_tiny", "float32"
    jc.model.checkpoint_path = path
    tc = config.Config()
    tc.model.image_tower, tc.model.dtype = "vit_tiny", "float32"
    tc.model.checkpoint_path = path
    img = str(tmp_path / "clip.png")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (48, 64, 3)).astype(np.uint8)).save(img)
    want = j_parity.smoke_probs(j_pipeline.build_towers(
        jc, tokenizer=JTok.synthetic(words)), img)
    got = t_parity.smoke_probs(pipeline.build_towers(
        tc, tokenizer=CLIPTokenizer.synthetic(words)), img)
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.sum() == pytest.approx(1.0, abs=1e-5)


def _bert_vocab(path):
    chars = sorted(set("一张荔枝的图片吉他羽毛球拍包子恤中文abcdefghijklm"
                       "nopqrstuvwxyz0123456789"))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + chars + ["##" + c for c in chars
                                     if not 0x4E00 <= ord(c) <= 0x9FFF]))


def test_tokenizer_differentials_equal_jax(tmp_path):
    bpe = str(tmp_path / "bpe_simple_vocab_16e6.txt.gz")
    write_bpe_gz(bpe)
    sp = str(tmp_path / "tokenizer.model")
    write_sp_model(sp)
    vocab = str(tmp_path / "vocab.txt")
    _bert_vocab(vocab)
    for fn, arg in (("clip_bpe_differential", bpe), ("sp_differential", sp),
                    ("bert_vocab_differential", vocab)):
        got = getattr(t_parity, fn)(arg)
        want = getattr(j_parity, fn)(arg)
        assert got == want, fn
        assert got["ok"] and got["checked"] > 0, (fn, got)


def test_differentials_report_a_missing_oracle(tmp_path, monkeypatch):
    """Without `transformers` (the card machine) a differential records
    why it did not run, and the gate's other sections go on."""
    import builtins

    real = builtins.__import__

    def no_hf(name, *a, **k):
        if name.split(".")[0] in ("transformers", "tokenizers"):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_hf)
    bpe = str(tmp_path / "bpe_simple_vocab_16e6.txt.gz")
    write_bpe_gz(bpe)
    vocab = str(tmp_path / "vocab.txt")
    _bert_vocab(vocab)
    for out in (t_parity.clip_bpe_differential(bpe),
                t_parity.bert_vocab_differential(vocab)):
        assert out["ok"] and out["checked"] == 0
        assert "transformers" in out["skipped"]


@pytest.fixture(scope="module")
def openai_pack(tmp_path_factory):
    d = tmp_path_factory.mktemp("openai_pack")
    path = str(d / "ViT-B-32.pt")
    torch.jit.save(torch.jit.script(module_from_flat(openai_flat_state())),
                   path)
    write_bpe_gz(str(d / "bpe_simple_vocab_16e6.txt.gz"))
    img = str(tmp_path_factory.mktemp("img") / "CLIP.png")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (48, 64, 3)).astype(np.uint8)).save(img)
    return str(d), path, img


def test_release_gate_matches_jax(openai_pack):
    pack, pt, img = openai_pack
    want = j_parity.release_gate(pack, image=img)
    got = t_parity.release_gate(pack, image=img)
    assert got["found_models"] == want["found_models"] == {
        "openai_clip": pt}
    assert got["found_tokenizers"] == want["found_tokenizers"]
    assert got["loaded"]["openai_clip"]["path"] == pt
    np.testing.assert_allclose(got["smoke"]["probs"],
                               want["smoke"]["probs"], atol=1e-4)
    assert sum(got["smoke"]["probs"]) == pytest.approx(1.0, abs=1e-5)
    assert got["smoke"]["ok"] is want["smoke"]["ok"] is False
    assert got["clip_bpe_differential"] == want["clip_bpe_differential"]
    assert set(got["int8_tower"]) == set(want["int8_tower"])
    assert got["ok"] is want["ok"] is False
    # no EN tower: --image is recorded as skipped, not dropped
    empty = os.path.dirname(img)
    rep = t_parity.release_gate(empty, image=img)
    assert rep["smoke"] == {"skipped": "no EN CLIP tower in pack"}
    assert rep["ok"] is False


@pytest.fixture(scope="module")
def cn_pack(tmp_path_factory):
    """An HF CLIP dir (MLPs 4x wide, as every released CLIP's and as the
    port's towers hold them) and a Taiyi BertForSequenceClassification dir
    with its vocab.txt (tests/test_release.py's layouts), and two folders
    of labeled images."""
    transformers = pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("cn_pack")
    cfg = transformers.CLIPConfig(
        projection_dim=16,
        vision_config={"hidden_size": 64, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "image_size": 32,
                       "patch_size": 16, "intermediate_size": 256,
                       "hidden_act": "quick_gelu"},
        text_config={"hidden_size": 48, "num_hidden_layers": 2,
                     "num_attention_heads": 4, "vocab_size": 200,
                     "max_position_embeddings": 24,
                     "intermediate_size": 192, "hidden_act": "quick_gelu"})
    torch.manual_seed(0)
    transformers.CLIPModel(cfg).save_pretrained(str(root / "clip-tiny"))
    bcfg = transformers.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, num_labels=16)
    tdir = root / "Taiyi-tiny"
    transformers.BertForSequenceClassification(bcfg).save_pretrained(
        str(tdir), safe_serialization=False)
    _bert_vocab(str(tdir / "vocab.txt"))
    rng = np.random.default_rng(1)
    dirs = {}
    for name, color in (("pos", (220, 40, 60)), ("neg", (40, 60, 220))):
        d = tmp_path_factory.mktemp(name)
        for i in range(6):
            arr = np.clip(np.full((40, 40, 3), color, int)
                          + rng.integers(-40, 40, (40, 40, 3)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(d / f"{name}{i}.jpg")
        dirs[name] = str(d)
    return str(root), dirs


def test_release_gate_cn_threshold_matches_jax(cn_pack):
    pack, dirs = cn_pack
    kw = dict(pos_dir=dirs["pos"], neg_dir=dirs["neg"], prompt="一张荔枝的图片",
              golden="cn")
    want = j_parity.release_gate(pack, **kw)
    got = t_parity.release_gate(pack, **kw)
    assert got["found_models"] == want["found_models"]
    assert set(got["found_models"]) == {"hf_clip", "taiyi_bert"}
    assert got["loaded"]["cn_pair"] == want["loaded"]["cn_pair"]
    assert got["bert_vocab_differential"] == \
        want["bert_vocab_differential"]
    g, w = got["threshold"], want["threshold"]
    assert g["best_threshold"] == pytest.approx(w["best_threshold"],
                                                abs=1e-3)
    assert g["best_f1"] == pytest.approx(w["best_f1"], abs=1e-6)
    assert (g["threshold_ok"], g["f1_ok"], g["ok"]) == \
        (w["threshold_ok"], w["f1_ok"], w["ok"])
    assert "int8_tower" not in got and "int8_tower" not in want


def test_release_gate_llava_section_and_smoke(tmp_path):
    """A llava-v1.5 pack in the original layout (sharded bins, config.json,
    tokenizer.model): the structural section equals JAX's, and
    --llava-smoke decodes an answer through the port's LLaVAVerifier."""
    from test_release import llava_original_flat, write_sharded_bins

    d = tmp_path / "llava-v1.5-tiny"
    d.mkdir()
    write_sharded_bins(str(d), llava_original_flat(), n_shards=2)
    (d / "config.json").write_text(json.dumps({
        "model_type": "llava", "architectures": ["LlavaLlamaForCausalLM"],
        "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 64,
        "vocab_size": 300, "max_position_embeddings": 512,
        "rms_norm_eps": 1e-5, "mm_hidden_size": 48}))
    write_sp_model(str(d / "tokenizer.model"))
    img = str(tmp_path / "img.png")
    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (20, 24, 3)).astype(np.uint8)).save(img)
    want = j_parity.release_gate(str(tmp_path))
    got = t_parity.release_gate(str(tmp_path), image=img, llava_smoke=True)
    assert got["found_models"] == want["found_models"] == {"llava": str(d)}
    assert "sp_differential" in got
    sec = dict(got["llava"])
    answer = sec.pop("smoke_answer")
    assert isinstance(answer, str)
    assert sec.pop("smoke_parsed_yes") == ("yes" in answer.lower())
    assert sec == want["llava"]
    assert sec["lm_dim"] == 32 and sec["n_params"] > 0


def _cli_json(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, json.loads(capsys.readouterr().out)


def test_cli_parity_matches_jax(capsys, tiny_tree, openai_pack):
    from mmrs_tpu.cli.main import main as j_main
    from mmrs_tpu_torch.cli.main import build_parser, main as t_main

    argv = ["parity", "--rank-gate", "--rows", "20000", "--queries", "8"]
    jc, jout = _cli_json(j_main, argv, capsys)
    tc, tout = _cli_json(t_main, argv, capsys)
    assert (tc, tout) == (jc, jout) == (0, tout)
    assert tout["rank_gate"]["violations"] == 0 and tout["ok"] is True

    code, out = _cli_json(t_main, ["parity", "--int8-tower", "vit_tiny",
                                   "--checkpoint", tiny_tree[0]], capsys)
    assert out["int8_tower"]["tower"] == "vit_tiny"
    assert set(out["int8_tower"]) == {"tower", "min_cosine_vs_f32",
                                      "top1_agreement", "ok"}
    assert code == (0 if out["ok"] else 1)

    pack, _, img = openai_pack
    code, out = _cli_json(t_main, ["parity", "--release", pack, "--image",
                                   img], capsys)
    assert code == 1 and out["release"]["smoke"]["ok"] is False

    with pytest.raises(SystemExit) as e:
        t_main(["parity"])
    assert e.value.code == 2
    # every flag of the JAX parser parses the same way
    flags = ["parity", "--release", "R", "--llava-smoke", "--rank-gate",
             "--int8-tower", "vit_b32", "--rows", "7", "--queries", "3",
             "--k", "5", "--checkpoint", "c.npz", "--image", "i.png",
             "--merges", "m", "--vocab", "v", "--pos-dir", "p",
             "--neg-dir", "n", "--prompt", "a photo", "--golden", "cn",
             "--config", "c.yaml"]
    from mmrs_tpu.cli.main import build_parser as j_parser

    want = vars(j_parser().parse_args(flags))
    got = vars(build_parser().parse_args(flags))
    assert {k: v for k, v in got.items() if k != "fn"} == \
        {k: v for k, v in want.items() if k != "fn"}
