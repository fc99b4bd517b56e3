"""The port's weight conversion (models/release.py, models/convert.py,
`mmrs-torch weights convert`) against mmrs_tpu's.

Each input is a state dict the test builds: random HF models that
`transformers` makes from a config written here (CLIP, BERT, a CLIP
vision tower and a LLaMA for LLaVA), an OpenAI-layout dict of seeded
numpy arrays, and a BF16 safetensors file. Both packages convert the same
input; their trees, written by each package's save_npz, must hold the
same members with the same dtypes, shapes and bytes, and the port must
load its npz into its modules.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax

from mmrs_tpu.cli.main import main as j_main
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import configs as j_configs
from mmrs_tpu.models import convert as j_convert
from mmrs_tpu.models import llama as j_llama
from mmrs_tpu.models import llava as j_llava
from mmrs_tpu.models import quantize as j_quantize
from mmrs_tpu.models import release as j_release
from mmrs_tpu_torch.cli.main import main as t_main
from mmrs_tpu_torch.models import checkpoint, convert, convert_jax, release
from mmrs_tpu_torch.models import configs, llama, llava, quantize
from mmrs_tpu_torch.models.clip import (CLIPConfig, TaiyiCLIPConfig,
                                        encode_image, taiyi_encode_text)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


V = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4,
         embed_dim=32)
T = dict(vocab_size=128, context_length=16, width=64, layers=2, heads=4,
         embed_dim=32)
B = dict(vocab_size=200, hidden_size=64, layers=2, heads=4,
         intermediate_size=128, max_position_embeddings=32, num_labels=32)
L = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2, mlp_dim=96)


def _hf_clip_model(seed=0):
    from transformers import CLIPConfig as HFConfig, CLIPModel

    cfg = HFConfig(
        text_config=dict(vocab_size=T["vocab_size"], hidden_size=T["width"],
                         intermediate_size=T["width"] * 4,
                         num_hidden_layers=T["layers"],
                         num_attention_heads=T["heads"],
                         max_position_embeddings=T["context_length"],
                         hidden_act="quick_gelu",
                         eos_token_id=T["vocab_size"] - 1),
        vision_config=dict(hidden_size=V["width"],
                           intermediate_size=V["width"] * 4,
                           num_hidden_layers=V["layers"],
                           num_attention_heads=V["heads"],
                           image_size=V["image_size"],
                           patch_size=V["patch_size"],
                           hidden_act="quick_gelu"),
        projection_dim=V["embed_dim"])
    torch.manual_seed(seed)
    return CLIPModel(cfg).eval(), cfg


def _hf_bert_model(seed=1):
    from transformers import BertConfig as HFBert
    from transformers import BertForSequenceClassification

    cfg = HFBert(vocab_size=B["vocab_size"], hidden_size=B["hidden_size"],
                 num_hidden_layers=B["layers"],
                 num_attention_heads=B["heads"],
                 intermediate_size=B["intermediate_size"],
                 max_position_embeddings=B["max_position_embeddings"],
                 num_labels=B["num_labels"], hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0, classifier_dropout=0.0)
    torch.manual_seed(seed)
    return BertForSequenceClassification(cfg).eval(), cfg


def _np_sd(model):
    return convert.state_dict_to_numpy(model.state_dict())


def _save_pair(tmp_path, j_tree, t_tree, name):
    jp, tp = str(tmp_path / f"{name}_jax.npz"), str(tmp_path / f"{name}.npz")
    j_checkpoint.save_npz(j_tree, jp)
    checkpoint.save_npz(t_tree, tp)
    return jp, tp


def _npz_bit_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            x, y = za[k], zb[k]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), k


def _jcfgs():
    return (j_configs.VITConfig(**V), j_configs.TextConfig(**T),
            j_configs.BertConfig(**B))


def _tcfgs():
    return (configs.VITConfig(**V), configs.TextConfig(**T),
            configs.BertConfig(**B))


# -- the converters --------------------------------------------------------------

def test_hf_clip_converts_to_the_jax_npz_and_loads(tmp_path):
    model, _ = _hf_clip_model()
    sd = _np_sd(model)
    (jv, jt, _), (tv, tt, _) = _jcfgs(), _tcfgs()
    jp, tp = _save_pair(tmp_path, j_convert.hf_clip(sd, jv, jt),
                        convert.hf_clip(sd, tv, tt), "hf_clip")
    _npz_bit_equal(jp, tp)
    clip_model = convert_jax.load_npz(tp, CLIPConfig(vision=tv, text=tt))
    rng = np.random.default_rng(0)
    px = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    with torch.no_grad():
        want = model.get_image_features(pixel_values=px.permute(0, 3, 1, 2))
        want = want / want.norm(dim=-1, keepdim=True)
    got = encode_image(clip_model, px, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def _openai_sd(seed=2):
    """An OpenAI `clip` package state dict (fused in_proj, c_fc / c_proj,
    [W, D] projections) of seeded numpy arrays at the tiny sizes."""
    rng = np.random.default_rng(seed)
    w, tw, d = V["width"], T["width"], V["embed_dim"]

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    sd = {"visual.conv1.weight": r(w, 3, V["patch_size"], V["patch_size"]),
          "visual.class_embedding": r(w),
          "visual.positional_embedding": r(17, w),
          "visual.ln_pre.weight": r(w), "visual.ln_pre.bias": r(w),
          "visual.ln_post.weight": r(w), "visual.ln_post.bias": r(w),
          "visual.proj": r(w, d),
          "token_embedding.weight": r(T["vocab_size"], tw),
          "positional_embedding": r(T["context_length"], tw),
          "ln_final.weight": r(tw), "ln_final.bias": r(tw),
          "text_projection": r(tw, d),
          "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}
    for prefix, width in (("visual.transformer", w), ("transformer", tw)):
        for i in range(2):
            p = f"{prefix}.resblocks.{i}"
            sd.update({
                f"{p}.attn.in_proj_weight": r(3 * width, width),
                f"{p}.attn.in_proj_bias": r(3 * width),
                f"{p}.attn.out_proj.weight": r(width, width),
                f"{p}.attn.out_proj.bias": r(width),
                f"{p}.ln_1.weight": r(width), f"{p}.ln_1.bias": r(width),
                f"{p}.ln_2.weight": r(width), f"{p}.ln_2.bias": r(width),
                f"{p}.mlp.c_fc.weight": r(4 * width, width),
                f"{p}.mlp.c_fc.bias": r(4 * width),
                f"{p}.mlp.c_proj.weight": r(width, 4 * width),
                f"{p}.mlp.c_proj.bias": r(width)})
    return sd


def test_openai_clip_converts_to_the_jax_npz_and_loads(tmp_path):
    sd = _openai_sd()
    (jv, jt, _), (tv, tt, _) = _jcfgs(), _tcfgs()
    jp, tp = _save_pair(tmp_path, j_convert.openai_clip(sd, jv, jt),
                        convert.openai_clip(sd, tv, tt), "openai")
    _npz_bit_equal(jp, tp)
    convert_jax.load_npz(tp, CLIPConfig(vision=tv, text=tt))
    # the config a release archive's shapes give
    assert release.openai_clip_configs(sd) == tuple(
        type(c)(**vars(jc)) for c, jc in zip(
            (tv, tt), j_release.openai_clip_configs(sd)))


def test_taiyi_bert_converts_to_the_jax_npz_and_loads(tmp_path):
    model, _ = _hf_bert_model()
    sd = _np_sd(model)
    jp, tp = _save_pair(tmp_path, j_convert.hf_bert_classifier(sd, _jcfgs()[2]),
                        convert.hf_bert_classifier(sd, _tcfgs()[2]), "taiyi")
    _npz_bit_equal(jp, tp)
    # the Taiyi pair's tree: a ViT, this text tower and a logit scale
    tv = configs.VITConfig(**V)
    vis = convert.hf_clip(_np_sd(_hf_clip_model()[0]), tv,
                          configs.TextConfig(**T))["visual"]
    pair = {"visual": vis, "text": checkpoint.load_npz(tp),
            "logit_scale": np.asarray(2.0, np.float32)}
    checkpoint.save_npz(pair, str(tmp_path / "pair.npz"))
    tai = convert_jax.load_npz(str(tmp_path / "pair.npz"),
                               TaiyiCLIPConfig(vision=tv, text=_tcfgs()[2]))
    tokens = np.random.default_rng(3).integers(1, 200, (3, 12))
    mask = np.ones_like(tokens)
    mask[0, 9:] = 0
    with torch.no_grad():
        want = model(input_ids=torch.from_numpy(tokens),
                     attention_mask=torch.from_numpy(mask)).logits
        want = want / want.norm(dim=-1, keepdim=True)
    got = taiyi_encode_text(tai, torch.from_numpy(tokens),
                            torch.from_numpy(mask), torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-4)


def _llava_sd(layout: str):
    """An HF LLaVA state dict from a random CLIP vision tower and LLaMA:
    the llava-v1.5 release layout, the transformers >= 4.52 layout, or
    the original liuhaotian layout."""
    from transformers import (CLIPVisionConfig, CLIPVisionModel,
                              LlamaConfig as HFLlama, LlamaForCausalLM)

    torch.manual_seed(4)
    vt = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=V["width"], intermediate_size=V["width"] * 4,
        num_hidden_layers=V["layers"], num_attention_heads=V["heads"],
        image_size=V["image_size"], patch_size=V["patch_size"],
        hidden_act="quick_gelu"))
    lm = LlamaForCausalLM(HFLlama(
        vocab_size=L["vocab_size"], hidden_size=L["dim"],
        num_hidden_layers=L["layers"], num_attention_heads=L["heads"],
        num_key_value_heads=L["kv_heads"], intermediate_size=L["mlp_dim"],
        tie_word_embeddings=False))
    rng = np.random.default_rng(5)
    proj = {"linear_1.weight": rng.standard_normal((L["dim"], V["width"])),
            "linear_1.bias": rng.standard_normal(L["dim"]),
            "linear_2.weight": rng.standard_normal((L["dim"], L["dim"])),
            "linear_2.bias": rng.standard_normal(L["dim"])}
    proj = {k: v.astype(np.float32) for k, v in proj.items()}
    vsd, lsd = _np_sd(vt), _np_sd(lm)
    if layout == "release":
        sd = {f"vision_tower.{k}": v for k, v in vsd.items()}
        sd.update({f"language_model.{k}": v for k, v in lsd.items()})
        sd.update({f"multi_modal_projector.{k}": v for k, v in proj.items()})
    elif layout == "hf452":
        sd = {f"model.vision_tower.{k}": v for k, v in vsd.items()}
        sd.update({f"model.language_model.{k[len('model.'):]}": v
                   for k, v in lsd.items() if k.startswith("model.")})
        sd["lm_head.weight"] = lsd["lm_head.weight"]
        sd.update({f"model.multi_modal_projector.{k}": v
                   for k, v in proj.items()})
    else:   # original
        sd = {f"model.vision_tower.vision_tower.{k}": v
              for k, v in vsd.items()}
        sd.update(lsd)
        for i, n in ((0, "linear_1"), (2, "linear_2")):
            for part in ("weight", "bias"):
                sd[f"model.mm_projector.{i}.{part}"] = proj[f"{n}.{part}"]
    return sd


@pytest.mark.parametrize("layout", ["release", "hf452", "original"])
def test_hf_llava_converts_to_the_jax_npz_and_loads(tmp_path, layout):
    sd = _llava_sd(layout)
    j_cfg = j_llava.LLaVAConfig(vision=j_configs.VITConfig(**V),
                                lm=j_llama.LlamaConfig(**L))
    t_cfg = llava.LLaVAConfig(vision=configs.VITConfig(**V),
                              lm=llama.LlamaConfig(**L))
    if layout == "original":
        trees = (j_release.original_llava(sd, j_cfg),
                 release.original_llava(sd, t_cfg))
    else:
        trees = (j_llava.hf_llava(sd, j_cfg), convert.hf_llava(sd, t_cfg))
    jp, tp = _save_pair(tmp_path, *trees, f"llava_{layout}")
    _npz_bit_equal(jp, tp)
    model = convert_jax.from_jax_llava(checkpoint.load_npz(tp), t_cfg)
    torch.testing.assert_close(model.lm.lm_head.weight.T,
                               torch.from_numpy(sd[
                                   "lm_head.weight" if layout != "release"
                                   else "language_model.lm_head.weight"]).T)
    # int8 serving weights: the same codes and scales as the JAX package's
    jq, tq = _save_pair(tmp_path, j_quantize.quantize_llava(trees[0]),
                        quantize.quantize_llava_tree(trees[1]),
                        f"llava_{layout}_int8")
    _npz_bit_equal(jq, tq)
    convert_jax.from_jax_llava(checkpoint.load_npz(tq), t_cfg)


def _write_bf16_safetensors(path, sd):
    """A BF16 safetensors file (the writer takes no BF16: bits by hand)."""
    header, blobs, off = {}, [], 0
    for name, arr in sd.items():
        bits = torch.from_numpy(np.ascontiguousarray(arr)).to(
            torch.bfloat16).view(torch.int16).numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(arr.shape),
                        "data_offsets": [off, off + len(bits)]}
        blobs.append(bits)
        off += len(bits)
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + b"".join(blobs))


def test_bf16_safetensors_read_and_convert_as_jax(tmp_path):
    sd = _np_sd(_hf_clip_model(seed=5)[0])
    path = str(tmp_path / "model.safetensors")
    _write_bf16_safetensors(path, sd)
    j_sd, t_sd = j_release.read_safetensors(path), release.read_safetensors(
        path)
    assert sorted(j_sd) == sorted(t_sd)
    for k in j_sd:
        assert t_sd[k].dtype == j_sd[k].dtype == np.float32
        assert t_sd[k].tobytes() == j_sd[k].tobytes(), k
    (jv, jt, _), (tv, tt, _) = _jcfgs(), _tcfgs()
    _npz_bit_equal(*_save_pair(tmp_path, j_convert.hf_clip(j_sd, jv, jt),
                               convert.hf_clip(t_sd, tv, tt), "bf16"))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int64,
                                   np.int8, np.uint8, np.bool_])
def test_safetensors_round_trip_matches_jax(tmp_path, dtype):
    rng = np.random.default_rng(6)
    arr = (rng.standard_normal((3, 5)) * 10).astype(dtype)
    path = str(tmp_path / "t.safetensors")
    release.write_safetensors(path, {"a": arr, "b": arr[:1]})
    j_path = str(tmp_path / "j.safetensors")
    j_release.write_safetensors(j_path, {"a": arr, "b": arr[:1]})
    assert open(path, "rb").read() == open(j_path, "rb").read()
    got = release.read_safetensors(path)
    want = j_release.read_safetensors(path)
    for k in ("a", "b"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


def _hf_dir(tmp_path, name, model, cfg):
    d = tmp_path / name
    d.mkdir()
    cj = cfg.to_dict()
    cj["architectures"] = [type(model).__name__]
    (d / "config.json").write_text(json.dumps(cj))
    release.write_safetensors(str(d / "model.safetensors"), _np_sd(model))
    (d / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    return str(d)


@pytest.mark.parametrize("which", ["hf_clip", "taiyi_bert"])
def test_load_release_model_matches_jax(tmp_path, which):
    model, cfg = _hf_clip_model() if which == "hf_clip" else _hf_bert_model()
    d = _hf_dir(tmp_path, which, model, cfg)
    assert release.detect_layout(d) == j_release.detect_layout(d) == which
    got, want = release.load_release_model(d), j_release.load_release_model(d)
    assert got.kind == want.kind and got.extras == want.extras
    _npz_bit_equal(*_save_pair(tmp_path, want.params, got.params, which))


# -- `mmrs-torch weights convert` -------------------------------------------------

def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as exit_info:
        main(argv)
    cap = capsys.readouterr()
    return exit_info.value.code, cap.out.strip(), cap.err.strip()


@pytest.mark.parametrize("argv", [
    ["--source", "hf_llava", "--arch", "b32"],
    ["--source", "hf_clip", "--arch", "7b"],
    ["--source", "taiyi", "--arch", "l14", "--int8"],
])
def test_weights_convert_checks_flags_before_loading(tmp_path, capsys, argv):
    """A bad flag is refused with the JAX CLI's message before the input
    (here a path that does not exist) is read."""
    args = ["weights", "convert", *argv, "--input",
            str(tmp_path / "missing.bin"), "--out", str(tmp_path / "o.npz")]
    j_rc, j_out, j_err = _run(j_main, args, capsys)
    t_rc, t_out, t_err = _run(t_main, args, capsys)
    assert t_rc == j_rc == 2 and (t_out, t_err) == (j_out, j_err)
    assert not os.path.exists(tmp_path / "o.npz")


@pytest.mark.parametrize("int8", [False, True])
def test_weights_convert_cli_matches_jax(tmp_path, capsys, monkeypatch,
                                         int8):
    """Both CLIs on one HF CLIP safetensors file, with --arch b32 pointed
    at the tiny sizes: the same line, bit-equal npz; --int8 through each
    package's quantizer."""
    for mod, vcls, tcls in ((j_configs, j_configs.VITConfig,
                             j_configs.TextConfig),
                            (configs, configs.VITConfig, configs.TextConfig)):
        monkeypatch.setattr(mod, "VIT_B32", vcls(**V))
        monkeypatch.setattr(mod, "CLIP_TEXT_B32", tcls(**T))
    src = str(tmp_path / "clip.safetensors")
    release.write_safetensors(src, _np_sd(_hf_clip_model(seed=7)[0]))
    outs = {}
    for name, main in (("jax", j_main), ("torch", t_main)):
        out = str(tmp_path / f"{name}.npz")
        rc, line, _ = _run(main, ["weights", "convert", "--source", "hf_clip",
                                  "--arch", "b32", "--input", src, "--out",
                                  out] + (["--int8"] if int8 else []), capsys)
        assert rc == 0
        outs[name] = json.loads(line)
        assert outs[name] == {"out": out, "int8": int8}
    _npz_bit_equal(str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz"))
    tree = checkpoint.load_npz(str(tmp_path / "torch.npz"))
    assert isinstance(tree["visual"]["blocks"]["mlp"]["w1"],
                      checkpoint.QWeight) == int8
    convert_jax.from_jax_params(tree, CLIPConfig(
        vision=configs.VITConfig(**V), text=configs.TextConfig(**T)))


def test_quantize_tree_equals_jax_quantize_weight():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    w[0, :, 5] = 0.0                      # an all-zero channel: scale 1e-12/127
    w[1, 3, 7] = 127.0 * 2.5               # rounding ties
    got = quantize.quantize_weight(w)
    want = jax.tree.map(np.asarray, j_quantize.quantize_tree({"wq": w})["wq"])
    assert got.q.numpy().tobytes() == want.q.tobytes()
    assert got.s.numpy().tobytes() == want.s.tobytes()
