"""The port's cascade: LLaVAVerifier (cascade/verifier.py), the pipeline and
its journal (cascade/pipeline.py), search/metrics and `mmrs-torch cascade`,
against mmrs_tpu's TPULLaVAVerifier, CascadePipeline and `mmrs cascade`.

A tiny random LLaVA (one JAX tree for both packages, f32) with a toy
tokenizer verifies seeded JPEGs; generated text must be equal, on the
port's einsum route against JAX's XLA form and on its kernel route (the
K10/K11 plain versions) against JAX's Pallas kernels in interpret mode.
The CLIs run on one tiny image tree with one f32 CLIP checkpoint: the
count and metric lines are equal, the audit CSV's scores within 1e-5.
"""

import csv

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mmrs_tpu.cascade import pipeline as j_pipeline
from mmrs_tpu.cascade import verifier as j_verifier
from mmrs_tpu.cli.main import main as j_main
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models import llava as j_llava
from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
from mmrs_tpu.models.configs import VITConfig as JVITConfig
from mmrs_tpu.models.llama import LlamaConfig as JLlamaConfig
from mmrs_tpu.ops import decode_attention as j_da
from mmrs_tpu.search import metrics as j_metrics
from mmrs_tpu_torch.cascade import pipeline as t_pipeline
from mmrs_tpu_torch.cascade import verifier as t_verifier
from mmrs_tpu_torch.cli.main import main as t_main
from mmrs_tpu_torch.models import convert_jax
from mmrs_tpu_torch.models import llava as t_llava
from mmrs_tpu_torch.models.configs import VITConfig
from mmrs_tpu_torch.models.llama import LlamaConfig
from mmrs_tpu_torch.search import metrics as t_metrics

torch.set_num_threads(2)

J_CFG = j_llava.LLaVAConfig(
    vision=JVITConfig(image_size=32, patch_size=8, width=48, layers=2,
                      heads=4, embed_dim=32),
    lm=JLlamaConfig(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2,
                    mlp_dim=128, max_seq=128))
J_DRAFT = j_llava.LLaVAConfig(
    vision=JVITConfig(image_size=32, patch_size=8, width=32, layers=1,
                      heads=2, embed_dim=16),
    lm=JLlamaConfig(vocab_size=128, dim=32, layers=1, heads=2, kv_heads=1,
                    mlp_dim=64, max_seq=128))


def _t_cfg(cfg):
    return t_llava.LLaVAConfig(vision=VITConfig(**cfg.vision.__dict__),
                               lm=LlamaConfig(**cfg.lm.__dict__))


class ToyTokenizer:
    """Char-level tokenizer (mmrs_tpu's test_tpu_verifier): ids 3..62;
    decode maps every id to a letter, with 'y' -> "yes" for a few ids."""

    def encode(self, text, add_bos=True):
        ids = [3 + (ord(c) % 60) for c in text][:12]
        return ([1] + ids) if add_bos else ids

    def decode(self, ids):
        return "".join("yes " if i % 7 == 0 else chr(97 + i % 26)
                       for i in ids)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def vlm(tmp_path_factory):
    params = j_llava.init(jax.random.key(0), J_CFG)
    dparams = j_llava.init(jax.random.key(5), J_DRAFT)
    conv = (lambda tree, cfg: convert_jax.from_jax_llava(
        jax.tree.map(np.asarray, tree), _t_cfg(cfg)))
    d = tmp_path_factory.mktemp("imgs")
    paths = []
    for i, val in enumerate((128, 30, 200, 77)):
        rng = np.random.default_rng(i)
        arr = np.clip(val + rng.integers(-40, 40, (40, 40, 3)), 0, 255)
        p = d / f"q{i}.jpg"
        Image.fromarray(arr.astype(np.uint8)).save(p)
        paths.append(str(p))
    return params, dparams, conv(params, J_CFG), conv(dparams, J_DRAFT), paths


KW = dict(max_new_tokens=4, eos_token=-1, image_size=32)


def _pair(vlm, route, monkeypatch, **extra):
    """(JAX verifier, port verifier) on the same weights and route."""
    params, dparams, model, dmodel, _ = vlm
    tok = ToyTokenizer()
    j_kw, t_kw = dict(KW), dict(KW)
    if route == "auto":
        for name in ("decode_attention", "chunk_attention"):
            orig = getattr(j_da, name)
            monkeypatch.setattr(j_da, name, lambda *a, _f=orig, **kw: _f(
                *a, interpret=True, **kw))
        j_kw.update(decode_attn="pallas", prefill_attn="pallas",
                    layers="fori")
    if extra.get("draft"):
        j_kw.update(draft_params=dparams, draft_cfg=J_DRAFT, draft_tokens=2)
        t_kw.update(draft_params=dmodel, draft_cfg=dmodel.cfg,
                    draft_tokens=2)
    jv = j_verifier.TPULLaVAVerifier(params, J_CFG, tok,
                                     compute_dtype=jnp.float32, **j_kw)
    tv = t_verifier.LLaVAVerifier(model, model.cfg, tok,
                                  compute_dtype=torch.float32, attn=route,
                                  **t_kw)
    return jv, tv


def test_prompt_constants_and_parse():
    for name in ("DEFAULT_PROMPT", "STRICT_PROMPT", "LLAVA_V1_SYSTEM",
                 "LLAVA_V15_PRE", "LLAVA_V15_POST"):
        assert getattr(t_verifier, name) == getattr(j_verifier, name)
    assert t_verifier.llava_v1_prompt_parts("Is it a cat?") == \
        j_verifier.llava_v1_prompt_parts("Is it a cat?")
    for out in ("Yes.", "no", "YES it is", "", "eyes"):
        assert t_verifier.parse_yes_no(out) == j_verifier.parse_yes_no(out)
    cv = t_verifier.CallableVerifier(lambda p, q: "yes" if "cat" in q else
                                     "no")
    assert cv.verify("x.jpg", "cat") and not cv.verify("x.jpg", "dog")
    stub = t_verifier.StubVerifier({"a.jpg": False})
    assert not stub.verify("a.jpg", "c") and stub.verify("b.jpg", "c")


def test_prompt_ids_bos_only_on_the_pre_image_chunk(vlm, monkeypatch):
    jv, tv = _pair(vlm, "einsum", monkeypatch)
    pre, post = tv._prompt_ids("q?")
    assert (pre, post) == jv._prompt_ids("q?")
    assert pre[0] == 1 and post[0] != 1


@pytest.mark.parametrize("route", ["einsum", "auto"])
def test_generate_text_and_verify_batch_equal_jax(vlm, monkeypatch, route):
    *_, paths = vlm
    jv, tv = _pair(vlm, route, monkeypatch)
    q = "Does this image contain a cat?"
    assert tv.generate_text(paths[0], q) == jv.generate_text(paths[0], q)
    want = jv.verify_batch(paths[:3], "cat", fixed_batch=4)
    assert tv.verify_batch(paths[:3], "cat", fixed_batch=4) == want
    # the batch decode gives each image's own sequential answer
    assert [tv.verify(p, "cat") for p in paths[:3]] == want
    assert tv.verify_batch([], "cat") == []
    with pytest.raises(ValueError, match="fixed_batch"):
        tv.verify_batch(paths, "cat", fixed_batch=2)


def test_draft_verifier_equals_plain_and_jax(vlm, monkeypatch):
    """Speculative decode through the verifier: the plain verifier's text
    and answers, JAX's speculative counters."""
    *_, paths = vlm
    jv, tv = _pair(vlm, "einsum", monkeypatch, draft=True)
    _, plain = _pair(vlm, "einsum", monkeypatch)
    q = "Does this image contain a cat?"
    assert tv.generate_text(paths[1], q) == plain.generate_text(paths[1], q)
    assert tv.verify_batch(paths, "cat") == jv.verify_batch(paths, "cat")
    jv.generate_text(paths[1], q)
    assert tv.speculative_stats() == jv.speculative_stats()
    assert plain.speculative_stats() is None
    assert t_verifier.speculative_stats_of(tv)["rounds"] > 0


# -- the verifier on a mesh (parallel/vlm.py) ---------------------------------

def _meshes(dp=2, tp=2):
    """(JAX mesh over its CPU devices, the port's over CPU entries)."""
    from jax.sharding import Mesh as JMesh

    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.parallel.mesh import make_mesh

    jm = JMesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
               (DATA_AXIS, MODEL_AXIS))
    return jm, make_mesh(MeshConfig(data_size=dp, model_size=tp),
                         [torch.device("cpu")] * (dp * tp))


def test_tp_verifier_equals_one_device_and_jax(vlm):
    """mesh= (2x2) hosts the decoder tensor-parallel, the tower once a data
    row: text and answers equal the one-device verifier's and JAX's meshed
    verifier's; an odd batch is padded to the data axis and a single
    generate_text row tiled over it."""
    params, _, model, _, paths = vlm
    tok = ToyTokenizer()
    jm, tm = _meshes()
    jv = j_verifier.TPULLaVAVerifier(params, J_CFG, tok,
                                     compute_dtype=jnp.float32, mesh=jm,
                                     **KW)
    one = t_verifier.LLaVAVerifier(model, model.cfg, tok,
                                   compute_dtype=torch.float32, **KW)
    tv = t_verifier.LLaVAVerifier(model, model.cfg, tok,
                                  compute_dtype=torch.float32, mesh=tm, **KW)
    q = "Does this image contain a cat?"
    want = one.generate_text(paths[0], q)
    assert tv.generate_text(paths[0], q) == want == jv.generate_text(
        paths[0], q)
    want = one.verify_batch(paths[:3], "cat")
    assert tv.verify_batch(paths[:3], "cat") == want == jv.verify_batch(
        paths[:3], "cat")
    handle = tv.verify_batch_async(paths[:3], "cat")
    assert handle[0].shape[0] == 4 and handle[2] == 3
    assert tv._data_size() == 2 and one._data_size() == 1


def test_tp_verifier_draft_is_replicated_or_sharded(vlm):
    """A draft whose kv_heads=1 cannot split the model axis is replicated
    (shard_draft picks False); shard_draft=True on it raises; the text is
    the plain verifier's either way, and the speculative stats are
    recorded as on one device (JAX's on its mesh)."""
    params, dparams, model, dmodel, paths = vlm
    tok = ToyTokenizer()
    jm, tm = _meshes()
    kw = dict(KW, draft_tokens=2)
    tv = t_verifier.LLaVAVerifier(model, model.cfg, tok,
                                  compute_dtype=torch.float32, mesh=tm,
                                  draft_params=dmodel, draft_cfg=dmodel.cfg,
                                  **kw)
    assert tv.shard_draft is False
    one = t_verifier.LLaVAVerifier(model, model.cfg, tok,
                                   compute_dtype=torch.float32, **KW)
    q = "Does this image contain a cat?"
    assert tv.generate_text(paths[1], q) == one.generate_text(paths[1], q)
    jv = j_verifier.TPULLaVAVerifier(params, J_CFG, tok,
                                     compute_dtype=jnp.float32, mesh=jm,
                                     draft_params=dparams, draft_cfg=J_DRAFT,
                                     **kw)
    jv.generate_text(paths[1], q)
    assert tv.speculative_stats() == jv.speculative_stats()
    with pytest.raises(ValueError, match="shard_draft"):
        t_verifier.LLaVAVerifier(model, model.cfg, tok,
                                 compute_dtype=torch.float32, mesh=tm,
                                 draft_params=dmodel, draft_cfg=dmodel.cfg,
                                 shard_draft=True, **KW)
    # a draft that divides (the target itself) is sharded
    ts = t_verifier.LLaVAVerifier(model, model.cfg, tok,
                                  compute_dtype=torch.float32, mesh=tm,
                                  draft_params=model, draft_cfg=model.cfg,
                                  **kw)
    assert ts.shard_draft is True
    assert ts.generate_text(paths[1], q) == one.generate_text(paths[1], q)


def test_tp_verifier_int8_weights_equal_one_device(vlm):
    """quantize_llava weights with the int8 KV cache (--verifier-int8
    --tp): the meshed verifier's text and answers are the one-device int8
    verifier's."""
    import copy

    from mmrs_tpu_torch.models.quantize import quantize_llava

    *_, model, _, paths = vlm
    qmodel = quantize_llava(copy.deepcopy(model))
    tok = ToyTokenizer()
    kw = dict(KW, kv_dtype=torch.int8, compute_dtype=torch.float32)
    one = t_verifier.LLaVAVerifier(qmodel, qmodel.cfg, tok, **kw)
    tv = t_verifier.LLaVAVerifier(qmodel, qmodel.cfg, tok,
                                  mesh=_meshes(1, 2)[1], **kw)
    q = "Does this image contain a cat?"
    assert tv.generate_text(paths[2], q) == one.generate_text(paths[2], q)
    assert tv.verify_batch(paths, "cat") == one.verify_batch(paths, "cat")


def _scorer(scores):
    return lambda ps: [scores[p] for p in ps]


@pytest.mark.parametrize("mode", ["run", "stream", "journal"])
def test_pipeline_equals_jax(tmp_path, mode):
    """The same scores, stub verdicts and labels through both pipelines:
    the same gate, verdicts, calls, metrics and journal rows."""
    paths = [f"img{i}.jpg" for i in range(11)]
    rng = np.random.default_rng(0)
    en = {p: float(x) for p, x in zip(paths, rng.uniform(0, 10, 11))}
    cn = {p: float(x) for p, x in zip(paths, rng.uniform(0, 10, 11))}
    answers = {p: bool(i % 3) for i, p in enumerate(paths)}
    labels = [bool(i % 2) for i in range(11)]
    results = {}
    for name, mod in (("jax", j_pipeline), ("torch", t_pipeline)):
        verifier = (j_verifier if name == "jax" else
                    t_verifier).StubVerifier(answers)
        pipe = mod.CascadePipeline(en_scorer=_scorer(en),
                                   cn_scorer=_scorer(cn), en_threshold=6.0,
                                   cn_threshold=7.0, verifier=verifier)
        if mode == "run":
            res = pipe.run(paths, "cat", labels=labels)
        else:
            journal = str(tmp_path / f"{name}.csv") if mode == "journal" \
                else None
            res = pipe.run_streaming(paths, "cat", labels=labels,
                                     chunk_size=4, verify_batch=3,
                                     journal=journal)
            if journal:     # a resumed run redoes nothing, same result
                res = pipe.run_streaming(paths, "cat", labels=labels,
                                         chunk_size=4, verify_batch=3,
                                         journal=journal)
        res.write_csv(str(tmp_path / f"{name}_audit.csv"))
        results[name] = res
    j, t = results["jax"], results["torch"]
    for field in ("gate_passed", "verified", "en_scores", "cn_scores"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert t.verifier_calls == j.verifier_calls
    assert t.metrics == t_metrics.PRF1(**j.metrics.__dict__)
    assert t.summary().splitlines()[:5] == j.summary().splitlines()[:5]
    assert (tmp_path / "torch_audit.csv").read_text() == \
        (tmp_path / "jax_audit.csv").read_text()
    if mode == "journal":
        assert (tmp_path / "torch.csv").read_text() == \
            (tmp_path / "jax.csv").read_text()


def test_binary_prf1_equals_jax():
    rng = np.random.default_rng(1)
    for n in (0, 50):
        preds, labels = rng.random(n) > 0.4, rng.random(n) > 0.5
        assert t_metrics.binary_prf1(preds, labels) == t_metrics.PRF1(
            **j_metrics.binary_prf1(preds, labels).__dict__)
    assert t_metrics.prf1_from_counts(3, 1, 2).as_dict() == \
        j_metrics.prf1_from_counts(3, 1, 2).as_dict()


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("cascade_cli")
    rng = np.random.default_rng(0)
    for cls, color in (("cat", (200, 40, 40)), ("dog", (40, 40, 200))):
        (base / "tree" / cls).mkdir(parents=True)
        for i in range(4):
            arr = np.clip(np.asarray(color) + rng.integers(0, 60, (40, 40, 3)),
                          0, 255).astype(np.uint8)
            Image.fromarray(arr).save(base / "tree" / cls / f"{cls}{i}.jpg")
    ckpt = str(base / "w.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(1), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), ckpt)
    cfg = base / "tiny.yaml"
    cfg.write_text(f"model:\n  image_tower: vit_tiny\n  dtype: float32\n"
                   f"  checkpoint_path: {ckpt}\n")
    embed = base / "cat.npy"
    np.save(embed, rng.standard_normal(64).astype(np.float32))
    return base, str(cfg), str(embed)


def _cli(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr()


@pytest.mark.parametrize("extra", [[], ["--chunk-size", "3",
                                        "--verify-batch", "2"]])
def test_cli_stub_lines_equal_jax(cli_tree, capsys, extra):
    base, cfg, embed = cli_tree
    out = {}
    for name, main in (("jax", j_main), ("torch", t_main)):
        audit = str(base / f"{name}{len(extra)}.csv")
        argv = ["cascade", "--root", str(base / "tree"), "--positive-class",
                "cat", "--class-embed", embed, "--config", cfg,
                "--verifier", "stub", "--out", audit, *extra]
        # a threshold midway between the 4th and 5th of 8 scores
        code, res = _cli(main, argv + ["--threshold=-1e9"], capsys)
        assert code == 0, res.err
        with open(audit) as f:
            rows = list(csv.reader(f))[1:]
        scores = sorted(float(r[1]) for r in rows)
        thr = (scores[3] + scores[4]) / 2
        code, res = _cli(main, argv + [f"--threshold={thr!r}"], capsys)
        assert code == 0, res.err
        with open(audit) as f:
            out[name] = (res.out.splitlines(), list(csv.reader(f)))
    (j_lines, j_rows), (t_lines, t_rows) = out["jax"], out["torch"]
    # images, gate passed, verifier calls, final positives, P/R/F1; the
    # stage-timing lines that follow differ from run to run
    assert t_lines[:5] == j_lines[:5] and j_lines[4].startswith("P ")
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows]
    assert [r[3:] for r in t_rows] == [r[3:] for r in j_rows]
    np.testing.assert_allclose([float(r[1]) for r in t_rows[1:]],
                               [float(r[1]) for r in j_rows[1:]],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("argv,needle", [
    (["--verifier", "llava"], "--llava-checkpoint"),
    (["--verifier", "llava", "--llava-checkpoint", "x.npz",
      "--tokenizer-model", "t.model", "--tp", "2x3"], "does not divide"),
])
def test_cli_usage_errors_exit_2(cli_tree, capsys, argv, needle):
    base, cfg, embed = cli_tree
    code, res = _cli(t_main, ["cascade", "--root", str(base / "tree"),
                              "--positive-class", "cat", "--class-embed",
                              embed, "--config", cfg, "--threshold", "0",
                              *argv], capsys)
    assert code == 2 and needle in res.err


def test_cli_needs_a_class_embedding(cli_tree, capsys):
    base, cfg, _ = cli_tree
    code, res = _cli(t_main, ["cascade", "--root", str(base / "tree"),
                              "--positive-class", "cat", "--config", cfg,
                              "--threshold", "0"], capsys)
    assert code == 2 and "--class-embed" in res.err


@pytest.fixture(scope="module")
def llava_cli(cli_tree, tmp_path_factory):
    """A tiny LLaVA checkpoint at the 336-px grid (the CLI's verifier
    tower) and a SentencePiece model of bytes: the CLI's LLaVA-v1.5-7B
    and L/14-336 configs are swapped for these sizes while it runs."""
    from mmrs_tpu_torch.models import checkpoint
    from mmrs_tpu_torch.models import sentencepiece as t_sp

    base = tmp_path_factory.mktemp("llava_cli")
    vis = VITConfig(image_size=336, patch_size=14, width=32, layers=1,
                    heads=2, embed_dim=16)
    lm = LlamaConfig(vocab_size=512, dim=32, layers=1, heads=4, kv_heads=4,
                     mlp_dim=64, max_seq=2048)
    model = t_llava.LLaVA(t_llava.LLaVAConfig(vision=vis, lm=lm),
                          torch.Generator().manual_seed(3))
    ckpt = str(base / "llava.npz")
    checkpoint.save_npz(convert_jax.llava_tree(model), ckpt)
    P = t_sp.Piece
    pieces = [P("<unk>", 0.0, 2), P("<s>", 0.0, 3), P("</s>", 0.0, 3)]
    pieces += [P(f"<0x{b:02X}>", -100.0, 6) for b in range(256)]
    tok = str(base / "tokenizer.model")
    with open(tok, "wb") as f:
        f.write(t_sp.serialize_model(pieces))
    return vis, lm, ckpt, tok


def _llava_cascade(cli_tree, llava_cli, monkeypatch, capsys, tp):
    from mmrs_tpu_torch.models import configs as t_configs
    from mmrs_tpu_torch.models import llama as t_llama

    base, cfg, embed = cli_tree
    vis, lm, ckpt, tok = llava_cli
    monkeypatch.setattr(t_configs, "VIT_L14_336", vis)
    monkeypatch.setattr(t_llama, "LLAMA2_7B", lm)
    audit = str(base / f"llava_tp{tp}.csv")
    code, res = _cli(t_main, [
        "cascade", "--root", str(base / "tree"), "--positive-class", "cat",
        "--class-embed", embed, "--config", cfg, "--threshold=-1e9",
        "--verifier", "llava", "--llava-checkpoint", ckpt,
        "--tokenizer-model", tok, "--verify-batch", "3", "--tp", tp,
        "--out", audit], capsys)
    assert code == 0, res.err
    with open(audit) as f:
        return res.out.splitlines()[:5], list(csv.reader(f))


@pytest.mark.parametrize("tp", ["2", "2x2"])
def test_cli_tp_cascade_equals_one_device(cli_tree, llava_cli, monkeypatch,
                                          capsys, tp):
    """`mmrs-torch cascade --verifier llava --tp 2 | 2x2` (the checkpoint
    loaded straight into its placement on CPU entries; packs of 3, odd
    against the data axis of 2): the lines and the audit rows, verdicts
    included, of `--tp 1`."""
    want = _llava_cascade(cli_tree, llava_cli, monkeypatch, capsys, "1")
    got = _llava_cascade(cli_tree, llava_cli, monkeypatch, capsys, tp)
    assert got == want
    assert want[0][2] == "verifier calls: 8"
