"""The verifier cell on the CPU at a tiny size: the reference agrees with the
port, a run with its timed path broken underneath reads `correct` false,
its control (the port's int8 route) fails the limits sound runs pass, the
work counts match hand arithmetic, and another verifier kind joins with
files and entries alone.

The tiny cell's limits are L^0.4 U^0.6 of its own readings (seeds 21-23
and 31-33, one-second windows, two passes): sound runs read
`token_gap_max` 0.001-0.072 and `logit_gap_p90` 0.016-0.026, the control
0.222-1.54 and 0.110-0.193. With a decoder 64 wide the two overlap
(sound up to 0.047, the control from 0.042), so the tiny one is 256."""

from __future__ import annotations

import copy
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import data, roofline, roofline_vlm, vlm, weights
from benchmark import run as bench_run
from benchmark.generators import verify
from benchmark.reference import llava as ref_llava
from benchmark.reference import no_tf32
from benchmark.reference.sentencepiece import SentencePieceBpe
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELL = "t-vlm.verify"
LIMITS = {"rows_lost": 0, "token_gap_max": 0.13, "logit_gap_p90": 0.06}
LAYER = "cascade/verifier.LLaVAVerifier via models/llava and models/llama"
KERNELS = "kernels K10 and K11 (ops/decode_attention)"
# the BENCHMARK.json entries of a verifier cell (the cell bakllava-7b.verify
# is held back, so the manifest has none yet; a tiny root adds them)
VERIFY_METRICS = {
    "end_to_end": [
        {"name": "verify_img_per_s", "unit": "img/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": []}],
    "per_layer": [
        {"name": "mfu.verify", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": LAYER, "moves": "verify_img_per_s",
         "workloads": []},
        {"name": "device_idle.verify", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "verify_img_per_s", "workloads": []},
        {"name": "k10_roofline.verify", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": KERNELS,
         "moves": "verify_img_per_s", "workloads": []},
        {"name": "k11_roofline.verify", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": KERNELS,
         "moves": "verify_img_per_s", "workloads": []}]}


def _load(*parts):
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return json.load(f)


def tiny_vlm() -> dict:
    """The BakLLaVA configuration at tiny widths (16 image tokens, 16-token
    prefill chunks, two decoder layers of 256), its vocabulary whole."""
    cfg = _load(tiny.BENCH, "configs", "bakllava-7b.json")
    cfg["vision_tower"].update(image_size=56, width=64, layers=3, heads=2,
                               embed_dim=32)
    cfg["verifier"].update(image_tokens=16, prefill_chunk=16)
    cfg["projector"].update(in_features=64, hidden_size=256, out_features=256)
    cfg["language_model"].update(hidden_size=256, intermediate_size=512,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 num_key_value_heads=2)
    return cfg


def add_cell(root: str, cell: str, config: str, cfg: dict,
             limits: dict = LIMITS) -> None:
    """A verifier cell in a tiny root, by files and entries only."""
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", f"{config}.json"), "w") as f:
        json.dump(cfg, f)
    traffic = _load(tiny.BENCH, "traffic", "verify.json")
    traffic.update(pool_images=32, verify_batch=8, sample_rows=8)
    with open(os.path.join(bench, "traffic", "verify.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "limits", f"{cell}.json"), "w") as f:
        json.dump(limits, f)
    manifest = _load(root, "BENCHMARK.json")
    manifest["configs"].append({"name": config, "source": "tiny",
                                "file": f"benchmark/configs/{config}.json",
                                "reduced": [], "why": "tests"})
    manifest["workloads"].append({"name": cell, "config": config,
                                  "traffic": "verify", "chips": 1,
                                  "why": "tests"})
    for kind, entries in VERIFY_METRICS.items():
        have = {m["name"]: m for m in manifest[kind]}
        for entry in entries:
            m = have.get(entry["name"])
            if m is None:
                m = copy.deepcopy(entry)
                manifest[kind].append(m)
            m["workloads"] = sorted({*m["workloads"], cell} - {
                "bakllava-7b.verify"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)


def make_root(tmp: str) -> str:
    root = tiny.make_root(tmp)
    for d in ("reference", "builders"):
        os.symlink(os.path.join(tiny.BENCH, d),
                   os.path.join(root, "benchmark", d))
    add_cell(root, CELL, "tiny-vlm", tiny_vlm())
    return root


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")
    return make_root(str(tmp_path / "root"))


def _run(root, cell=CELL, control=False, trace=False, seed=21):
    r = bench_run.Run(bench_run.Manifest(root), cell, seed, 1.0, trace, CPU,
                      control)
    result, _ = bench_run.execute(r)
    return result, r


def test_a_sound_run_is_correct_and_reports_its_metrics(root):
    result, r = _run(root)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["attempted"] % 8 == 0 and r.items == result["attempted"]
    assert set(result["metrics"]) == {"setup_s", "verify_img_per_s"}
    assert len(r.sample) == 4 and {0, r.packs - 1} <= set(r.sample)
    longest = max(r.lengths[verify.pack(r, i)[1]] for i in range(r.packs))
    assert longest in {r.lengths[verify.pack(r, i)[1]] for i in r.sample}
    assert all(len(rows) == 8 for rows in r.sample.values())
    traced, _ = _run(root, trace=True, seed=22)
    assert traced["correct"], traced["compared"]
    # no device events on the CPU: the kernels' shares are left out
    assert set(traced["metrics"]) == {"mfu.verify", "device_idle.verify"}


# -- faults planted in the timed path, underneath the benchmark --------------

def _perturbed_logits(monkeypatch):
    from mmrs_tpu_torch.models import llama

    real = llama.forward

    def forward(*a, **k):
        logits, cache = real(*a, **k)
        g = torch.Generator().manual_seed(logits.shape[1])
        noise = torch.randn(logits.shape, generator=g)
        return logits + 0.3 * logits.std() * noise.to(logits.device), cache
    monkeypatch.setattr(llama, "forward", forward)


def _broken_generate(change):
    def plant(monkeypatch):
        from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier

        real = LLaVAVerifier._generate

        def generate(self, images, pre, post):
            return change(real, self, images, pre, post)
        monkeypatch.setattr(LLaVAVerifier, "_generate", generate)
    return plant


def _swap(real, self, images, pre, post):
    out, spec = real(self, images, pre, post)
    out = out.clone()
    out[0, 1] = (out[0, 1] + 1) % self.cfg.lm.vocab_size
    return out, spec


def _stale_steps(real, self, images, pre, post):
    """Each decode step hands back the state it was given: the first
    token again."""
    out, spec = real(self, images, pre, post)
    return out[:, :1].expand_as(out).contiguous(), spec


def _half_batch(real, self, images, pre, post):
    """Every other image decoded, each answer given to two rows."""
    out, spec = real(self, images[::2], pre[::2], post[::2])
    return out.repeat_interleave(2, 0)[:images.shape[0]], spec


def _dropped_row(monkeypatch):
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier

    real = LLaVAVerifier.collect
    monkeypatch.setattr(LLaVAVerifier, "collect",
                        lambda self, h: real(self, h)[:-1])


@pytest.mark.parametrize("fault", [
    _perturbed_logits, _broken_generate(_swap),
    _broken_generate(_stale_steps), _broken_generate(_half_batch),
    _dropped_row], ids=["perturbed_logit", "swapped_token", "stale_step",
                        "half_batch", "dropped_row"])
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result, _ = _run(root)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("seed", [21, 31])
def test_the_control_is_not_correct(root, seed):
    """The control is the port's int8 route: int8 weights and KV cache."""
    result, _ = _run(root, control=True, seed=seed)
    assert not result["correct"], result["compared"]


# -- the reference against the port ------------------------------------------

def _tiny_verifier(cfg, seed=3):
    from benchmark.builders import llava as builder

    traffic = _load(tiny.BENCH, "traffic", "verify.json")
    pieces = vlm.sentencepiece_vocab(32000, [traffic["question"]]
                                     + traffic["categories"])
    w = weights.draw(ref_llava.weight_shapes(cfg), seed, CPU)
    return builder, builder.build(cfg, traffic, w, pieces, CPU), w, pieces


def test_the_reference_matches_the_ports_float32_route(tmp_path, monkeypatch):
    """The port at float32 (its einsum attention) replays an answer; the
    reference's logits agree to rounding."""
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")
    no_tf32()
    cfg = tiny_vlm()
    builder, v, w, pieces = _tiny_verifier(cfg)
    v.compute_dtype, v.attn = torch.float32, "einsum"
    pool = data.image_pool(3, 56, 5, CPU)
    paths = vlm.write_pngs(pool, str(tmp_path), 1)
    tokens = torch.tensor([[5, 900, 2, 2], [31999, 7, 7, 3], [1, 2, 3, 4]],
                          dtype=torch.int32)
    got = builder.replay(v, paths, "hot dog", tokens)
    pre, post = ref_llava.prompt_ids(cfg, SentencePieceBpe(pieces),
                                     v.prompt_template.format(
                                         category="hot dog"))
    want = ref_llava.logits(w, cfg, torch.from_numpy(pool), pre, post,
                            tokens)
    assert got.shape == want.shape == (3, 4, 32000)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_the_reference_tokenizer_matches_the_ports():
    from mmrs_tpu_torch.models.sentencepiece import Piece, SentencePieceBPE

    traffic = _load(tiny.BENCH, "traffic", "verify.json")
    cfg = _load(tiny.BENCH, "configs", "bakllava-7b.json")
    texts = [cfg["verifier"]["conversation"]["system"] + " USER: ",
             "\nDoes this image contain a teddy bear? ASSISTANT:",
             "unknown wörds, digits 42 and\ttabs", ""]
    pieces = vlm.sentencepiece_vocab(32000, texts + traffic["categories"])
    assert len(pieces) == 32000
    port = SentencePieceBPE([Piece(*p) for p in pieces])
    ref = SentencePieceBpe(pieces)
    for text in texts:
        for bos in (True, False):
            assert ref.encode(text, bos) == port.encode(text, add_bos=bos)
    # each word of the prompts is one piece
    assert len(ref.encode("Does this image contain", False)) == 4


def test_the_files_decode_to_the_pool(tmp_path, monkeypatch):
    """The verifier's own load reads back the pixels the reference takes."""
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")
    from mmrs_tpu_torch.io.images import load_image

    pool = data.image_pool(4, 336, 8, CPU)
    for path, img in zip(vlm.write_pngs(pool, str(tmp_path), 1), pool):
        np.testing.assert_array_equal(load_image(path, 336, "hf").pixels,
                                      img)


def test_answer_gaps_skip_the_padding_after_an_end():
    ref = torch.zeros(2, 3, 5)
    ref[..., 4] = 1.0
    tokens = torch.tensor([[4, 2, 0], [1, 4, 4]])
    gaps = verify.answer_gaps(ref, tokens, eos=2)
    assert gaps.tolist() == [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]


# -- work counts --------------------------------------------------------------

def test_gqa_attention_counts_by_hand():
    """8 rows, 8 kv heads of 4 query heads, hd 128: each kv head's keys and
    values read once, only the keys the causal mask allows."""
    lm = _load(tiny.BENCH, "configs", "bakllava-7b.json")["language_model"]
    # a chunk of 64 queries from position 576: query c sees 577 + c keys
    pairs = sum(576 + c + 1 for c in range(64))
    assert roofline_vlm.k10_flops(lm, 8, 576, 64) == 4 * 8 * 32 * 128 * pairs
    assert roofline_vlm.k10_bytes(lm, 8, 576, 64) == (
        2 * 2 * 8 * 8 * 640 * 128 + (2 + 4) * 8 * 32 * 64 * 128)
    assert roofline_vlm.k11_flops(lm, 8, 634) == 4 * 8 * 32 * 128 * 634
    assert roofline_vlm.k11_bytes(lm, 8, 634) == (
        2 * 2 * 8 * 8 * 634 * 128 + (2 + 4) * 8 * 32 * 128)
    # a decode step moves 21.0 MB: bound by bytes, 6.26 us
    least = roofline.least_seconds(roofline_vlm.k11_flops(lm, 8, 634),
                                   roofline_vlm.k11_bytes(lm, 8, 634))
    assert least == pytest.approx(6.26e-6, rel=1e-3)


def test_an_answer_is_about_9_4_tflop():
    cfg = _load(tiny.BENCH, "configs", "bakllava-7b.json")
    lm = cfg["language_model"]
    # a layer's projections: q, k, v (GQA), o and the SwiGLU MLP
    per_layer = (4096 * (4096 + 2 * 1024) + 4096 * 4096
                 + 3 * 4096 * 14336)
    assert per_layer == 218_103_808
    assert roofline_vlm.token_flops(lm, 10) == 32 * (
        2 * per_layer + 4 * 32 * 128 * 10)
    vision = roofline_vlm.vision_flops(cfg["vision_tower"], 23)
    hand = (2 * 576 * 588 * 1024 + 23 * (
        2 * 577 * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 4 * 577 ** 2 * 1024))
    assert vision == hand
    total = roofline_vlm.answer_flops(cfg, 632, 4)
    decoder = sum(roofline_vlm.token_flops(lm, k) for k in range(1, 636))
    assert total == (vision + 2 * 576 * (1024 * 4096 + 4096 * 4096)
                     + decoder + 4 * 2 * 4096 * 32000)
    assert total == pytest.approx(9.4e12, rel=0.02)


def test_the_kernel_readers_take_whole_runs_of_launches():
    """K10's and K11's shares count only the runs bounded on both sides by
    another attention kernel: the slice's cut ends are left out."""
    from types import SimpleNamespace

    cfg = tiny_vlm()
    lm = cfg["language_model"]
    traffic = dict(_load(tiny.BENCH, "traffic", "verify.json"),
                   verify_batch=8)
    t, us = 72, 1000      # prompt length; 1 us in ns
    names = {"k10": "void chunk_kernel<bf16, 64>", "k11": "decode_kernel<4>",
             "k2": "mha_mma_kernel<64, true>"}
    seq = ["k10"] * 3 + ["k2"] + ["k10"] * 10 + ["k11"] * 6 + ["k2"] \
        + ["k10"] * 4
    events, clock = [], 0
    for kind in seq:
        length = {"k10": 2, "k11": 3, "k2": 5}[kind] * us
        events.append((names[kind], clock, clock + length))
        clock += length + us
    run = SimpleNamespace(
        cfg=cfg, traffic=traffic, prompts=[t, t], elapsed=1.0,
        trace=SimpleNamespace(clipped=lambda: events))
    m = bench_run.Manifest()
    least10 = 2 * sum(roofline.least_seconds(
        roofline_vlm.k10_flops(lm, 8, s, min(16, t - s)),
        roofline_vlm.k10_bytes(lm, 8, s, min(16, t - s)))
        for s in range(0, t, 16))
    assert m.reader("k10_roofline.verify").read(run) == pytest.approx(
        100 * least10 / 20e-6)
    least11 = 2 * sum(roofline.least_seconds(
        roofline_vlm.k11_flops(lm, 8, t + s + 1),
        roofline_vlm.k11_bytes(lm, 8, t + s + 1)) for s in range(3))
    assert m.reader("k11_roofline.verify").read(run) == pytest.approx(
        100 * least11 / 18e-6)
    # a run of another length than the prompt's (a cut one) reads nothing
    run.prompts = [200]
    assert m.reader("k10_roofline.verify").read(run) is None


# -- joining by files ---------------------------------------------------------

def test_another_verifier_kind_joins_as_files_and_entries(tmp_path,
                                                          monkeypatch):
    """A copy of the tiny benchmark gains a verifier of a new kind (one that
    keeps the class token) by adding its reference and builder modules, a
    configuration, a limits file and entries; nothing of the generator,
    the readers, system.py or weights.py changes. The new cell runs and
    reports verify_img_per_s."""
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")
    root = tiny.make_root(str(tmp_path / "root"))
    bench = os.path.join(root, "benchmark")
    for d in ("reference", "builders"):
        shutil.copytree(os.path.join(tiny.BENCH, d), os.path.join(bench, d))
    for d in ("reference", "builders"):
        with open(os.path.join(bench, d, "llava_cls.py"), "w") as f:
            f.write(f"from benchmark.{d}.llava import *  # noqa: F401,F403\n")
    cfg = tiny_vlm()
    cfg["verifier"].update(kind="llava_cls", drop_cls=False, image_tokens=17)
    add_cell(root, "t-cls.verify", "tiny-vlm-cls", cfg)
    before = {p: open(os.path.join(tiny.BENCH, p), "rb").read() for p in (
        "generators/verify.py", "system.py", "weights.py",
        "metrics/verify_img_per_s.py")}
    result, r = _run(root, cell="t-cls.verify")
    assert r.builder.__name__ == "benchmark.builders.llava_cls"
    assert r.verifier is None and r.lengths["dog"] == 17 + 56
    assert result["correct"], result["compared"]
    assert result["metrics"]["verify_img_per_s"]["value"] > 0
    assert before == {p: open(os.path.join(tiny.BENCH, p), "rb").read()
                      for p in before}


# -- the index cells read what they read -------------------------------------

INDEX_WEIGHTS = {
    "clip-vit-b32":
        "cfb028a9527abe57ae3ac9e00fe1b3f8065a909133fa32678b995b8ced262e20",
    "taiyi-clip-l14":
        "23825ec6b4f72782dd1521853ac5f194cb7dcac2c0f50922b60745cfe137e4ff"}


@pytest.mark.parametrize("name", sorted(INDEX_WEIGHTS))
def test_the_index_cells_weights_are_the_same_bits(name):
    """weights.make (CPU generator, seed 7) for each index configuration
    hashes as it did before the verifier cell was added."""
    cfg = copy.deepcopy(_load(tiny.BENCH, "configs", f"{name}.json"))
    w = weights.make(cfg, 7, CPU)
    h = hashlib.sha256()
    for k in sorted(w):
        h.update(k.encode())
        h.update(w[k].reshape(-1).view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == INDEX_WEIGHTS[name]
