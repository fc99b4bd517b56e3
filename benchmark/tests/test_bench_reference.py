"""The plain reference agrees with the port at tiny sizes on the CPU: the
towers (the port's float32 route), the tokenizers and the scan."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import data, system, weights
from benchmark.generators import open_loop
from benchmark.reference import no_tf32, scan, vit
from benchmark.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    monkeypatch.setenv("MMRS_TORCH_DEVICE", "cpu")
    no_tf32()


def _port_f32(name, vocab=None):
    cfg = tiny.tiny(name)
    w = weights.make(cfg, 3, CPU)
    tok = system.tokenizer(cfg, vocab) if vocab is not None else None
    return cfg, w, system.towers(cfg, w, tok, CPU, dtype="float32")


@pytest.mark.parametrize("name", ["tiny-clip", "tiny-taiyi"])
def test_image_tower_matches_the_port(name):
    cfg, w, towers = _port_f32(name)
    imgs = data.image_pool(6, 224, 9, CPU)
    got = towers.image_encode(imgs)
    ref = vit.encode(w, cfg["image_tower"], torch.from_numpy(imgs))
    np.testing.assert_allclose(got, ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("name", ["tiny-clip", "tiny-taiyi"])
def test_text_tower_and_tokenizer_match_the_port(name):
    cfg = tiny.tiny(name)
    vocab, units, sep = open_loop.vocabulary(cfg)
    _, w, towers = _port_f32(name, vocab)
    texts = data.texts(12, units, 3, 20, 1.5, sep, 4)
    ref_tok = open_loop.reference_tokenizer(cfg, vocab)
    got = towers.text_encode(texts)
    ref = open_loop.reference_embed(cfg, w, ref_tok, texts, CPU, block=5)
    np.testing.assert_allclose(got, ref.numpy(), atol=2e-5)
    port_tok = system.tokenizer(cfg, vocab)
    mine = ref_tok(texts)
    theirs = port_tok(texts)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    np.testing.assert_array_equal(mine[0], theirs[0])


def test_tokenizers_on_awkward_text():
    merges, _ = data.clip_merges(2000)
    vocab, _ = data.wordpiece_vocab(21128)
    cfg_c, cfg_t = tiny.tiny("tiny-clip"), tiny.tiny("tiny-taiyi")
    texts = ["A  PHOTO of &amp; the   cat's 3 dogs!!", "Café\tnaïve\x00x",
             "一只猫 and 狗。", "x" * 120, ""]
    for cfg, vocab_ in ((cfg_c, merges), (cfg_t, vocab)):
        ref = open_loop.reference_tokenizer(cfg, vocab_)(texts)
        port = system.tokenizer(cfg, vocab_)(texts)
        port = port if isinstance(port, tuple) else (port,)
        np.testing.assert_array_equal(ref[0], port[0])
        if len(port) > 1:
            np.testing.assert_array_equal(ref[1], port[1])


def test_weights_are_the_served_dtypes_and_repeat_from_the_seed():
    cfg = tiny.tiny("tiny-taiyi")
    a, b = weights.make(cfg, 7, CPU), weights.make(cfg, 7, CPU)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["visual.blocks.0.attn.wq.weight"].dtype == torch.bfloat16
    assert a["text.classifier.bias"].dtype == torch.float32
    assert not torch.equal(a["text.classifier.bias"],
                           weights.make(cfg, 8, CPU)["text.classifier.bias"])


def test_scan_is_the_exact_top_k_and_planted_rows_win():
    anchors = torch.nn.functional.normalize(torch.randn(5, 32), dim=1)
    gal, planted = data.gallery(5000, 32, 16, 1.0, anchors, 4, 3, CPU,
                                block=1024)
    v, i = scan.topk(anchors, gal, 4)
    full = anchors @ torch.nn.functional.normalize(
        torch.from_numpy(gal).float(), dim=1).T
    ev, ei = full.topk(4, dim=1)
    torch.testing.assert_close(v, ev)
    assert torch.equal(i, ei)
    # in 32 dimensions only the nearest planted rows are sure to win
    assert all(set(p[:2]) <= set(r) for p, r in zip(planted, i.numpy()))
    torch.testing.assert_close(scan.scores_of(anchors, gal, i.numpy()), v)


def test_the_control_is_coarser_than_float32():
    cfg = tiny.tiny("tiny-clip")
    w = weights.make(cfg, 3, CPU)
    imgs = torch.from_numpy(data.image_pool(4, 224, 9, CPU))
    exact = vit.encode(w, cfg["image_tower"], imgs)
    control = vit.encode(w, cfg["image_tower"], imgs, int8=True)
    gap = float((exact - control).norm(dim=1).max())
    assert 1e-3 < gap < 0.5

