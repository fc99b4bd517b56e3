"""The work counted from shapes matches hand counts."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import roofline
from benchmark.tests import tiny


def _cfg(name):
    with open(os.path.join(tiny.BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_vit_b32_is_8_82_gflop_an_image():
    spec = _cfg("clip-vit-b32")["image_tower"]
    # 50 tokens, width 768, 12 blocks: per block 2*50*(4*768^2 + 2*768*3072)
    # + 4*50^2*768; patch map 2*49*3072*768; projection 2*768*512
    block = 2 * 50 * (4 * 768 ** 2 + 2 * 768 * 3072) + 4 * 50 ** 2 * 768
    hand = 2 * 49 * 3072 * 768 + 12 * block + 2 * 768 * 512
    assert roofline.vit_flops_per_image(spec) == hand
    assert roofline.vit_flops_per_image(spec) == pytest.approx(8.82e9, rel=2e-3)


def test_vit_l14_is_about_162_gflop_an_image():
    spec = _cfg("taiyi-clip-l14")["image_tower"]
    assert roofline.vit_flops_per_image(spec) == pytest.approx(162e9, rel=3e-3)


def test_text_towers():
    clip = _cfg("clip-vit-b32")["text_tower"]
    # 10 tokens: 12 blocks of 2*10*(4+8)*512^2 plus 4*55*512 for the causal
    # pairs, then the projection
    hand = 12 * (2 * 10 * 12 * 512 ** 2 + 4 * 55 * 512) + 2 * 512 * 512
    assert roofline.clip_text_flops(clip, 10) == hand
    bert = _cfg("taiyi-clip-l14")["text_tower"]
    hand = (24 * (2 * 20 * (4 * 1024 ** 2 + 2 * 1024 * 4096)
                  + 4 * 400 * 1024) + 2 * 1024 ** 2 + 2 * 1024 * 768)
    assert roofline.bert_flops(bert, 20) == hand
    # RoBERTa-large's 24 blocks hold 302M matmul weights, bf16
    assert roofline.bert_weight_bytes(bert) == pytest.approx(
        2 * (24 * 12 * 1024 ** 2 + 1024 ** 2 + 1024 * 768))


def test_k1_reads_the_gallery_once():
    # 4M x 512 bf16 = 4 GiB, 8 queries, top-10
    b = roofline.k1_bytes(1 << 22, 512, 8, 10)
    assert b == 2 * (1 << 22) * 512 + 2 * 8 * 512 + 8 * 8 * 10
    assert b / roofline.HBM_BYTES_PER_S == pytest.approx(1.282e-3, rel=1e-3)


def test_k2_least_time_is_its_bytes_at_the_b32_shape():
    # [224, 50, 768]: PERF.md's kernel table gives a 0.0205 ms bound
    assert roofline.k2_seconds(224, 50, 768) == pytest.approx(20.5e-6,
                                                              rel=3e-3)
    assert roofline.k2_flops(224, 50, 768) / roofline.BF16_FLOPS < \
        roofline.k2_bytes(224, 50, 768) / roofline.HBM_BYTES_PER_S
