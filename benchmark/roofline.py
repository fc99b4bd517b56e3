"""The H100's published peaks and the work of each measured piece, from shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
full 700 W power limit. A piece's least time is the larger of its
operations over the peak of their type and its bytes over the memory
bandwidth; bytes count each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict

BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

BF16 = 2


def least_seconds(flops: float, nbytes: float,
                  peak: float = BF16_FLOPS) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def _block_flops(tokens: int, width: int, hidden: int, pairs: float) -> float:
    """One transformer block over `tokens` rows: the four projections and
    the MLP (2 flops a multiply-add), and attention's two products over
    `pairs` (query, key) pairs."""
    return 2 * tokens * (4 * width * width + 2 * width * hidden) \
        + 4 * pairs * width


def vit_flops_per_image(spec: Dict) -> float:
    """The patch map, every block at full attention, the projection."""
    w, p = spec["width"], spec["patch_size"]
    t = (spec["image_size"] // p) ** 2 + 1
    return (2 * (t - 1) * p * p * 3 * w
            + spec["layers"] * _block_flops(t, w, spec["mlp_ratio"] * w, t * t)
            + 2 * w * spec["embed_dim"])


def clip_text_flops(spec: Dict, tokens: int) -> float:
    """One text of `tokens` ids up to and including end-of-text: what the
    pooled row depends on under the causal mask."""
    w = spec["width"]
    pairs = tokens * (tokens + 1) / 2
    return (spec["layers"] * _block_flops(tokens, w, spec["mlp_ratio"] * w,
                                          pairs)
            + 2 * w * spec["embed_dim"])


def clip_text_weight_bytes(spec: Dict) -> float:
    w = spec["width"]
    return BF16 * (spec["layers"] * (4 + 2 * spec["mlp_ratio"]) * w * w
                   + w * spec["embed_dim"])


def bert_flops(spec: Dict, tokens: int) -> float:
    """One text of `tokens` ids ([CLS] ... [SEP], no padding)."""
    h = spec["hidden_size"]
    return (spec["layers"] * _block_flops(tokens, h, spec["intermediate_size"],
                                          tokens * tokens)
            + 2 * h * h + 2 * h * spec["num_labels"])


def bert_weight_bytes(spec: Dict) -> float:
    h, f = spec["hidden_size"], spec["intermediate_size"]
    return BF16 * (spec["layers"] * (4 * h * h + 2 * h * f) + h * h
                   + h * spec["num_labels"])


TEXT_FLOPS = {"clip_text": clip_text_flops, "bert": bert_flops}
TEXT_WEIGHT_BYTES = {"clip_text": clip_text_weight_bytes,
                     "bert": bert_weight_bytes}


def k1_bytes(rows: int, dim: int, queries: int, k: int) -> float:
    """K1 (the flat bf16 cosine top-k): the gallery and the queries read
    once, k (score, row) pairs a query written."""
    return BF16 * rows * dim + BF16 * queries * dim + 8 * queries * k


def k1_flops(rows: int, dim: int, queries: int) -> float:
    return 2.0 * rows * dim * queries


def k2_bytes(batch: int, tokens: int, width: int) -> float:
    """K2 (the short-sequence attention): q, k, v read, the output
    written, bf16 [B, T, W] each."""
    return 4 * BF16 * batch * tokens * width


def k2_flops(batch: int, tokens: int, width: int) -> float:
    return 4.0 * batch * tokens * tokens * width


def k2_seconds(batch: int, tokens: int, width: int) -> float:
    return least_seconds(k2_flops(batch, tokens, width),
                         k2_bytes(batch, tokens, width))
