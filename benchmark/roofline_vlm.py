"""The work of a vision-language verifier's pieces, from shapes.

Operations count 2 a multiply-add. The vision tower runs up to its
feature layer at full attention; the decoder counts every projection of
each token it runs (prefill: every prompt position; a decode step: one
token), attention over the keys the causal mask allows a query, and the
output head where logits are taken (the prompt's last position and each
decode step). K10 (the prefill chunks' attention) and K11 (a decode
step's) read each key/value head's cached keys and values once, however
many query heads share it, and only the keys the mask allows; queries
are read in bf16 and outputs written in f32, as the kernels do.
The peaks are benchmark/roofline.py's.
"""

from __future__ import annotations

from typing import Dict

from benchmark.roofline import BF16, _block_flops

F32 = 4


def vision_flops(spec: Dict, blocks: int) -> float:
    """One image through the patch map and `blocks` blocks."""
    w, p = spec["width"], spec["patch_size"]
    t = (spec["image_size"] // p) ** 2 + 1
    return (2 * (t - 1) * p * p * 3 * w
            + blocks * _block_flops(t, w, spec["mlp_ratio"] * w, t * t))


def projector_flops(pj: Dict, tokens: int) -> float:
    h = pj["hidden_size"]
    return 2 * tokens * (pj["in_features"] * h + h * pj["out_features"])


def _heads(lm: Dict):
    heads, kvh = lm["num_attention_heads"], lm["num_key_value_heads"]
    return heads, kvh, lm["hidden_size"] // heads


def token_flops(lm: Dict, keys: int) -> float:
    """One token through every decoder layer, attending to `keys` keys
    (its own position and those before it)."""
    d, f = lm["hidden_size"], lm["intermediate_size"]
    heads, kvh, hd = _heads(lm)
    proj = d * (heads + 2 * kvh) * hd + heads * hd * d + 3 * d * f
    return lm["num_hidden_layers"] * (2 * proj + 4 * heads * hd * keys)


def head_flops(lm: Dict) -> float:
    return 2 * lm["hidden_size"] * lm["vocab_size"]


def answer_flops(cfg: Dict, prompt: int, new_tokens: int) -> float:
    """One image answered: the tower to its feature layer, the projector,
    the prompt of `prompt` positions and `new_tokens` greedy tokens (the
    first from the prefill's last logits, each other from one decode
    step)."""
    vis, lm, ver = (cfg["vision_tower"], cfg["language_model"],
                    cfg["verifier"])
    blocks = vis["layers"] + ver["vision_feature_layer"] + 1
    prefill = sum(token_flops(lm, p + 1) for p in range(prompt))
    decode = sum(token_flops(lm, prompt + s + 1)
                 for s in range(new_tokens - 1))
    return (vision_flops(vis, blocks)
            + projector_flops(cfg["projector"], ver["image_tokens"])
            + prefill + decode + new_tokens * head_flops(lm))


def k10_flops(lm: Dict, batch: int, start: int, queries: int) -> float:
    """K10 over one layer's chunk of `queries` positions from `start`."""
    heads, _, hd = _heads(lm)
    pairs = queries * start + queries * (queries + 1) // 2
    return 4.0 * batch * heads * hd * pairs


def k10_bytes(lm: Dict, batch: int, start: int, queries: int) -> float:
    heads, kvh, hd = _heads(lm)
    kv = 2 * BF16 * batch * kvh * (start + queries) * hd
    return kv + (BF16 + F32) * batch * heads * queries * hd


def k11_flops(lm: Dict, batch: int, keys: int) -> float:
    """K11 over one layer's decode step whose query sees `keys` keys."""
    heads, _, hd = _heads(lm)
    return 4.0 * batch * heads * hd * keys


def k11_bytes(lm: Dict, batch: int, keys: int) -> float:
    heads, kvh, hd = _heads(lm)
    return (2 * BF16 * batch * kvh * keys * hd
            + (BF16 + F32) * batch * heads * hd)
