"""LLaVA-1.5's architecture (BakLLaVA-1: over Mistral-7B) in plain float32.

Liu et al. 2023, "Improved Baselines with Visual Instruction Tuning", and
the `llava` package's `LlavaLlamaForCausalLM` / `LlavaMistralForCausalLM`:
the image through the CLIP ViT (reference/vit.py's tower) up to the
output of its second-to-last block (`mm_vision_select_layer` -2, no
final LayerNorm), the class token dropped, the `mlp2x_gelu` projector
(linear, exact GELU, linear), and those tokens spliced between the
prompt's text before and after the `<image>` slot. The decoder is
Mistral's (Jiang et al. 2023, "Mistral 7B"; HF `MistralForCausalLM`):
pre-RMSNorm blocks, rotary positions on contiguous halves, grouped-query
attention (consecutive query heads share a key/value head) under the
causal mask, a SwiGLU MLP, a final RMSNorm and an untied head. Its
4,096-token sliding window is wider than every sequence the benchmark
sends (the generator stops otherwise), so the mask here is the full
causal one.

Weights come as the benchmark's flat dict, under the port's names (the
generator loads the same tensors into the port); `cfg` is the
configuration file.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.reference import vit
from benchmark.reference.common import (ACTIVATIONS, Weights, gelu,
                                        layer_norm, linear, pre_ln_block)
from benchmark.reference.sentencepiece import SentencePieceBpe

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _lm_shapes(lm: Dict) -> List[Tuple[str, tuple, str]]:
    d, f, v = lm["hidden_size"], lm["intermediate_size"], lm["vocab_size"]
    hd = d // lm["num_attention_heads"]
    q, kv = lm["num_attention_heads"] * hd, lm["num_key_value_heads"] * hd
    dims = {"wq": (q, d), "wk": (kv, d), "wv": (kv, d), "wo": (d, q),
            "w_gate": (f, d), "w_up": (f, d), "w_down": (d, f)}
    out = [("lm.embed", (v, d), "embedding")]
    for i in range(lm["num_hidden_layers"]):
        p = f"lm.blocks.{i}"
        out += [(f"{p}.attn_norm", (d,), "ln_weight"),
                (f"{p}.mlp_norm", (d,), "ln_weight")]
        out += [(f"{p}.{n}.weight", dims[n], "weight") for n in LINEARS]
    return out + [("lm.final_norm", (d,), "ln_weight"),
                  ("lm.lm_head.weight", (v, d), "weight")]


def weight_shapes(cfg: Dict) -> List[Tuple[str, tuple, str, Dict]]:
    """(name, shape, init, part spec) of every parameter (init names a
    distribution of benchmark/weights.py). The vision tower's final
    LayerNorm and projection are part of the published tower and are
    made, though LLaVA reads the tower before them."""
    vis, pj, lm = cfg["vision_tower"], cfg["projector"], cfg["language_model"]
    out = [(n, s, i, vis) for n, s, i in vit.weight_shapes(vis, "visual")]
    i, h, o = pj["in_features"], pj["hidden_size"], pj["out_features"]
    out += [(n, s, init, pj) for n, s, init in (
        ("proj1.weight", (h, i), "weight"), ("proj1.bias", (h,), "bias"),
        ("proj2.weight", (o, h), "weight"), ("proj2.bias", (o,), "bias"))]
    return out + [(n, s, init, lm) for n, s, init in _lm_shapes(lm)]


def prompt_ids(cfg: Dict, tokenizer: SentencePieceBpe, question: str
               ) -> Tuple[List[int], List[int]]:
    """(ids before the image, ids after it): the conversation template
    split at the `<image>` slot; <s> before the first chunk only."""
    conv = cfg["verifier"]["conversation"]
    pre = conv["pre_image"].format(system=conv["system"])
    post = conv["post_image"].format(question=question)
    return tokenizer.encode(pre, bos=True), tokenizer.encode(post, bos=False)


def image_tokens(w: Weights, cfg: Dict, images_u8: torch.Tensor
                 ) -> torch.Tensor:
    """uint8 images [B, S, S, 3] -> the projector's output [B, N, D]."""
    spec, ver = cfg["vision_tower"], cfg["verifier"]
    x = vit.preprocess(images_u8)
    b, s, _, c = x.shape
    p = spec["patch_size"]
    g = s // p
    x = x.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5)
    x = linear(x.reshape(b, g * g, p * p * c), w["visual.patch_embed.weight"])
    cls = w["visual.class_embedding"].float().expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + w["visual.positional_embedding"].float()
    eps = spec["layer_norm_eps"]
    x = layer_norm(x, w, "visual.ln_pre", eps)
    act = ACTIVATIONS[spec["activation"]]
    for i in range(spec["layers"] + ver["vision_feature_layer"] + 1):
        x = pre_ln_block(x, w, f"visual.blocks.{i}", spec["heads"], None,
                         act, eps, False)
    if ver["drop_cls"]:
        x = x[:, 1:]
    x = gelu(linear(x, w["proj1.weight"], w["proj1.bias"]))
    return linear(x, w["proj2.weight"], w["proj2.bias"])


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, heads, T, hd] at positions 0..T-1, HF's rotate_half."""
    t, hd = x.shape[2], x.shape[3]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device).float() / hd)
    ang = torch.arange(t, device=x.device).float()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    half = hd // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + turned * sin


def decoder_block(h: torch.Tensor, w: Weights, i: int, lm: Dict
                  ) -> torch.Tensor:
    p = f"lm.blocks.{i}"
    b, t, d = h.shape
    heads, kvh = lm["num_attention_heads"], lm["num_key_value_heads"]
    hd = d // heads
    x = rms_norm(h, w[f"{p}.attn_norm"], lm["rms_norm_eps"])

    def proj(name, n):
        y = linear(x, w[f"{p}.{name}.weight"])
        return y.reshape(b, t, n, hd).transpose(1, 2)

    q = rope(proj("wq", heads), lm["rope_theta"])
    k = rope(proj("wk", kvh), lm["rope_theta"])
    v = proj("wv", kvh)
    k = k.repeat_interleave(heads // kvh, dim=1)
    v = v.repeat_interleave(heads // kvh, dim=1)
    logits = q @ k.transpose(-1, -2) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).triu(1)
    logits = logits.masked_fill(causal, float("-inf"))
    out = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(b, t, d)
    h = h + linear(out, w[f"{p}.wo.weight"])
    x = rms_norm(h, w[f"{p}.mlp_norm"], lm["rms_norm_eps"])
    gate = linear(x, w[f"{p}.w_gate.weight"])
    up = linear(x, w[f"{p}.w_up.weight"])
    return h + linear(torch.nn.functional.silu(gate) * up,
                      w[f"{p}.w_down.weight"])


def logits(w: Weights, cfg: Dict, images_u8: torch.Tensor,
           pre: Sequence[int], post: Sequence[int], tokens: torch.Tensor
           ) -> torch.Tensor:
    """The logits [B, n, V] that predict each of n answer tokens: the whole
    sequence (prompt, image, and the first n - 1 of `tokens` [B, n], the
    tokens the system answered) in one causal pass, read at the prompt's
    last position and at each answer token but the last."""
    lm = cfg["language_model"]
    embed = w["lm.embed"]
    dev = embed.device
    b, n = tokens.shape

    def text(ids):
        rows = embed[torch.as_tensor(ids, device=dev)].float()
        return rows.expand(b, -1, -1)

    h = torch.cat([text(pre), image_tokens(w, cfg, images_u8), text(post),
                   embed[tokens[:, :n - 1].to(dev)].float()], dim=1)
    for i in range(lm["num_hidden_layers"]):
        h = decoder_block(h, w, i, lm)
    h = rms_norm(h[:, -n:], w["lm.final_norm"], lm["rms_norm_eps"])
    return linear(h, w["lm.lm_head.weight"])
