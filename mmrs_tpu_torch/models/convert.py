"""Torch/HF state-dict -> mmrs_tpu param-pytree converters, in numpy.

A port of mmrs_tpu/models/convert.py (and of mmrs_tpu/models/llava.py's
`hf_llama` / `hf_llava`) for the PyTorch port: the same trees, keys,
shapes and dtypes, as numpy arrays where the JAX package makes device
arrays (`_arr` applies JAX's default canonicalization: f64 -> f32, i64 ->
i32). checkpoint.save_npz writes a tree as the npz the JAX package
writes, and models/convert_jax.py loads it into the port's modules.

The reference loads pretrained weights via `clip.load("ViT-B/32")`
(code/test_clip.py:6) and HF `CLIPModel`/`BertForSequenceClassification`
(code/test_taiyi.py:11-17). These converters map either checkpoint format
into our stacked-layer JAX pytrees so the same weights run on TPU.

All inputs are plain dicts of numpy arrays (call `.numpy()` on torch tensors
first, or use `state_dict_to_numpy`). Golden-parity tests construct a
randomly-initialized HF model offline, convert it, and assert embedding
equality — no network needed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from mmrs_tpu_torch.models.configs import BertConfig, TextConfig, VITConfig

Params = Dict[str, Any]
StateDict = Mapping[str, np.ndarray]


def state_dict_to_numpy(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Detach a torch state dict to numpy without importing torch here."""
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v)
    return out


_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32,
              np.dtype(np.complex128): np.complex64}


def _arr(x) -> np.ndarray:
    """A contiguous numpy array of x, 64-bit types narrowed as the JAX
    package's array conversion narrows them (64-bit types off)."""
    a = np.asarray(x)
    a = a.astype(_CANONICAL.get(a.dtype, a.dtype), copy=False)
    return a if a.flags.c_contiguous else np.array(a, order="C")


def _stack(arrs) -> np.ndarray:
    return _arr(np.stack(arrs, axis=0))


def _lin(w: np.ndarray) -> np.ndarray:
    """torch Linear weight [out, in] -> kernel [in, out]."""
    return _arr(w.T)


def _conv_patch(w: np.ndarray) -> np.ndarray:
    """torch Conv2d weight [W, C, P, P] -> patchify kernel [P*P*C, W].

    Must match vit.patchify's (ph, pw, c) flatten order.
    """
    out, c, p, _ = w.shape
    return _arr(w.transpose(2, 3, 1, 0).reshape(p * p * c, out))


# --------------------------------------------------------------------------
# HF CLIPModel
# --------------------------------------------------------------------------

def _hf_blocks(sd: StateDict, prefix: str, layers: int) -> Params:
    def g(i, name):
        return sd[f"{prefix}.layers.{i}.{name}"]

    return {
        "ln1_scale": _stack([g(i, "layer_norm1.weight") for i in range(layers)]),
        "ln1_bias": _stack([g(i, "layer_norm1.bias") for i in range(layers)]),
        "ln2_scale": _stack([g(i, "layer_norm2.weight") for i in range(layers)]),
        "ln2_bias": _stack([g(i, "layer_norm2.bias") for i in range(layers)]),
        "attn": {
            "wq": _stack([g(i, "self_attn.q_proj.weight").T for i in range(layers)]),
            "bq": _stack([g(i, "self_attn.q_proj.bias") for i in range(layers)]),
            "wk": _stack([g(i, "self_attn.k_proj.weight").T for i in range(layers)]),
            "bk": _stack([g(i, "self_attn.k_proj.bias") for i in range(layers)]),
            "wv": _stack([g(i, "self_attn.v_proj.weight").T for i in range(layers)]),
            "bv": _stack([g(i, "self_attn.v_proj.bias") for i in range(layers)]),
            "wo": _stack([g(i, "self_attn.out_proj.weight").T for i in range(layers)]),
            "bo": _stack([g(i, "self_attn.out_proj.bias") for i in range(layers)]),
        },
        "mlp": {
            "w1": _stack([g(i, "mlp.fc1.weight").T for i in range(layers)]),
            "b1": _stack([g(i, "mlp.fc1.bias") for i in range(layers)]),
            "w2": _stack([g(i, "mlp.fc2.weight").T for i in range(layers)]),
            "b2": _stack([g(i, "mlp.fc2.bias") for i in range(layers)]),
        },
    }


def hf_clip_vision(sd: StateDict, cfg: VITConfig) -> Params:
    """HF CLIPModel vision half (+ visual_projection) -> vit params."""
    # HF has a historical typo: "pre_layrnorm" in some versions.
    pre_ln = "vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd \
        else "vision_model.pre_layernorm"
    return {
        "patch_kernel": _conv_patch(sd["vision_model.embeddings.patch_embedding.weight"]),
        "class_embedding": _arr(sd["vision_model.embeddings.class_embedding"]),
        "positional_embedding": _arr(
            sd["vision_model.embeddings.position_embedding.weight"]
        ),
        "ln_pre_scale": _arr(sd[f"{pre_ln}.weight"]),
        "ln_pre_bias": _arr(sd[f"{pre_ln}.bias"]),
        "blocks": _hf_blocks(sd, "vision_model.encoder", cfg.layers),
        "ln_post_scale": _arr(sd["vision_model.post_layernorm.weight"]),
        "ln_post_bias": _arr(sd["vision_model.post_layernorm.bias"]),
        "proj": _lin(sd["visual_projection.weight"]),
    }


def hf_clip_text(sd: StateDict, cfg: TextConfig) -> Params:
    return {
        "token_embedding": _arr(sd["text_model.embeddings.token_embedding.weight"]),
        "positional_embedding": _arr(
            sd["text_model.embeddings.position_embedding.weight"]
        ),
        "blocks": _hf_blocks(sd, "text_model.encoder", cfg.layers),
        "ln_final_scale": _arr(sd["text_model.final_layer_norm.weight"]),
        "ln_final_bias": _arr(sd["text_model.final_layer_norm.bias"]),
        "text_projection": _lin(sd["text_projection.weight"]),
    }


def hf_clip(sd: StateDict, vision_cfg: VITConfig, text_cfg: TextConfig) -> Params:
    return {
        "visual": hf_clip_vision(sd, vision_cfg),
        "text": hf_clip_text(sd, text_cfg),
        "logit_scale": _arr(np.float32(sd["logit_scale"])),
    }


# --------------------------------------------------------------------------
# OpenAI clip package checkpoints (clip.load("ViT-B/32") state dict)
# --------------------------------------------------------------------------

def _openai_blocks(sd: StateDict, prefix: str, layers: int, width: int) -> Params:
    def g(i, name):
        return sd[f"{prefix}.resblocks.{i}.{name}"]

    wq, wk, wv, bq, bk, bv = [], [], [], [], [], []
    for i in range(layers):
        in_w = g(i, "attn.in_proj_weight")   # [3W, W]
        in_b = g(i, "attn.in_proj_bias")     # [3W]
        wq.append(in_w[:width].T); wk.append(in_w[width:2 * width].T)
        wv.append(in_w[2 * width:].T)
        bq.append(in_b[:width]); bk.append(in_b[width:2 * width])
        bv.append(in_b[2 * width:])
    return {
        "ln1_scale": _stack([g(i, "ln_1.weight") for i in range(layers)]),
        "ln1_bias": _stack([g(i, "ln_1.bias") for i in range(layers)]),
        "ln2_scale": _stack([g(i, "ln_2.weight") for i in range(layers)]),
        "ln2_bias": _stack([g(i, "ln_2.bias") for i in range(layers)]),
        "attn": {
            "wq": _stack(wq), "bq": _stack(bq),
            "wk": _stack(wk), "bk": _stack(bk),
            "wv": _stack(wv), "bv": _stack(bv),
            "wo": _stack([g(i, "attn.out_proj.weight").T for i in range(layers)]),
            "bo": _stack([g(i, "attn.out_proj.bias") for i in range(layers)]),
        },
        "mlp": {
            "w1": _stack([g(i, "mlp.c_fc.weight").T for i in range(layers)]),
            "b1": _stack([g(i, "mlp.c_fc.bias") for i in range(layers)]),
            "w2": _stack([g(i, "mlp.c_proj.weight").T for i in range(layers)]),
            "b2": _stack([g(i, "mlp.c_proj.bias") for i in range(layers)]),
        },
    }


def openai_clip(sd: StateDict, vision_cfg: VITConfig, text_cfg: TextConfig) -> Params:
    """OpenAI `clip` package checkpoint -> full dual-tower params."""
    visual = {
        "patch_kernel": _conv_patch(sd["visual.conv1.weight"]),
        "class_embedding": _arr(sd["visual.class_embedding"]),
        "positional_embedding": _arr(sd["visual.positional_embedding"]),
        "ln_pre_scale": _arr(sd["visual.ln_pre.weight"]),
        "ln_pre_bias": _arr(sd["visual.ln_pre.bias"]),
        "blocks": _openai_blocks(sd, "visual.transformer", vision_cfg.layers,
                                 vision_cfg.width),
        "ln_post_scale": _arr(sd["visual.ln_post.weight"]),
        "ln_post_bias": _arr(sd["visual.ln_post.bias"]),
        "proj": _arr(sd["visual.proj"]),  # already [W, D]
    }
    text = {
        "token_embedding": _arr(sd["token_embedding.weight"]),
        "positional_embedding": _arr(sd["positional_embedding"]),
        "blocks": _openai_blocks(sd, "transformer", text_cfg.layers, text_cfg.width),
        "ln_final_scale": _arr(sd["ln_final.weight"]),
        "ln_final_bias": _arr(sd["ln_final.bias"]),
        "text_projection": _arr(sd["text_projection"]),  # [W, D]
    }
    return {
        "visual": visual,
        "text": text,
        "logit_scale": _arr(np.float32(sd["logit_scale"])),
    }


# --------------------------------------------------------------------------
# HF BertForSequenceClassification (Taiyi text tower)
# --------------------------------------------------------------------------

def hf_bert_classifier(sd: StateDict, cfg: BertConfig) -> Params:
    def g(i, name):
        return sd[f"bert.encoder.layer.{i}.{name}"]

    layers = cfg.layers
    blocks = {
        "attn": {
            "wq": _stack([g(i, "attention.self.query.weight").T for i in range(layers)]),
            "bq": _stack([g(i, "attention.self.query.bias") for i in range(layers)]),
            "wk": _stack([g(i, "attention.self.key.weight").T for i in range(layers)]),
            "bk": _stack([g(i, "attention.self.key.bias") for i in range(layers)]),
            "wv": _stack([g(i, "attention.self.value.weight").T for i in range(layers)]),
            "bv": _stack([g(i, "attention.self.value.bias") for i in range(layers)]),
            "wo": _stack([g(i, "attention.output.dense.weight").T for i in range(layers)]),
            "bo": _stack([g(i, "attention.output.dense.bias") for i in range(layers)]),
        },
        "attn_ln_scale": _stack([g(i, "attention.output.LayerNorm.weight") for i in range(layers)]),
        "attn_ln_bias": _stack([g(i, "attention.output.LayerNorm.bias") for i in range(layers)]),
        "mlp": {
            "w1": _stack([g(i, "intermediate.dense.weight").T for i in range(layers)]),
            "b1": _stack([g(i, "intermediate.dense.bias") for i in range(layers)]),
            "w2": _stack([g(i, "output.dense.weight").T for i in range(layers)]),
            "b2": _stack([g(i, "output.dense.bias") for i in range(layers)]),
        },
        "out_ln_scale": _stack([g(i, "output.LayerNorm.weight") for i in range(layers)]),
        "out_ln_bias": _stack([g(i, "output.LayerNorm.bias") for i in range(layers)]),
    }
    return {
        "word_embeddings": _arr(sd["bert.embeddings.word_embeddings.weight"]),
        "position_embeddings": _arr(sd["bert.embeddings.position_embeddings.weight"]),
        "token_type_embeddings": _arr(sd["bert.embeddings.token_type_embeddings.weight"]),
        "emb_ln_scale": _arr(sd["bert.embeddings.LayerNorm.weight"]),
        "emb_ln_bias": _arr(sd["bert.embeddings.LayerNorm.bias"]),
        "blocks": blocks,
        "pooler_kernel": _lin(sd["bert.pooler.dense.weight"]),
        "pooler_bias": _arr(sd["bert.pooler.dense.bias"]),
        "classifier_kernel": _lin(sd["classifier.weight"]),
        "classifier_bias": _arr(sd["classifier.bias"]),
    }


# --------------------------------------------------------------------------
# HF LLaMA / LLaVA (mmrs_tpu/models/llava.py: hf_llama, hf_llava)
# --------------------------------------------------------------------------

def hf_llama(sd, cfg, prefix: str = "model") -> Params:
    """HF LlamaForCausalLM state dict -> llama params (cfg: LlamaConfig)."""
    def g(i, name):
        return sd[f"{prefix}.layers.{i}.{name}"]

    L = cfg.layers

    def stack_t(name):
        return _arr(np.stack([g(i, name).T for i in range(L)]))

    def stack(name):
        return _arr(np.stack([g(i, name) for i in range(L)]))

    embed = _arr(sd[f"{prefix}.embed_tokens.weight"])
    lm_head = (_arr(sd["lm_head.weight"].T)
               if "lm_head.weight" in sd else _arr(embed.T))
    return {
        "embed": embed,
        "blocks": {
            "attn_norm": stack("input_layernorm.weight"),
            "wq": stack_t("self_attn.q_proj.weight"),
            "wk": stack_t("self_attn.k_proj.weight"),
            "wv": stack_t("self_attn.v_proj.weight"),
            "wo": stack_t("self_attn.o_proj.weight"),
            "mlp_norm": stack("post_attention_layernorm.weight"),
            "w_gate": stack_t("mlp.gate_proj.weight"),
            "w_up": stack_t("mlp.up_proj.weight"),
            "w_down": stack_t("mlp.down_proj.weight"),
        },
        "final_norm": _arr(sd[f"{prefix}.norm.weight"]),
        "lm_head": lm_head,
    }


def hf_llava(sd, cfg) -> Params:
    """HF LlavaForConditionalGeneration state dict -> llava params (cfg:
    LLaVAConfig).

    Accepts both HF key layouts: the llava-v1.5 release layout
    ("vision_tower....", "language_model.model....",
    "language_model.lm_head.weight") and the transformers >= 4.52 layout
    (everything under "model.", lm_head hoisted to the top level)."""
    sd = {k.replace("model.vision_tower.vision_tower.", "vision_tower.")
           .replace("model.vision_tower.", "vision_tower.")
           .replace("model.multi_modal_projector.",
                    "multi_modal_projector.")
           .replace("model.language_model.", "language_model.model.")
          : v for k, v in sd.items()}

    # vision tower keys are nested under vision_tower.
    vt = {k[len("vision_tower."):]: v for k, v in sd.items()
          if k.startswith("vision_tower.")}
    # hf_clip_vision expects a visual_projection; LLaVA has none — fake it
    # (proj unused because the verifier takes layer -2 features).
    vt["visual_projection.weight"] = np.zeros(
        (cfg.vision.embed_dim, cfg.vision.width), np.float32)
    visual = hf_clip_vision(vt, cfg.vision)

    lm_sd = {k[len("language_model."):]: v for k, v in sd.items()
             if k.startswith("language_model.")}
    # llava-v1.5's lm_head is UNTIED; the >=4.52 layout hoists it to the
    # top level, where the prefix strip above would lose it and hf_llama
    # would silently fall back to tied embeddings — wrong logits.
    if "lm_head.weight" not in lm_sd and "lm_head.weight" in sd:
        lm_sd["lm_head.weight"] = sd["lm_head.weight"]
    return {
        "visual": visual,
        "proj_w1": _arr(sd["multi_modal_projector.linear_1.weight"].T),
        "proj_b1": _arr(sd["multi_modal_projector.linear_1.bias"]),
        "proj_w2": _arr(sd["multi_modal_projector.linear_2.weight"].T),
        "proj_b2": _arr(sd["multi_modal_projector.linear_2.bias"]),
        "lm": hf_llama(lm_sd, cfg.lm),
    }
