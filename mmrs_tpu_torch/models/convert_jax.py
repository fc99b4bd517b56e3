"""Carry weights between the JAX package's param tree and the port's modules.

The only place that knows both layouts:
  - mmrs_tpu stacks every per-layer leaf along a leading layer axis (for
    `lax.scan`); the port holds one module per layer;
  - mmrs_tpu keeps matmul kernels as [in, out]; the port's `nn.Linear`
    weights are [out, in], so kernels are transposed here;
  - an int8 kernel (`QTensor(q [K, N], s [N])` in a tree, a `QWeight`
    from checkpoint.load_npz) becomes a `QLinear` with q transposed;
  - an int4 kernel (`QTensor4(packed [K / 2, N], s [K / G, N])`, the
    int4-weight LLaMA's) becomes a `QLinear4` with packed transposed.

Leaves may be numpy arrays (f32, or ml_dtypes bf16), torch tensors, int8
pairs with fields (q, s) or int4 pairs with fields (packed, s). The LLaMA / LLaVA modules are built on the
meta device and take the tree's tensors as they are (dtype kept, moved to
`device`), so a 7B checkpoint is never materialized twice.
`llava_tree` / `llama_tree` go the other way, for checkpoint.save_npz.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from mmrs_tpu_torch.models import checkpoint
from mmrs_tpu_torch.models.clip import (CLIP, CLIPConfig, TaiyiCLIP,
                                        TaiyiCLIPConfig)
from mmrs_tpu_torch.models.layers import QLinear, QLinear4
from mmrs_tpu_torch.models.llama import Llama, LlamaConfig
from mmrs_tpu_torch.models.llava import LLaVA, LLaVAConfig


class QWeight4(NamedTuple):
    """An int4 kernel in the JAX layout: packed int8 [..., K / 2, N] and f32
    scales [..., K / G, N] (mmrs_tpu layers.QTensor4's fields)."""
    packed: torch.Tensor
    s: torch.Tensor


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":           # ml_dtypes, without importing it
        return checkpoint.bf16_from_bits(x.view(np.uint16))
    return torch.from_numpy(np.array(x))


def _is_int8(x: Any) -> bool:
    return getattr(x, "_fields", None) == ("q", "s")


def _tensors(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if _is_int8(tree):      # mmrs_tpu's QTensor, or a QWeight
        return checkpoint.QWeight(_tensor(tree.q), _tensor(tree.s))
    if getattr(tree, "_fields", None) == ("packed", "s"):   # QTensor4
        return QWeight4(_tensor(tree.packed), _tensor(tree.s))
    return _tensor(tree)


def _linear(sd: Dict[str, torch.Tensor], name: str, kernel: Any,
            bias: Any = None) -> None:
    """State-dict entries of one layer from a JAX [K, N] kernel."""
    if isinstance(kernel, checkpoint.QWeight):
        sd[f"{name}.q"] = kernel.q.T
        sd[f"{name}.s"] = kernel.s
    elif isinstance(kernel, QWeight4):
        sd[f"{name}.packed"] = kernel.packed.T
        sd[f"{name}.s"] = kernel.s
    else:
        sd[f"{name}.weight"] = kernel.T
    if bias is not None:
        sd[f"{name}.bias"] = bias


def _layer(leaf: Any, i: int) -> Any:
    if isinstance(leaf, checkpoint.QWeight):
        return checkpoint.QWeight(leaf.q[i], leaf.s[i])
    if isinstance(leaf, QWeight4):
        return QWeight4(leaf.packed[i], leaf.s[i])
    return leaf[i]


def _blocks(prefix: str, stacked: Dict[str, Any], sd: Dict[str, torch.Tensor]
            ) -> None:
    attn, mlp = stacked["attn"], stacked["mlp"]
    n_layers = stacked["ln1_scale"].shape[0]
    for i in range(n_layers):
        p = f"{prefix}.blocks.{i}"
        for ln in ("ln1", "ln2"):
            sd[f"{p}.{ln}.weight"] = stacked[f"{ln}_scale"][i]
            sd[f"{p}.{ln}.bias"] = stacked[f"{ln}_bias"][i]
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{p}.attn.w{name}", _layer(attn[f"w{name}"], i),
                    attn[f"b{name}"][i])
        for j in ("1", "2"):
            _linear(sd, f"{p}.mlp.w{j}", _layer(mlp[f"w{j}"], i),
                    mlp[f"b{j}"][i])


def _visual_sd(vis: Dict[str, Any], sd: Dict[str, torch.Tensor],
               prefix: str = "visual") -> None:
    """State-dict entries of a ViT from a JAX `vit.init`-shaped tree."""
    sd.update({
        f"{prefix}.class_embedding": vis["class_embedding"],
        f"{prefix}.positional_embedding": vis["positional_embedding"],
        f"{prefix}.ln_pre.weight": vis["ln_pre_scale"],
        f"{prefix}.ln_pre.bias": vis["ln_pre_bias"],
        f"{prefix}.ln_post.weight": vis["ln_post_scale"],
        f"{prefix}.ln_post.bias": vis["ln_post_bias"],
        f"{prefix}.proj.weight": vis["proj"].T,
    })
    _linear(sd, f"{prefix}.patch_embed", vis["patch_kernel"])
    _blocks(prefix, vis["blocks"], sd)


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The CLIP module's state dict from a JAX `clip.init`-shaped tree."""
    tree = _tensors(tree)
    txt = tree["text"]
    sd: Dict[str, torch.Tensor] = {
        "text.token_embedding.weight": txt["token_embedding"],
        "text.positional_embedding": txt["positional_embedding"],
        "text.ln_final.weight": txt["ln_final_scale"],
        "text.ln_final.bias": txt["ln_final_bias"],
        "text.text_projection.weight": txt["text_projection"].T,
        "logit_scale": tree["logit_scale"].reshape(()),
    }
    _visual_sd(tree["visual"], sd)
    _blocks("text", txt["blocks"], sd)
    return sd


def _bert_sd(bert: Dict[str, Any], sd: Dict[str, torch.Tensor],
             prefix: str = "text") -> None:
    """State-dict entries of the Taiyi text tower from a JAX `bert.init`
    tree (models/bert.py)."""
    sd.update({
        f"{prefix}.word_embeddings": bert["word_embeddings"],
        f"{prefix}.position_embeddings": bert["position_embeddings"],
        f"{prefix}.token_type_embeddings": bert["token_type_embeddings"],
        f"{prefix}.emb_ln.weight": bert["emb_ln_scale"],
        f"{prefix}.emb_ln.bias": bert["emb_ln_bias"],
    })
    _linear(sd, f"{prefix}.pooler", bert["pooler_kernel"],
            bert["pooler_bias"])
    _linear(sd, f"{prefix}.classifier", bert["classifier_kernel"],
            bert["classifier_bias"])
    blocks = bert["blocks"]
    attn, mlp = blocks["attn"], blocks["mlp"]
    for i in range(blocks["attn_ln_scale"].shape[0]):
        p = f"{prefix}.blocks.{i}"
        for ln in ("attn_ln", "out_ln"):
            sd[f"{p}.{ln}.weight"] = blocks[f"{ln}_scale"][i]
            sd[f"{p}.{ln}.bias"] = blocks[f"{ln}_bias"][i]
        for name in ("q", "k", "v", "o"):
            _linear(sd, f"{p}.attn.w{name}", _layer(attn[f"w{name}"], i),
                    attn[f"b{name}"][i])
        for j in ("1", "2"):
            _linear(sd, f"{p}.mlp.w{j}", _layer(mlp[f"w{j}"], i),
                    mlp[f"b{j}"][i])


def from_jax_taiyi(tree: Dict[str, Any], cfg: TaiyiCLIPConfig) -> TaiyiCLIP:
    """A Taiyi pair (f32 parameters, on the CPU) from a JAX
    `clip.taiyi_init`-shaped tree {"visual", "text", "logit_scale"}: the
    tree mmrs_tpu's pipeline loads for `text_tower: taiyi_roberta`; int8
    vision kernels become `QLinear` layers."""
    tree = _tensors(tree)
    sd: Dict[str, torch.Tensor] = {
        "logit_scale": tree["logit_scale"].reshape(())}
    _visual_sd(tree["visual"], sd)
    _bert_sd(tree["text"], sd)
    model = TaiyiCLIP(cfg)
    _int8_layers(model, sd)
    model.load_state_dict(sd, strict=True)
    return model


def _int8_layers(model: torch.nn.Module, sd: Dict[str, torch.Tensor]
                 ) -> None:
    """Swap in a `QLinear` wherever the state dict holds int8 codes, a
    `QLinear4` wherever it holds packed int4 codes."""
    for key in [k for k in sd if k.endswith((".q", ".packed"))]:
        path = key.rpartition(".")[0]
        parent, _, attr = path.rpartition(".")
        if key.endswith(".q"):
            layer = QLinear(*sd[key].shape, bias=f"{path}.bias" in sd)
        else:
            out, half = sd[key].shape
            layer = QLinear4(out, 2 * half, sd[f"{path}.s"].shape[0])
        setattr(model.get_submodule(parent), attr, layer)


def from_jax_params(tree: Dict[str, Any], cfg: CLIPConfig) -> CLIP:
    """A CLIP module (f32 parameters, on the CPU) holding the tree's
    weights; int8 kernels become `QLinear` layers. Shapes are checked
    against `cfg` by `load_state_dict`."""
    model = CLIP(cfg)
    sd = state_dict_from_jax(tree)
    _int8_layers(model, sd)
    model.load_state_dict(sd, strict=True)
    return model


def _llama_sd(lm: Dict[str, Any], sd: Dict[str, torch.Tensor],
              prefix: str = "") -> None:
    blocks = lm["blocks"]
    sd[f"{prefix}embed"] = lm["embed"]
    sd[f"{prefix}final_norm"] = lm["final_norm"]
    _linear(sd, f"{prefix}lm_head", lm["lm_head"])
    for i in range(blocks["attn_norm"].shape[0]):
        p = f"{prefix}blocks.{i}"
        sd[f"{p}.attn_norm"] = blocks["attn_norm"][i]
        sd[f"{p}.mlp_norm"] = blocks["mlp_norm"][i]
        for name in _LLAMA_LINEARS:
            _linear(sd, f"{p}.{name}", _layer(blocks[name], i))


_LLAMA_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _assign(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
            device) -> torch.nn.Module:
    """Load a meta-device module with the state dict's own tensors (their
    dtypes kept), each moved to `device` and made contiguous there."""
    with torch.device("meta"):         # placeholders: nothing allocated
        _int8_layers(model, sd)
    sd = {k: v.to(device).contiguous() for k, v in sd.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.requires_grad_(False)


def from_jax_llama(tree: Dict[str, Any], cfg: LlamaConfig,
                   device="cpu") -> Llama:
    """A Llama module holding a JAX `llama.init`-shaped tree's weights."""
    sd: Dict[str, torch.Tensor] = {}
    _llama_sd(_tensors(tree), sd)
    with torch.device("meta"):
        model = Llama(cfg)
    return _assign(model, sd, device)


def from_jax_llava(tree: Dict[str, Any], cfg: LLaVAConfig,
                   device="cpu") -> LLaVA:
    """A LLaVA module holding a JAX `llava.init`-shaped tree's weights (or
    a checkpoint.load_npz tree of one)."""
    tree = _tensors(tree)
    sd: Dict[str, torch.Tensor] = {}
    _visual_sd(tree["visual"], sd)
    _linear(sd, "proj1", tree["proj_w1"], tree["proj_b1"])
    _linear(sd, "proj2", tree["proj_w2"], tree["proj_b2"])
    _llama_sd(tree["lm"], sd, "lm.")
    with torch.device("meta"):
        model = LLaVA(cfg)
    return _assign(model, sd, device)


# -- the port's modules -> the JAX layout (for checkpoint.save_npz) ----------

def _kernel(layer) -> Any:
    """A linear layer's JAX [K, N] kernel: a tensor, a QWeight or a
    QWeight4."""
    if isinstance(layer, QLinear):
        return checkpoint.QWeight(layer.q.T, layer.s)
    if isinstance(layer, QLinear4):
        return QWeight4(layer.packed.T, layer.s)
    return layer.weight.T


def _stack(leaves) -> Any:
    if isinstance(leaves[0], checkpoint.QWeight):
        return checkpoint.QWeight(torch.stack([x.q for x in leaves]),
                                  torch.stack([x.s for x in leaves]))
    if isinstance(leaves[0], QWeight4):
        return QWeight4(torch.stack([x.packed for x in leaves]),
                        torch.stack([x.s for x in leaves]))
    return torch.stack(leaves)


def llama_tree(model: Llama) -> Dict[str, Any]:
    """The JAX `llama.init` tree of a Llama module (stacked layers)."""
    blocks = {name: _stack([_kernel(getattr(b, name)) for b in model.blocks])
              for name in _LLAMA_LINEARS}
    for norm in ("attn_norm", "mlp_norm"):
        blocks[norm] = torch.stack([getattr(b, norm) for b in model.blocks])
    return {"embed": model.embed, "blocks": blocks,
            "final_norm": model.final_norm,
            "lm_head": _kernel(model.lm_head)}


def _blocks_tree(blocks) -> Dict[str, Any]:
    """The JAX stacked `blocks` tree of a list of CLIP-style blocks."""
    blocks = list(blocks)

    def per(fn):
        return _stack([fn(b) for b in blocks])

    attn = {}
    for n in ("q", "k", "v", "o"):
        attn[f"w{n}"] = per(lambda b: _kernel(getattr(b.attn, f"w{n}")))
        attn[f"b{n}"] = per(lambda b: getattr(b.attn, f"w{n}").bias)
    mlp = {}
    for j in ("1", "2"):
        mlp[f"w{j}"] = per(lambda b: _kernel(getattr(b.mlp, f"w{j}")))
        mlp[f"b{j}"] = per(lambda b: getattr(b.mlp, f"w{j}").bias)
    stacked = {"attn": attn, "mlp": mlp}
    for ln in ("ln1", "ln2"):
        stacked[f"{ln}_scale"] = per(lambda b: getattr(b, ln).weight)
        stacked[f"{ln}_bias"] = per(lambda b: getattr(b, ln).bias)
    return stacked


def _vit_tree(vit) -> Dict[str, Any]:
    return {
        "patch_kernel": _kernel(vit.patch_embed),
        "class_embedding": vit.class_embedding,
        "positional_embedding": vit.positional_embedding,
        "ln_pre_scale": vit.ln_pre.weight, "ln_pre_bias": vit.ln_pre.bias,
        "blocks": _blocks_tree(vit.blocks),
        "ln_post_scale": vit.ln_post.weight, "ln_post_bias": vit.ln_post.bias,
        "proj": vit.proj.weight.T,
    }


def clip_tree(model: CLIP) -> Dict[str, Any]:
    """The JAX `clip.init` tree of a CLIP module (for checkpoint.save_npz:
    the npz both packages' build_towers load)."""
    txt = model.text
    return {"visual": _vit_tree(model.visual),
            "text": {"token_embedding": txt.token_embedding.weight,
                     "positional_embedding": txt.positional_embedding,
                     "blocks": _blocks_tree(txt.blocks),
                     "ln_final_scale": txt.ln_final.weight,
                     "ln_final_bias": txt.ln_final.bias,
                     "text_projection": txt.text_projection.weight.T},
            "logit_scale": model.logit_scale}


def llava_tree(model: LLaVA) -> Dict[str, Any]:
    """The JAX `llava.init` tree of a LLaVA module."""
    return {"visual": _vit_tree(model.visual),
            "proj_w1": model.proj1.weight.T, "proj_b1": model.proj1.bias,
            "proj_w2": model.proj2.weight.T, "proj_b2": model.proj2.bias,
            "lm": llama_tree(model.lm)}


def load_npz(path: str, cfg) -> torch.nn.Module:
    """A CLIP module (or, for a `TaiyiCLIPConfig`, a Taiyi pair) from an
    npz written by either package's checkpoint.save_npz."""
    tree = checkpoint.load_npz(path)
    if isinstance(cfg, TaiyiCLIPConfig):
        return from_jax_taiyi(tree, cfg)
    return from_jax_params(tree, cfg)
