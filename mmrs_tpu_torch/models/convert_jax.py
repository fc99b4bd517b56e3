"""Carry weights from the JAX package's param tree onto the port's modules.

The only place that knows both layouts:
  - mmrs_tpu stacks every per-layer leaf along a leading layer axis (for
    `lax.scan`); the port holds one module per layer;
  - mmrs_tpu keeps matmul kernels as [in, out]; the port's `nn.Linear`
    weights are [out, in], so kernels are transposed here;
  - an int8 kernel (`QTensor(q [K, N], s [N])` in a tree, a `QWeight`
    from checkpoint.load_npz) becomes a `QLinear` with q transposed.

Leaves may be numpy arrays (f32, or ml_dtypes bf16), torch tensors, or
int8 pairs with fields (q, s).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from mmrs_tpu_torch.models import checkpoint
from mmrs_tpu_torch.models.clip import CLIP, CLIPConfig
from mmrs_tpu_torch.models.layers import QLinear


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
    return _tensor(tree)


def _linear(sd: Dict[str, torch.Tensor], name: str, kernel: Any,
            bias: Any = None) -> None:
    """State-dict entries of one layer from a JAX [K, N] kernel."""
    if isinstance(kernel, checkpoint.QWeight):
        sd[f"{name}.q"] = kernel.q.T
        sd[f"{name}.s"] = kernel.s
    else:
        sd[f"{name}.weight"] = kernel.T
    if bias is not None:
        sd[f"{name}.bias"] = bias


def _layer(leaf: Any, i: int) -> Any:
    if isinstance(leaf, checkpoint.QWeight):
        return checkpoint.QWeight(leaf.q[i], leaf.s[i])
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


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The CLIP module's state dict from a JAX `clip.init`-shaped tree."""
    tree = _tensors(tree)
    vis, txt = tree["visual"], tree["text"]
    sd: Dict[str, torch.Tensor] = {
        "visual.class_embedding": vis["class_embedding"],
        "visual.positional_embedding": vis["positional_embedding"],
        "visual.ln_pre.weight": vis["ln_pre_scale"],
        "visual.ln_pre.bias": vis["ln_pre_bias"],
        "visual.ln_post.weight": vis["ln_post_scale"],
        "visual.ln_post.bias": vis["ln_post_bias"],
        "visual.proj.weight": vis["proj"].T,
        "text.token_embedding.weight": txt["token_embedding"],
        "text.positional_embedding": txt["positional_embedding"],
        "text.ln_final.weight": txt["ln_final_scale"],
        "text.ln_final.bias": txt["ln_final_bias"],
        "text.text_projection.weight": txt["text_projection"].T,
        "logit_scale": tree["logit_scale"].reshape(()),
    }
    _linear(sd, "visual.patch_embed", vis["patch_kernel"])
    _blocks("visual", vis["blocks"], sd)
    _blocks("text", txt["blocks"], sd)
    return sd


def from_jax_params(tree: Dict[str, Any], cfg: CLIPConfig) -> CLIP:
    """A CLIP module (f32 parameters, on the CPU) holding the tree's
    weights; int8 kernels become `QLinear` layers. Shapes are checked
    against `cfg` by `load_state_dict`."""
    model = CLIP(cfg)
    sd = state_dict_from_jax(tree)
    for key in [k for k in sd if k.endswith(".q")]:
        path = key[:-2]
        parent, _, attr = path.rpartition(".")
        setattr(model.get_submodule(parent), attr,
                QLinear(*sd[key].shape, bias=f"{path}.bias" in sd))
    model.load_state_dict(sd, strict=True)
    return model


def load_npz(path: str, cfg: CLIPConfig) -> CLIP:
    """A CLIP module from an npz written by mmrs_tpu's checkpoint.save_npz."""
    return from_jax_params(checkpoint.load_npz(path), cfg)
