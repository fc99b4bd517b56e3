"""Carry weights from the JAX package's param tree onto the port's modules.

The only place that knows both layouts:
  - mmrs_tpu stacks every per-layer leaf along a leading layer axis (for
    `lax.scan`); the port holds one module per layer;
  - mmrs_tpu keeps matmul kernels as [in, out]; the port's `nn.Linear`
    weights are [out, in], so kernels are transposed here.

Leaves may be numpy arrays (f32, or ml_dtypes bf16) or torch tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from mmrs_tpu_torch.models import checkpoint
from mmrs_tpu_torch.models.clip import CLIP, CLIPConfig


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":           # ml_dtypes, without importing it
        return checkpoint.bf16_from_bits(x.view(np.uint16))
    return torch.from_numpy(np.array(x))


def _tensors(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return _tensor(tree)


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
            sd[f"{p}.attn.w{name}.weight"] = attn[f"w{name}"][i].T
            sd[f"{p}.attn.w{name}.bias"] = attn[f"b{name}"][i]
        for j in ("1", "2"):
            sd[f"{p}.mlp.w{j}.weight"] = mlp[f"w{j}"][i].T
            sd[f"{p}.mlp.w{j}.bias"] = mlp[f"b{j}"][i]


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The CLIP module's state dict from a JAX `clip.init`-shaped tree."""
    tree = _tensors(tree)
    vis, txt = tree["visual"], tree["text"]
    sd: Dict[str, torch.Tensor] = {
        "visual.patch_embed.weight": vis["patch_kernel"].T,
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
    _blocks("visual", vis["blocks"], sd)
    _blocks("text", txt["blocks"], sd)
    return sd


def from_jax_params(tree: Dict[str, Any], cfg: CLIPConfig) -> CLIP:
    """A CLIP module (f32 parameters, on the CPU) holding the tree's
    weights. Shapes are checked against `cfg` by `load_state_dict`."""
    model = CLIP(cfg)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model


def load_npz(path: str, cfg: CLIPConfig) -> CLIP:
    """A CLIP module from an npz written by mmrs_tpu's checkpoint.save_npz."""
    return from_jax_params(checkpoint.load_npz(path), cfg)
