"""Seeded random weights, made on the device in the dtype they are served in.

Every parameter of a configuration's parts is named and shaped by its
reference module (`reference/<kind>.weight_shapes`): the pair's two
towers (`make`), or a verifier's tower, projector and decoder (`draw`
over the list its reference gives); the parameters of one distribution
are drawn by one call of a device generator and handed out as views.
Matmul weights are bfloat16 (the served dtype); embeddings, biases and
LayerNorm parameters float32, as the served towers keep them. Biases and
LayerNorm parameters are random too, so that a path that drops one
shows.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Sequence, Tuple

import torch

TOWERS = (("image_tower", "visual"), ("text_tower", "text"))


def shapes(cfg: Dict) -> List[Tuple[str, tuple, str, Dict]]:
    """(name, shape, init, tower spec) of every parameter of the pair."""
    out = []
    for key, prefix in TOWERS:
        spec = cfg[key]
        ref = importlib.import_module(f"benchmark.reference.{spec['kind']}")
        out += [(n, s, init, spec) for n, s, init in
                ref.weight_shapes(spec, prefix)]
    return out


# LayerNorm gains: in a tower whose spec sets `ln_outlier_gain`, a seeded
# share of channels is that many times larger, the outlier features of
# trained transformers (Dettmers et al. 2022, "LLM.int8()"; Sun et al.
# 2024, "Massive Activations"), which per-row int8 rounding handles worst
OUTLIER_SHARE = 1 / 64


def _law(init: str, shape: tuple, spec: Dict
         ) -> Tuple[torch.dtype, float, float, float]:
    """(dtype, mean, std, outlier gain) of one parameter. Matmul weights
    keep the variance of their input (std fan_in^-1/2), so that every
    block moves the residual stream and different inputs embed apart, as
    in a trained tower."""
    width = spec.get("width", spec.get("hidden_size"))
    return {
        "weight": (torch.bfloat16, 0.0, shape[-1] ** -0.5, 1.0),
        "projection": (torch.bfloat16, 0.0, width ** -0.5, 1.0),
        "bias": (torch.float32, 0.0, 0.02, 1.0),
        "ln_weight": (torch.float32, 1.0, 0.05,
                      float(spec.get("ln_outlier_gain", 1.0))),
        "embedding": (torch.float32, 0.0, 0.02, 1.0),
        "embedding_small": (torch.float32, 0.0, 0.01, 1.0),
        "embedding_wide": (torch.float32, 0.0, width ** -0.5, 1.0),
    }[init]


def draw(params: Sequence[Tuple[str, tuple, str, Dict]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """The parameters (name, shape, init, spec of the part each belongs
    to) drawn from `seed` on `device`, in the dtype they are served in:
    one draw a law, handed out as views."""
    groups: Dict[Tuple, List[Tuple[str, tuple]]] = {}
    for name, shape, init, spec in params:
        groups.setdefault(_law(init, shape, spec), []).append((name, shape))
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for law in sorted(groups, key=str):
        dtype, mean, std, gain = law
        leaves = groups[law]
        sizes = [math.prod(s) for _, s in leaves]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dtype)
        flat.mul_(std).add_(mean)
        if gain != 1.0:
            pick = torch.rand(flat.shape, generator=gen, device=device)
            flat[pick < OUTLIER_SHARE] *= gain
        for (name, shape), part in zip(leaves, flat.split(sizes)):
            out[name] = part.view(shape)
    return out


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The pair's weights from `seed`, on `device`."""
    out = draw(shapes(cfg), seed, device)
    out["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device)
    return out
