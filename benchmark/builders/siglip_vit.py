"""The port's SigLIP pair over the benchmark's weights (kind "siglip_vit").

`build` calls `pipeline.build_towers` as `mmrs-torch index` does, with
the image tower the configuration names and the benchmark's device-made
tensors as the pair's weights (`weights=`: the names of
`reference/siglip_vit.weight_shapes` and `reference/siglip_text.
weight_shapes`, plus the pair's `logit_scale` and `logit_bias`), in the
configuration's dtype or the control's int8 tower. The port's presets
must have the configuration file's sizes, or the run stops; a port that
lacks the tower stops at once, naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

# configuration-file key -> the port's config attribute, per tower
SIZES = {
    "image_tower": {"image_size": "image_size", "patch_size": "patch_size",
                    "width": "width", "layers": "layers", "heads": "heads",
                    "mlp_width": "hidden", "embed_dim": "embed_dim",
                    "activation": "act", "layer_norm_eps": "layer_norm_eps",
                    "image_mean": "mean", "image_std": "std"},
    "text_tower": {"vocab_size": "vocab_size",
                   "context_length": "context_length", "width": "width",
                   "layers": "layers", "heads": "heads",
                   "mlp_width": "hidden", "embed_dim": "embed_dim",
                   "activation": "act", "layer_norm_eps": "layer_norm_eps"},
}
LOGIT_BIAS = -10.0     # SigLIP's initial b (the pair's sigmoid bias)


def presets(cfg: Dict):
    """The port's (image, text) configs of the configuration's towers."""
    from mmrs_tpu_torch.models import configs

    port = cfg["port"]
    for key, table in (("image_tower", configs.IMAGE_TOWERS),
                       ("text_tower", configs.TEXT_TOWERS)):
        if port[key] not in table:
            raise ValueError(f"the port has no {key.replace('_', ' ')} "
                             f"{port[key]!r}")
    return (configs.IMAGE_TOWERS[port["image_tower"]],
            configs.TEXT_TOWERS[port["text_tower"]])


def check_sizes(cfg: Dict) -> None:
    """Stop unless the port's presets hold the file's sizes."""
    for key, port in zip(("image_tower", "text_tower"), presets(cfg)):
        for name, attr in SIZES[key].items():
            want, have = cfg[key][name], getattr(port, attr)
            if (list(have) if isinstance(have, tuple) else have) != want:
                raise ValueError(f"{key}.{name}: the configuration file "
                                 f"says {want}, the port's preset {have}")


def build(cfg: Dict, weights: Dict[str, torch.Tensor], device,
          dtype: str = ""):
    """`pipeline.build_towers` over the benchmark's weights. `dtype`
    overrides the configuration's (the control runs the int8 tower)."""
    check_sizes(cfg)
    from mmrs_tpu_torch import config as port_config
    from mmrs_tpu_torch import pipeline

    model_cfg = dataclasses.replace(
        port_config.ModelConfig(), image_tower=cfg["port"]["image_tower"],
        text_tower=cfg["port"]["text_tower"], dtype=dtype or cfg["dtype"])
    pcfg = dataclasses.replace(port_config.Config(), model=model_cfg)
    state = dict(weights, logit_bias=torch.tensor(LOGIT_BIAS, device=device))
    return pipeline.build_towers(pcfg, device=device, weights=state)
