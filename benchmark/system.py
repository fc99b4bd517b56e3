"""The system under test, built through the port's own entry points.

`towers` calls `pipeline.build_towers` as `mmrs-torch index` and `serve`
do, with a checkpoint: the benchmark's device-made weights take the place
of the npz file that `models.convert_jax.load_npz` would read, loaded
into the port's own model classes with `load_state_dict(assign=True)`.
The port's configuration presets must have the configuration file's
sizes, or the run stops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict
from unittest import mock

import torch

CHECKPOINT = "<weights made by the benchmark>"

# configuration-file key -> port config attribute, per tower kind
SIZES = {
    "vit": {"image_size": "image_size", "patch_size": "patch_size",
            "width": "width", "layers": "layers", "heads": "heads",
            "embed_dim": "embed_dim"},
    "clip_text": {"vocab_size": "vocab_size",
                  "context_length": "context_length", "width": "width",
                  "layers": "layers", "heads": "heads",
                  "embed_dim": "embed_dim"},
    "bert": {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
             "layers": "layers", "heads": "heads",
             "intermediate_size": "intermediate_size",
             "max_position_embeddings": "max_position_embeddings",
             "type_vocab_size": "type_vocab_size",
             "num_labels": "num_labels",
             "layer_norm_eps": "layer_norm_eps"},
}


def check_sizes(cfg: Dict, ccfg) -> None:
    """Stop unless the port's tower configs hold the file's sizes."""
    for key, port in (("image_tower", ccfg.vision), ("text_tower", ccfg.text)):
        spec = cfg[key]
        for name, attr in SIZES[spec["kind"]].items():
            if getattr(port, attr) != spec[name]:
                raise ValueError(f"{key}.{name}: the configuration file says "
                                 f"{spec[name]}, the port's preset "
                                 f"{getattr(port, attr)}")


def tokenizer(cfg: Dict, vocab):
    """The port's tokenizer over the benchmark's vocabulary."""
    from mmrs_tpu_torch.models.tokenizer import (BertWordPieceTokenizer,
                                                 CLIPTokenizer)

    spec = cfg["text_tower"]
    if spec["kind"] == "clip_text":
        return CLIPTokenizer(vocab, context_length=spec["context_length"])
    return BertWordPieceTokenizer(vocab, max_length=spec["max_length"])


def towers(cfg: Dict, weights: Dict[str, torch.Tensor], tok, device,
           dtype: str = ""):
    """`pipeline.build_towers` over the benchmark's weights. `dtype`
    overrides the configuration's (the control runs the int8 tower)."""
    from mmrs_tpu_torch import config as port_config
    from mmrs_tpu_torch import pipeline
    from mmrs_tpu_torch.models import convert_jax
    from mmrs_tpu_torch.models.clip import CLIP, TaiyiCLIP, TaiyiCLIPConfig

    port = cfg["port"]
    model_cfg = dataclasses.replace(
        port_config.ModelConfig(), image_tower=port["image_tower"],
        text_tower=port["text_tower"], dtype=dtype or cfg["dtype"],
        checkpoint_path=CHECKPOINT)
    pcfg = dataclasses.replace(port_config.Config(), model=model_cfg)

    def load(path, ccfg):
        if path != CHECKPOINT:
            raise ValueError(f"unexpected checkpoint {path!r}")
        check_sizes(cfg, ccfg)
        make = TaiyiCLIP if isinstance(ccfg, TaiyiCLIPConfig) else CLIP
        with torch.device("meta"):
            model = make(ccfg)
        model.load_state_dict(weights, strict=True, assign=True)
        return model

    with mock.patch.object(convert_jax, "load_npz", load):
        return pipeline.build_towers(pcfg, tokenizer=tok, device=device)


def free_device() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
