"""int8 serving quantization for the towers and the VLM (opt-in, serving
only).

Counterpart of mmrs_tpu/models/quantize.py. CLIP towers: the six
block matmuls and the patch embedding become `QLinear` layers
(per-output-channel symmetric int8 weights, codes and scales bit-identical
to the JAX package's `quantize_weight`); activations are quantized per row
at call time (models/layers.py). LayerNorm, softmax, residuals, the
embeddings and the final projection stay in the bf16/f32 serving mix.
LLaMA adds its gated MLP and the (dim x vocab) lm_head; its embedding table
stays unquantized (a lookup). LLaVA quantizes its vision tower and its
decoder; the projector stays in the serving mix. The int4-weight LLaMA
(`quantize_llama_int4`) holds the same layers as `QLinear4` (grouped int4
codes and scales bit-identical to the JAX package's
`quantize_weight_int4`).

The module functions replace layers in place and return the module they
were given. The `*_tree` functions quantize a param tree in the JAX layout
([..., K, N] kernels; `mmrs-torch weights convert --int8`) into a new tree
of `checkpoint.QWeight` leaves, as the JAX package's tree functions do,
with its codes and scales bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from mmrs_tpu_torch.models.checkpoint import QWeight
from mmrs_tpu_torch.models.layers import (MLP, QLinear, QLinear4,
                                          int8_weight)
from mmrs_tpu_torch.ops.mlp_int8 import pad_hidden

# layers eligible for int8, by attribute name: the JAX package's key set
# {wq, wk, wv, wo, w1, w2, patch_kernel}, whose `patch_kernel` is the
# port's `patch_embed`
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "patch_embed"})


def quantize_tree(module: nn.Module, keys=QUANT_KEYS) -> nn.Module:
    """Replace every eligible `nn.Linear` below `module` by its `QLinear`.
    Layers that are already quantized are left as they are. An MLP whose
    two layers are int8 takes its hidden units in whole 32s
    (`pad_int8_mlp`)."""
    for name, child in list(module.named_children()):
        if name in keys and isinstance(child, nn.Linear):
            setattr(module, name, QLinear.from_linear(child))
        else:
            quantize_tree(child, keys)
    if isinstance(module, MLP):
        pad_int8_mlp(module)
    return module


def pad_int8_mlp(mlp: MLP) -> MLP:
    """An int8 MLP of a ragged hidden width (SigLIP's 4304) with zero
    units up to the next multiple of 32 in its buffers (ops/mlp_int8.
    pad_hidden: the same bits), so that the fused kernel takes its weights
    as they are in every call. Other MLPs are left as they are."""
    w1, w2 = mlp.w1, mlp.w2
    if isinstance(w1, QLinear) and isinstance(w2, QLinear):
        w1.q, w1.s, w1.bias, w2.q = pad_hidden(w1.q, w1.s, w1.bias, w2.q)
    return mlp


def quantize_clip_visual(model: nn.Module) -> nn.Module:
    """CLIP model with the vision tower quantized, text left as it is."""
    quantize_tree(model.visual)
    return model


# LLaMA's matmul weights (mmrs_tpu quantize._LM_KEYS restricted to the
# decoder's names)
LM_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                     "lm_head"})


def quantize_llama(model: nn.Module) -> nn.Module:
    """LLaMA decoder with int8 serving weights (the lm_head too)."""
    return quantize_tree(model, LM_KEYS)


def quantize_llama_int4(model: nn.Module, group: int = 128,
                        keys=LM_KEYS) -> nn.Module:
    """LLaMA decoder with int4 grouped-quant serving weights (`QLinear4`):
    half the int8 weight bytes, scales per `group` inputs along K (default
    128, the AWQ/GPTQ convention). Layers already quantized (int8 or int4)
    are left as they are. Flows through `layers.matmul`, which unpacks a
    layer to the compute dtype on every call (no fused kernel)."""
    for name, child in list(model.named_children()):
        if name in keys and isinstance(child, nn.Linear):
            setattr(model, name, QLinear4.from_linear(child, group))
        else:
            quantize_llama_int4(child, group, keys)
    return model


def quantize_llava(model: nn.Module) -> nn.Module:
    """LLaVA: int8 vision tower + int8 decoder; the 2-layer projector and
    the embeddings stay as they are (run once per image)."""
    quantize_tree(model.visual)
    quantize_llama(model.lm)
    return model


# -- param trees in the JAX layout --------------------------------------------

# kernel leaf names eligible for int8 (mmrs_tpu quantize._QUANT_KEYS)
TREE_KEYS = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "patch_kernel"})
TREE_LM_KEYS = TREE_KEYS | frozenset({"w_gate", "w_up", "w_down", "lm_head"})


def quantize_weight(w: Any) -> QWeight:
    """Per-output-channel symmetric int8 quantization of a [..., K, N]
    kernel (mmrs_tpu layers.quantize_weight, run op by op: true
    divisions), the scale over K."""
    w32 = w.float() if isinstance(w, torch.Tensor) else torch.as_tensor(
        np.asarray(w)).float()
    return QWeight(*int8_weight(w32, -2))


def quantize_param_tree(tree: Dict[str, Any], keys=TREE_KEYS
                        ) -> Dict[str, Any]:
    """A copy of a param tree with eligible kernels as `QWeight`s."""
    def walk(node):
        if isinstance(node, dict):
            return {k: quantize_weight(v)
                    if k in keys and not isinstance(v, (dict, QWeight))
                    else walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def quantize_clip_visual_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A CLIP tree with the vision tower quantized, text left as it is."""
    return {**tree, "visual": quantize_param_tree(tree["visual"])}


def quantize_llava_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A LLaVA tree with int8 vision and decoder kernels (the lm_head
    too); the projector and embeddings stay as they are."""
    return {**tree, "visual": quantize_param_tree(tree["visual"]),
            "lm": quantize_param_tree(tree["lm"], TREE_LM_KEYS)}
