"""int8 serving quantization for the towers (opt-in, serving only).

Counterpart of mmrs_tpu/models/quantize.py for the CLIP towers: the six
block matmuls and the patch embedding become `QLinear` layers
(per-output-channel symmetric int8 weights, codes and scales bit-identical
to the JAX package's `quantize_weight`); activations are quantized per row
at call time (models/layers.py). LayerNorm, softmax, residuals, the
embeddings and the final projection stay in the bf16/f32 serving mix.

The functions replace layers in place and return the module they were
given (the JAX package returns a new tree).
"""

from __future__ import annotations

from torch import nn

from mmrs_tpu_torch.models.layers import QLinear

# layers eligible for int8, by attribute name: the JAX package's key set
# {wq, wk, wv, wo, w1, w2, patch_kernel}, whose `patch_kernel` is the
# port's `patch_embed`
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "patch_embed"})


def quantize_tree(module: nn.Module, keys=QUANT_KEYS) -> nn.Module:
    """Replace every eligible `nn.Linear` below `module` by its `QLinear`.
    Layers that are already quantized are left as they are."""
    for name, child in list(module.named_children()):
        if name in keys and isinstance(child, nn.Linear):
            setattr(module, name, QLinear.from_linear(child))
        else:
            quantize_tree(child, keys)
    return module


def quantize_clip_visual(model: nn.Module) -> nn.Module:
    """CLIP model with the vision tower quantized, text left as it is."""
    quantize_tree(model.visual)
    return model
