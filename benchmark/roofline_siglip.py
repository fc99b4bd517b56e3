"""SigLIP so400m/14's work from its shapes (the peaks: roofline.py).

The image tower's operations an image (2 flops a multiply-add): the
patch map over the T = (image_size // patch)^2 patches, every block at
full attention, and the MAP head (the probe's query, the keys and values
of the T tokens, the probe's attention, the out-projection and the MLP
of one row). Least times at the index cell's shapes: K2 (the towers'
attention, [B, T, W] with heads of the true head dim) and E1 (the dense
epilogue, f32 sums in, the f32 bias, bf16 out) at its tanh-GELU
launches, 27 a batch at [B T, mlp_width] and the head's one at [B,
mlp_width].
"""

from __future__ import annotations

from typing import Dict

from benchmark import roofline

F32 = 4


def tokens(spec: Dict) -> int:
    return (spec["image_size"] // spec["patch_size"]) ** 2


def head_flops(spec: Dict) -> float:
    w, t, hidden = spec["width"], tokens(spec), spec["mlp_width"]
    return (2 * w * w + 2 * 2 * t * w * w + 4 * t * w + 2 * w * w
            + 2 * 2 * w * hidden)


def tower_flops_per_image(spec: Dict) -> float:
    w, p, t = spec["width"], spec["patch_size"], tokens(spec)
    return (2 * t * p * p * 3 * w
            + spec["layers"] * roofline._block_flops(t, w, spec["mlp_width"],
                                                     t * t)
            + head_flops(spec))


def k2_seconds(spec: Dict, batch: int) -> float:
    """One K2 launch over a batch of images."""
    return roofline.k2_seconds(batch, tokens(spec), spec["width"])


def e1_bytes(rows: int, cols: int) -> float:
    """f32 sums read, the f32 bias read, bf16 written."""
    return F32 * rows * cols + F32 * cols + roofline.BF16 * rows * cols


def e1_gelu_seconds(spec: Dict, batch: int) -> float:
    """The mean least time of a batch's tanh-GELU epilogue launches (bound
    by bytes): one a block, at [batch x T, mlp_width], and the head's at
    [batch, mlp_width]."""
    hidden, layers = spec["mlp_width"], spec["layers"]
    total = (layers * e1_bytes(batch * tokens(spec), hidden)
             + e1_bytes(batch, hidden))
    return total / (layers + 1) / roofline.HBM_BYTES_PER_S
