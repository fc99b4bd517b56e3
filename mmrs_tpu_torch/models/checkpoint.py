"""Read the param-tree npz checkpoints that mmrs_tpu writes.

Counterpart of mmrs_tpu/models/checkpoint.py's npz format: flat
'/'-joined keys, one array each; bf16 arrays are stored as their raw bits
(uint16) under a `@bf16` key suffix. They are read here without
`ml_dtypes`: uint16 bits -> int16 -> `.view(torch.bfloat16)`. An int8
weight (the JAX package's `QTensor`, written by `mmrs weights convert
--int8` or `save_npz` of a quantized tree) is a pair of arrays,
`<key>@int8q` (int8 codes [..., K, N]) and `<key>@int8s` (f32 scales
[..., N]); it is read as one `QWeight` leaf.

The result keeps the JAX package's tree and layouts (leaves are torch
tensors); models/convert_jax.py maps it onto the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

_BF16_SUFFIX = "@bf16"
_Q8_Q = "@int8q"
_Q8_S = "@int8s"


class QWeight(NamedTuple):
    """An int8 kernel in the JAX layout: codes q [..., K, N], per-output-
    channel scales s [..., N] (w ~= q * s)."""

    q: torch.Tensor
    s: torch.Tensor


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bit patterns -> a bf16 tensor with the same values."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_npz(path: str) -> Dict[str, Any]:
    """Load a param tree (nested dicts of CPU tensors and `QWeight`s, JAX
    layouts)."""
    flat: Dict[str, Any] = {}
    qpairs: Dict[str, list] = {}
    with np.load(path) as z:
        for k in z.files:
            v = z[k]
            if k.endswith(_BF16_SUFFIX):
                flat[k[: -len(_BF16_SUFFIX)]] = bf16_from_bits(v)
            elif k.endswith((_Q8_Q, _Q8_S)):
                half = 0 if k.endswith(_Q8_Q) else 1
                qpairs.setdefault(k[:-len(_Q8_Q)], [None, None])[half] = \
                    torch.from_numpy(np.array(v))
            else:
                flat[k] = torch.from_numpy(np.array(v))
    for base, (q, s) in qpairs.items():
        if q is None or s is None:
            raise ValueError(f"{path}: checkpoint is missing half of the "
                             f"int8 weight {base!r}")
        flat[base] = QWeight(q, s)
    return unflatten(flat)
