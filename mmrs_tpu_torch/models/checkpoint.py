"""Read the param-tree npz checkpoints that mmrs_tpu writes.

Counterpart of mmrs_tpu/models/checkpoint.py's npz format: flat
'/'-joined keys, one array each; bf16 arrays are stored as their raw bits
(uint16) under a `@bf16` key suffix. They are read here without
`ml_dtypes`: uint16 bits -> int16 -> `.view(torch.bfloat16)`. int8
QTensor pairs (`@int8q`/`@int8s`) wait for the quantized towers (ROADMAP
A.6) and are refused.

The result keeps the JAX package's tree and layouts (leaves are torch
tensors); models/convert_jax.py maps it onto the port's modules.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_BF16_SUFFIX = "@bf16"
_Q8_SUFFIXES = ("@int8q", "@int8s")


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
    """Load a param tree (nested dicts of CPU tensors, JAX layouts)."""
    flat: Dict[str, torch.Tensor] = {}
    with np.load(path) as z:
        for k in z.files:
            if k.endswith(_Q8_SUFFIXES):
                raise NotImplementedError(
                    f"{path}: {k!r} is an int8-quantized weight; the port "
                    f"loads int8 towers with ROADMAP A.6 (quantized serving)")
            v = z[k]
            if k.endswith(_BF16_SUFFIX):
                flat[k[: -len(_BF16_SUFFIX)]] = bf16_from_bits(v)
            else:
                flat[k] = torch.from_numpy(np.array(v))
    return unflatten(flat)
