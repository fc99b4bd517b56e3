"""Read and write the param-tree npz checkpoints of mmrs_tpu's format.

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
`save_npz` writes the same format from such a tree (convert_jax.llava_tree
of a module), one member at a time, so a checkpoint written by either
package loads in both.
"""

from __future__ import annotations

import os
import zipfile
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


def load_npz(path: str, placement=None) -> Dict[str, Any]:
    """Load a param tree (nested dicts of CPU tensors and `QWeight`s, JAX
    layouts).

    `placement` (optional, e.g. parallel/vlm.llava_checkpoint_placement):
    flat key -> a function of the host tensor whose result becomes the
    leaf, or None to keep the host tensor. Each member is placed as it is
    read, so the host holds one array at a time (a TP-placed 7B is never
    whole on the host). Keys keep their `@int8q` / `@int8s` suffixes (a
    scale places differently from its codes); the `@bf16` storage marker
    is stripped first."""
    flat: Dict[str, Any] = {}
    qpairs: Dict[str, list] = {}
    with np.load(path) as z:
        for k in z.files:
            v = z[k]
            if k.endswith(_BF16_SUFFIX):
                k = k[: -len(_BF16_SUFFIX)]
                t = bf16_from_bits(v)
            else:
                # a member is read into an array of its own: no copy
                t = torch.from_numpy(v if v.flags.writeable else np.array(v))
            del v
            if placement is not None:
                put = placement(k)
                if put is not None:
                    t = put(t)
            if k.endswith((_Q8_Q, _Q8_S)):
                half = 0 if k.endswith(_Q8_Q) else 1
                qpairs.setdefault(k[:-len(_Q8_Q)], [None, None])[half] = t
            else:
                flat[k] = t
    for base, (q, s) in qpairs.items():
        if q is None or s is None:
            raise ValueError(f"{path}: checkpoint is missing half of the "
                             f"int8 weight {base!r}")
        flat[base] = QWeight(q, s)
    return unflatten(flat)


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    """(flat key, leaf) pairs, '/'-joined keys in the tree's order."""
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


def _members(key: str, leaf: Any):
    """(npz member name, numpy array) pairs of one leaf: bf16 as its uint16
    bits under `@bf16`, an int8 weight as its `@int8q` / `@int8s` pair."""
    if isinstance(leaf, QWeight):
        yield from _members(key + _Q8_Q, leaf.q)
        yield from _members(key + _Q8_S, leaf.s)
        return
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            yield key + _BF16_SUFFIX, t.view(torch.int16).numpy().view(
                np.uint16)
            return
        leaf = t.numpy()
    yield key, np.asarray(leaf)


def save_npz(tree: Dict[str, Any], path: str) -> None:
    """Write a param tree (torch tensors, numpy arrays, `QWeight`s; JAX
    layouts) as mmrs_tpu's npz, streaming one member at a time (the
    archive np.savez writes: stored, zip64), to a temporary name first."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _flatten(tree):
            for name, arr in _members(key, leaf):
                if not arr.flags.c_contiguous:   # 0-d arrays stay 0-d
                    arr = np.array(arr, order="C")
                with zf.open(name + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
    os.replace(tmp, path)
