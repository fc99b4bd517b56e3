"""Data-parallel gallery embedding over the mesh.

Counterpart of mmrs_tpu/parallel/embed.py: index builds embed batches
split by the batch dimension. The parameters are replicated, one tower a
distinct device (entries that repeat a device share one module); each
shard encodes its slice of the batch on its device (the image path's
kernels: K3 normalize, K2 attention, K6 for the int8 tower), and the
slices come back to the host in order (every process's, across
processes).
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from mmrs_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, data_devices,
                                          local_positions)
from mmrs_tpu_torch.parallel.multihost import all_gather_processes


def _replica(params, dev: torch.device):
    """params (a module, a tensor, or a dict / list / tuple of them) on
    dev: itself where it already lies there, else a copy."""
    if isinstance(params, torch.nn.Module):
        first = next(iter(params.parameters()), None)
        if first is None or first.device == dev:
            return params
        return copy.deepcopy(params).to(dev)
    if isinstance(params, torch.Tensor):
        return params.to(dev)
    if isinstance(params, dict):
        return {k: _replica(v, dev) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_replica(v, dev) for v in params)
    return params


def make_sharded_encoder(
    encode_fn: Callable,     # (params, images_u8 [B,S,S,3] tensor) -> [B, D]
    params,
    mesh: Mesh,
    batch_size: int,
) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap an encode function into a batch-sharded callable with the
    `pixels_u8 -> embeddings` signature build_index expects. A ragged
    final batch is zero-padded to a multiple of the data axis and
    trimmed. Every shard is launched before any result is read, so
    distinct cards encode at once."""
    n_data = mesh.shape[DATA_AXIS]
    if batch_size % n_data != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"data axis {n_data}")
    devices = data_devices(mesh)
    mine = local_positions(mesh)
    replicas = {}
    for pos in mine:
        if devices[pos] not in replicas:
            replicas[devices[pos]] = _replica(params, devices[pos])

    @torch.inference_mode()
    def encode(pixels_u8: np.ndarray) -> np.ndarray:
        b = pixels_u8.shape[0]
        pad = (-b) % n_data
        if pad:
            pixels_u8 = np.concatenate(
                [pixels_u8, np.zeros((pad, *pixels_u8.shape[1:]),
                                     pixels_u8.dtype)], axis=0)
        per = pixels_u8.shape[0] // n_data
        outs = []
        for pos in mine:
            dev = devices[pos]
            part = torch.from_numpy(np.ascontiguousarray(
                pixels_u8[pos * per:(pos + 1) * per])).to(dev)
            outs.append(encode_fn(replicas[dev], part))
        out = torch.cat([o.float().cpu() for o in outs])
        return all_gather_processes(out).numpy()[:b]

    return encode
