"""Multi-process meshes: the data axis across processes.

Counterpart of mmrs_tpu/parallel/multihost.py. Past one machine the
gallery's data axis spans PROCESSES first, then each process's local
devices; the model axis stays inside a process. The only traffic that
crosses processes is the top-k candidate exchange ([Q, k] values and ids
a shard, a few KB) and, for the dedup ring, one row block a step.

`distributed_init` wraps `torch.distributed.init_process_group` (the
counterpart of `jax.distributed.initialize`) over TCP with gloo, which
moves host tensors: the exchanges below stage through host memory, which
is what lets two processes share one card. Processes on distinct cards
would move the visiting blocks card to card with NCCL instead; no caller
needs that yet. With one process everything here degrades to
parallel/mesh.py's single-process forms, so every sharded path is
process-count agnostic.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.config import MeshConfig
from mmrs_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                          data_devices, local_devices,
                                          owners)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist else 1


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group (idempotent, safe to skip). Returns True if
    more than one process is in it after the call. `coordinator_address`
    is host:port of rank 0's TCP store, or a rendezvous URL with its
    scheme (`file:///shared/path`: no port to pick, as tests on one
    machine use); with no arguments, torchrun's
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK are read when set, and
    a single process (tests, one machine) returns False with no side
    effects."""
    import torch.distributed as dist

    if _dist() is not None:
        return process_count() > 1
    if coordinator_address is None and num_processes is None:
        env = os.environ
        if not (env.get("MASTER_ADDR") and env.get("WORLD_SIZE")):
            return False
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env.get("RANK", "0"))
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend="gloo", init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id or 0))
    return process_count() > 1


def all_gather_processes(t: torch.Tensor) -> torch.Tensor:
    """t [L, ...] from every process, concatenated along dim 0 in rank
    order, on t's device (t itself with one process). Every process must
    pass the same shape."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return t
    src = t.contiguous().cpu()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return torch.cat(out).to(t.device)


def ring_exchange(send: torch.Tensor, to_rank: int, from_rank: int
                  ) -> torch.Tensor:
    """Send `send` to `to_rank` and receive a tensor of the same shape and
    dtype from `from_rank` (one step of the dedup ring across
    processes); the result lies on send's device."""
    dist = _dist()
    src = send.contiguous().cpu()
    got = torch.empty_like(src)
    req = dist.isend(src, to_rank)
    dist.recv(got, from_rank)
    req.wait()
    return got.to(send.device)


def make_hybrid_mesh(cfg: Optional[MeshConfig] = None,
                     devices: Optional[Sequence[torch.device]] = None
                     ) -> Mesh:
    """(data, model) mesh laid out process-major on the data axis.

    `devices` are THIS process's devices (default: `local_devices()`),
    the same count in every process. model = cfg.model_size must divide
    that count (tensor-parallel collectives stay inside a process); data
    = processes x (local devices / model). With one process this is
    exactly mesh.make_mesh's layout."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model_size)
    devices = [torch.device(d) for d in
               (devices if devices is not None else local_devices())]
    local = len(devices)
    procs = process_count()
    if local % model:
        raise ValueError(
            f"model axis ({model}) must divide local device count ({local}) "
            "— tensor-parallel collectives must stay inside one process")
    per_host_data = local // model
    if cfg.data_size > 0 and cfg.data_size != procs * per_host_data:
        raise ValueError(
            f"data_size {cfg.data_size} != processes ({procs}) x local data "
            f"({per_host_data})")
    counts = all_gather_processes(torch.tensor([local])).tolist()
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold different device counts {counts}")
    grid = np.empty(local, dtype=object)
    grid[:] = devices
    grid = np.tile(grid.reshape(per_host_data, model), (procs, 1))
    owner = np.repeat(np.arange(procs), per_host_data)[:, None].repeat(
        model, 1)
    return Mesh(grid, (cfg.data_axis or DATA_AXIS,
                       cfg.model_axis or MODEL_AXIS), owner)


def _owned_span(mesh: Mesh, axis: str = DATA_AXIS) -> Tuple[int, int]:
    """(first, last) data-axis positions this process drives
    (process-major layout); (0, -1) if none."""
    me = process_index()
    rows = [i for i, r in enumerate(owners(mesh, axis)) if r == me]
    if not rows:
        return 0, -1
    return min(rows), max(rows)


def process_local_rows(n: int, mesh: Mesh, axis: str = DATA_AXIS
                       ) -> Tuple[int, int]:
    """Row range [start, stop) of a globally [N, D] row-sharded gallery that
    THIS process places (each process reads only its own rows)."""
    shards = mesh.shape[axis]
    per = -(-n // shards)                       # ceil
    first, last = _owned_span(mesh, axis)
    if last < first:
        return 0, 0
    # clamp both ends by n: a process whose shards start past the valid
    # rows owns an empty (well-formed) range, not an inverted one
    return min(n, first * per), min(n, (last + 1) * per)


def place_global_rows(local_rows, n: int, mesh: Mesh, axis: str = DATA_AXIS
                      ) -> List[Optional[torch.Tensor]]:
    """The global row-sharded gallery from THIS process's rows: a list of
    one f32 block of ceil(n / S) rows a data position, on its device, None
    for the positions other processes own; no process ever holds the whole
    gallery. The ragged tail is zero-padded by its owner (mask with
    n_valid at query time, as parallel.topk.place_gallery)."""
    shards = mesh.shape[axis]
    per = -(-n // shards)
    lo, hi = process_local_rows(n, mesh, axis)
    local = np.asarray(local_rows, np.float32)
    if local.shape[0] != hi - lo:
        raise ValueError(
            f"process owns rows [{lo}, {hi}) of {n}; got {local.shape[0]}")
    # pad to every shard this process drives, not just ceil(hi / per):
    # with a small or awkward n the trailing shards hold only padding
    first, last = _owned_span(mesh, axis)
    extent = (last + 1 - first) * per if last >= first else 0
    local = np.pad(local, ((0, extent - local.shape[0]), (0, 0)))
    out: List[Optional[torch.Tensor]] = [None] * shards
    for pos, dev in enumerate(data_devices(mesh, axis)):
        if first <= pos <= last:
            a = (pos - first) * per
            out[pos] = torch.from_numpy(local[a:a + per]).to(dev)
    return out
