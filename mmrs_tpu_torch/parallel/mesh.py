"""Device meshes and the helpers that split a tensor over one.

Counterpart of mmrs_tpu/parallel/mesh.py. The system's scaling axis is the
GALLERY: embedding rows are split over the `data` axis of a mesh and the
queries go to every entry; a `model` axis is reserved for the verifier's
tensor parallelism. A JAX mesh is a grid of devices that the compiler
partitions over; here one process drives every local entry in a loop, so
a `Mesh` is the same grid of `torch.device`s, and a "sharded" tensor is a
list holding one piece a data position (`shard_rows`).

Entries may repeat a device: `[cuda:0] * 4` runs four shards on one card,
one after the other, with the same merge as four cards. Across processes
(parallel/multihost.py) every process holds the whole grid, each entry
tagged with the rank that owns it; a piece another process owns is None
in this process's lists.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mmrs_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (data, model) grid of devices: `devices` an object array of
    `torch.device`, `shape` a dict {axis name: size} as JAX's, `owner`
    an int array of the same shape: the rank of the process that drives
    each entry (all 0 in a single process)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 owner: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.owner = (np.zeros(devices.shape, np.int64) if owner is None
                      else np.asarray(owner, np.int64))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices.ravel().tolist()})"


def local_devices(count: Optional[int] = None, device=None
                  ) -> List[torch.device]:
    """This process's devices: every card, `cuda:0` .. `cuda:n-1`. When
    the CPU is asked for (`device="cpu"` or MMRS_TORCH_DEVICE=cpu, the
    rule of `pipeline.default_device`), `count` CPU entries (1 when not
    given): the counterpart of the JAX tests' forced host device count.
    Without a card and without that ask this raises; it never falls back
    to the CPU."""
    from mmrs_tpu_torch.pipeline import default_device

    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * (count or 1)


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A data x model mesh over `devices` (default: `local_devices`, on
    the CPU as many entries as the config names)."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model_size)
    if devices is None:
        devices = local_devices(cfg.data_size * model
                                if cfg.data_size > 0 else None)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    data = cfg.data_size if cfg.data_size > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(data, model), (cfg.data_axis, cfg.model_axis))


def num_shards(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    return mesh.shape[axis]


def data_size(mesh: Mesh) -> int:
    """Width of the mesh's data axis (1 where it has none)."""
    return int(mesh.shape.get(DATA_AXIS, 1))


def model_size(mesh: Mesh) -> int:
    """Width of the mesh's model axis (1 where it has none)."""
    return int(mesh.shape.get(MODEL_AXIS, 1))


def row_devices(mesh: Mesh, d: int) -> List[torch.device]:
    """Data row d's devices along the model axis."""
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(DATA_AXIS), 0)
    return list(grid[d].ravel())


def data_devices(mesh: Mesh, axis: str = DATA_AXIS) -> List[torch.device]:
    """The device of each position on `axis` (the first entry across the
    other axis: a piece split over `axis` is replicated over the other,
    and one copy is the one computed on)."""
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return [row.ravel()[0] for row in grid]


def owners(mesh: Mesh, axis: str = DATA_AXIS) -> List[int]:
    """The rank that drives each position on `axis`."""
    grid = np.moveaxis(mesh.owner, mesh.axis_names.index(axis), 0)
    return [int(row.ravel()[0]) for row in grid]


def local_positions(mesh: Mesh, axis: str = DATA_AXIS) -> List[int]:
    """The positions on `axis` that this process drives."""
    from mmrs_tpu_torch.parallel.multihost import process_index

    me = process_index()
    return [i for i, r in enumerate(owners(mesh, axis)) if r == me]


def first_device(mesh: Mesh, axis: str = DATA_AXIS) -> torch.device:
    """The device of this process's first position on `axis`: where the
    shards' answers meet."""
    return data_devices(mesh, axis)[local_positions(mesh, axis)[0]]


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS
               ) -> List[Optional[torch.Tensor]]:
    """Split x [N, ...] into N / S contiguous row blocks, one a position on
    `axis`, each on its device (None where another process owns it). N
    must be a multiple of S (`parallel.topk.place_gallery` pads first).
    Blocks that stay on x's device are views of x."""
    s = num_shards(mesh, axis)
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows do not split over {s} shards")
    per = x.shape[0] // s
    mine = set(local_positions(mesh, axis))
    return [x[i * per:(i + 1) * per].to(dev) if i in mine else None
            for i, dev in enumerate(data_devices(mesh, axis))]


def replicate(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS
              ) -> List[Optional[torch.Tensor]]:
    """x on the device of every position on `axis` (one copy a distinct
    device: repeated entries share it; None where another process owns
    the position)."""
    copies = {}
    mine = set(local_positions(mesh, axis))
    out = []
    for i, dev in enumerate(data_devices(mesh, axis)):
        if i not in mine:
            out.append(None)
            continue
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return out
