"""IVF ANN index x mesh — every bucket slot-sharded over the data axis.

Counterpart of mmrs_tpu/parallel/ivf.py:

  - **Slot-sharding, not cluster-sharding.** Every shard holds ALL C
    clusters but only `cap / S` slots of each bucket (and 1/S of the
    spill). The probe list is computed once, from the replicated
    centroids, and sent to every shard; each shard scans only ITS slot
    strip of the probed buckets. Per-device traffic falls S-fold while
    capacity grows S-fold, and no query's probe set can land on one
    device.
  - **Exact parity.** The probed rows are the single-device index's
    probed rows (same centroids, same slot maps, same probe list), each
    scored by the same kernel (K7 for bf16 / int8 strips, K8 for int4),
    so the merge reproduces single-device `ivf_topk`'s values, and
    nprobe == C stays the flat scan through the mesh.
  - **The merge is the flat path's** (parallel/topk.merge_candidates):
    bucket ids are GLOBAL gallery rows, so there is no offset arithmetic.

A shard's strip is its own CONTIGUOUS `IVFIndex` on its device (K7 and
K8 read [C, cap, D] buckets with a fixed row stride, so a strided view of
the whole index would not do); `ShardedIVF` holds one a data position.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.index.ivf import (IVFIndex, _alloc, _fill_chunk,
                                      _ivf_topk_body, _ivf_topk_body_q4,
                                      _round_up, auto_nprobe, probe_lists)
from mmrs_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, data_devices,
                                          local_positions)
from mmrs_tpu_torch.parallel.multihost import all_gather_processes
from mmrs_tpu_torch.parallel.topk import merge_candidates


@dataclass
class ShardedIVF:
    """A slot-sharded IVF index: `shards[pos]` is position pos's strip
    (an IVFIndex of cap / S slots a bucket and spill / S spill rows, on
    its device; None where another process owns the position). Every
    strip holds the same centroids; its ids are global rows."""

    shards: List[Optional[IVFIndex]]
    mesh: Mesh
    axis: str = DATA_AXIS
    build_seconds: Optional[dict] = None

    @property
    def _first(self) -> IVFIndex:
        return self.shards[local_positions(self.mesh, self.axis)[0]]

    @property
    def device(self) -> torch.device:
        return self._first.buckets.device

    @property
    def centroids(self) -> torch.Tensor:
        return self._first.centroids

    @property
    def n_clusters(self) -> int:
        return self._first.n_clusters

    @property
    def n_total(self) -> int:
        return self._first.n_total

    @property
    def dim(self) -> int:
        return self._first.dim

    @property
    def quant(self) -> str:
        return self._first.quant

    @property
    def quantized(self) -> bool:
        return self._first.quantized

    @property
    def bucket_cap(self) -> int:
        return self._first.bucket_cap * len(self.shards)

    def _gathered(self, name: str, dim: int) -> torch.Tensor:
        """The global slot map `name` on the host: every strip's, in
        position order, along `dim`."""
        local = torch.stack([getattr(self.shards[p], name).cpu()
                             for p in local_positions(self.mesh, self.axis)])
        return torch.cat(list(all_gather_processes(local)), dim=dim)

    @property
    def bucket_ids(self) -> torch.Tensor:
        """[C, cap] int32 global row ids (-1 empty), gathered."""
        return self._gathered("bucket_ids", 1)

    @property
    def spill_ids(self) -> torch.Tensor:
        """[S] int32 global row ids (-1 empty), gathered."""
        return self._gathered("spill_ids", 0)

    def hbm_bytes(self) -> int:
        """Device bytes of every local strip (centroids once a device)."""
        total, seen = 0, set()
        for p in local_positions(self.mesh, self.axis):
            sh = self.shards[p]
            total += sh.hbm_bytes()
            if sh.centroids.device in seen:
                total -= sh.centroids.numel() * sh.centroids.element_size()
            seen.add(sh.centroids.device)
        return total


def _strip(ivf: IVFIndex, pos: int, s: int, dev: torch.device,
           centroids: torch.Tensor) -> IVFIndex:
    """Position pos's contiguous slot strip of an index whose cap and
    spill are multiples of s, on dev."""
    cap_s, spl_s = ivf.bucket_cap // s, ivf.spill.shape[0] // s
    bs = slice(pos * cap_s, (pos + 1) * cap_s)
    ss = slice(pos * spl_s, (pos + 1) * spl_s)

    def cut(x, sl, axis):
        if x is None:
            return None
        x = x[:, sl] if axis == 1 else x[sl]
        return x.contiguous().to(dev)

    return dataclasses.replace(
        ivf, centroids=centroids, buckets=cut(ivf.buckets, bs, 1),
        bucket_ids=cut(ivf.bucket_ids, bs, 1),
        bucket_scales=cut(ivf.bucket_scales, bs, 1),
        spill=cut(ivf.spill, ss, 0), spill_ids=cut(ivf.spill_ids, ss, 0),
        spill_scales=cut(ivf.spill_scales, ss, 0), build_seconds=None)


def _pad_axis(x: Optional[torch.Tensor], axis: int, size: int, fill=0):
    if x is None or x.shape[axis] == size:
        return x
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def _centroids_by_device(centroids: torch.Tensor, mesh: Mesh, axis: str
                         ) -> dict:
    devs = data_devices(mesh, axis)
    return {devs[p]: centroids.to(devs[p])
            for p in local_positions(mesh, axis)}


def place_ivf(ivf: IVFIndex, mesh: Mesh, axis: str = DATA_AXIS
              ) -> ShardedIVF:
    """Split a built IVFIndex over the mesh: the cap axis and the spill
    padded to multiples of S (dead slots: id -1, zero rows and scales,
    masked as any empty slot), then each position's strip copied to its
    device. Use build_ivf(mesh=) when the index never fits one device: it
    streams rows straight into the strips."""
    s = mesh.shape[axis]
    cap = _round_up(ivf.bucket_cap, s)
    spl = _round_up(ivf.spill.shape[0], s)
    padded = dataclasses.replace(
        ivf, buckets=_pad_axis(ivf.buckets, 1, cap),
        bucket_ids=_pad_axis(ivf.bucket_ids, 1, cap, -1),
        bucket_scales=_pad_axis(ivf.bucket_scales, 1, cap),
        spill=_pad_axis(ivf.spill, 0, spl),
        spill_ids=_pad_axis(ivf.spill_ids, 0, spl, -1),
        spill_scales=_pad_axis(ivf.spill_scales, 0, spl))
    devs = data_devices(mesh, axis)
    cents = _centroids_by_device(ivf.centroids, mesh, axis)
    shards: List[Optional[IVFIndex]] = [None] * s
    for p in local_positions(mesh, axis):
        shards[p] = _strip(padded, p, s, devs[p], cents[devs[p]])
    return ShardedIVF(shards, mesh, axis, ivf.build_seconds)


def fill_strips(row_chunks, n: int, d: int, centroids: torch.Tensor,
                bucket_ids: np.ndarray, spill_ids: np.ndarray, quant: str,
                dtype: torch.dtype, mesh: Mesh, axis: str = DATA_AXIS
                ) -> ShardedIVF:
    """Allocate each local position's strip on its device and stream the
    gallery's rows into it: the sharded build and load. `bucket_ids`
    [C, cap] and `spill_ids` [S_pad] are the global slot maps (cap and
    S_pad multiples of the shard count); `row_chunks` yields (first row,
    rows); rows are normalized, cast or quantized as the single-device
    fill does. No device ever holds more than its strips."""
    s = mesh.shape[axis]
    c, cap = bucket_ids.shape
    cap_s, spl_s = cap // s, spill_ids.shape[0] // s
    bpos = np.full(n, -1, np.int64)
    flat = bucket_ids.reshape(-1)
    live = flat >= 0
    bpos[flat[live]] = np.arange(c * cap)[live]
    spos = np.full(n, -1, np.int64)
    slive = spill_ids >= 0
    spos[spill_ids[slive]] = np.arange(spill_ids.shape[0])[slive]
    slot, cluster = bpos % cap, bpos // cap
    devs = data_devices(mesh, axis)
    mine = local_positions(mesh, axis)
    arrays, where = {}, {}
    for p in mine:
        arrays[p] = _alloc(c, cap_s, spl_s, d, quant, dtype, devs[p])
        where[p] = (
            np.where((bpos >= 0) & (slot // cap_s == p),
                     cluster * cap_s + slot % cap_s, -1).astype(np.int32),
            np.where((spos >= 0) & (spos // spl_s == p), spos % spl_s,
                     -1).astype(np.int32))
    for a, rows in row_chunks:
        b = min(a + rows.shape[0], n)
        for p in mine:
            _fill_chunk(arrays[p], rows[:b - a], where[p][0][a:b],
                        where[p][1][a:b], quant)
    cents = _centroids_by_device(centroids, mesh, axis)
    shards: List[Optional[IVFIndex]] = [None] * s
    for p in mine:
        buckets, bscales, spill, sscales = arrays[p]
        shards[p] = IVFIndex(
            centroids=cents[devs[p]], buckets=buckets,
            bucket_ids=torch.from_numpy(np.ascontiguousarray(
                bucket_ids[:, p * cap_s:(p + 1) * cap_s])).to(devs[p]),
            spill=spill,
            spill_ids=torch.from_numpy(np.ascontiguousarray(
                spill_ids[p * spl_s:(p + 1) * spl_s])).to(devs[p]),
            n_total=n, dim=d, bucket_scales=bscales, spill_scales=sscales)
    return ShardedIVF(shards, mesh, axis)


def sharded_ivf_topk(
    queries: torch.Tensor,    # [Q, D] L2-normalized
    ivf: ShardedIVF,          # place_ivf / build_ivf(mesh=) / load_ivf(mesh=)
    k: int = 10,
    nprobe: int = 0,          # 0 = auto; == n_clusters is exact
    mesh: Optional[Mesh] = None,
    axis: str = DATA_AXIS,
    impl: str = "auto",       # per-shard route: kernels on a card | torch
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ivf_topk's contract over the slot-sharded index: the probe list
    once, each shard's probe body (K7 / K8 + its exact spill strip) on its
    device, then the merge. Values equal single-device ivf_topk's (same
    probed rows, same scores); equal scores may order differently (a
    shard's positions are its strip's)."""
    if mesh is None:
        raise ValueError("sharded_ivf_topk needs a mesh; use ivf_topk")
    if nprobe <= 0:
        nprobe = auto_nprobe(ivf.n_clusters)
    nprobe = min(nprobe, ivf.n_clusters)
    k = min(k, ivf.n_total)
    body = _ivf_topk_body_q4 if ivf.quant == "int4" else _ivf_topk_body
    q = queries.to(ivf.device)
    probe = probe_lists(q, ivf._first, nprobe)
    qs, ps = {q.device: q}, {q.device: probe}
    parts = []
    for p in local_positions(mesh, axis):
        sh = ivf.shards[p]
        dev = sh.buckets.device
        if dev not in qs:
            qs[dev], ps[dev] = q.to(dev), probe.to(dev)
        v, i = body(qs[dev], sh, ps[dev], k, impl)
        parts.append((v, i.long()))
    return merge_candidates(parts, k, mesh, axis)
