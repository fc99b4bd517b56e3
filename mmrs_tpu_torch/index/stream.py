"""Streaming top-k over galleries larger than device memory.

Counterpart of mmrs_tpu/index/stream.py on one device: row chunks of an
on-disk (memmapped) gallery are uploaded in their source dtype, cast to
bf16 on the device and scanned by the fused top-k (ops/topk.py: K1 on a
GPU); only [Q, k] candidates per chunk are kept, and they are merged on
the host at the end with a stable sort (equal scores: earlier chunk, then
lower row first — the flat scan's rule). The exact oracle of
`ivf.tune_nprobe`.

With `prefetch` > 0 the upload is double-buffered, as the JAX package
overlaps chunk i + 1's upload with chunk i's scan: a ring of prefetch + 1
slots, each a pinned host buffer and a device buffer of one chunk. The
host fills a slot from the memmap, a side stream copies it to the device
and records an event, and the scan waits for that event on the compute
stream; an event recorded after the scan marks the slot free, and the host
waits for it before it refills that slot's buffers. So while the card
scans chunk i the host reads chunk i + 1 from disk and the side stream
uploads it. Device memory is bounded by prefetch + 1 chunks (plus one bf16
cast of the chunk in flight) whatever the gallery size; prefetch 0 is a
ring of one slot: the host refills it only once the last scan is done, so
nothing overlaps. On the CPU the slots are plain host
buffers and every step runs in order.

With `mesh`, each chunk is split by rows over the mesh's data axis (a ring
a shard, on its device) and scanned by `parallel.sharded_cosine_topk`:
upload and scan both spread over the devices, and the per-chunk [Q, k]
merge is the only exchange.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.ops.topk import NEG_INF, cosine_topk
from mmrs_tpu_torch.pipeline import default_device


class _UploadRing:
    """`slots` chunk buffers reused in turn; see the module docstring."""

    def __init__(self, slots: int, rows: int, dim: int, dtype: torch.dtype,
                 device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.host = [torch.empty((rows, dim), dtype=dtype,
                                 pin_memory=self.cuda) for _ in range(slots)]
        self.dev = ([torch.empty((rows, dim), dtype=dtype, device=device)
                     for _ in range(slots)] if self.cuda else self.host)
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.free: List[Optional[torch.cuda.Event]] = [None] * slots
        self.turn = 0

    def upload(self, embeddings, a: int, b: int) -> torch.Tensor:
        """Rows [a, b) of `embeddings` in the next slot's device buffer,
        ready on the current stream; the slot stays taken until `done`."""
        s = self.turn % len(self.host)
        if self.free[s] is not None:    # the last scan reading slot s
            self.free[s].synchronize()
        rows = b - a
        np.copyto(self.host[s].numpy()[:rows], embeddings[a:b])
        if not self.cuda:
            return self.host[s][:rows]
        with torch.cuda.stream(self.copy_stream):
            self.dev[s][:rows].copy_(self.host[s][:rows], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.copy_stream)
        torch.cuda.current_stream(self.device).wait_event(copied)
        return self.dev[s][:rows]

    def done(self) -> None:
        """Everything that reads the current slot has been enqueued."""
        s = self.turn % len(self.host)
        if self.cuda:
            self.free[s] = torch.cuda.Event()
            self.free[s].record(torch.cuda.current_stream(self.device))
        self.turn += 1


def streaming_topk(
    embeddings,                   # [N, D] array-like (np.memmap ok), f16/f32
    queries: np.ndarray,          # [Q, D] (unnormalized ok — caller's call)
    k: int = 10,
    chunk_rows: int = 1 << 20,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
    prefetch: int = 2,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (values [Q, k] f32, global row ids [Q, k] int64). When the
    gallery holds fewer than k rows the surplus places are (-inf, -1).
    The answer is the same at every `prefetch`, and with or without a
    mesh."""
    n, dim = embeddings.shape
    src = torch.from_numpy(np.zeros(0, np.dtype(embeddings.dtype))).dtype
    if mesh is not None:
        return _merge(*_sharded_chunks(embeddings, queries, k, chunk_rows,
                                       dtype, impl, prefetch, mesh, src), k)
    device = torch.device(device) if device is not None else default_device()
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(device).to(dtype)
    ring = _UploadRing(prefetch + 1, min(chunk_rows, n), dim, src, device)
    vals, idxs = [], []
    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        chunk = ring.upload(embeddings, a, b)
        v, i = cosine_topk(q, chunk.to(dtype), k=min(k, b - a), impl=impl)
        ring.done()
        vals.append(v)
        idxs.append(i.long() + a)
    return _merge(vals, idxs, k)


def _sharded_chunks(embeddings, queries, k: int, chunk_rows: int,
                    dtype: torch.dtype, impl: str, prefetch: int, mesh,
                    src: torch.dtype):
    """Each chunk's rows in one block a shard (the last shard's tail and
    any shard past the chunk's end zero-filled), uploaded through a ring
    of each device's own, then one sharded scan a chunk, masked past the
    chunk's rows. Returns the per-chunk candidate lists."""
    from mmrs_tpu_torch.parallel.mesh import data_devices, local_positions
    from mmrs_tpu_torch.parallel.topk import sharded_cosine_topk

    n, dim = embeddings.shape
    s = mesh.shape["data"]
    devs = data_devices(mesh)
    mine = local_positions(mesh)
    per = -(-min(chunk_rows, n) // s)
    rings = {p: _UploadRing(prefetch + 1, per, dim, src, devs[p])
             for p in mine}
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dtype)
    vals, idxs = [], []
    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        rows = -(-(b - a) // s)
        blocks, used = [None] * s, []
        for p in mine:
            lo, hi = min(b, a + p * rows), min(b, a + (p + 1) * rows)
            part = torch.empty((0, dim), dtype=src, device=devs[p])
            if hi > lo:
                part = rings[p].upload(embeddings, lo, hi)
                used.append(rings[p])
            blocks[p] = torch.nn.functional.pad(
                part.to(dtype), (0, 0, 0, rows - (hi - lo)))
        v, i = sharded_cosine_topk(q, blocks, min(k, b - a), mesh,
                                   impl=impl, n_valid=b - a)
        for ring in used:
            ring.done()
        vals.append(v)
        idxs.append(torch.where(i < 0, -1, i.long() + a))
    return vals, idxs


def _merge(vals: List[torch.Tensor], idxs: List[torch.Tensor], k: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The chunks' candidates merged on the host: stable sort, so equal
    scores keep the earlier chunk, then the earlier place."""
    merged_v = torch.cat(vals, dim=1).cpu().numpy()
    merged_i = torch.cat(idxs, dim=1).cpu().numpy()
    if merged_v.shape[1] < k:     # tiny gallery: pad with sentinels
        pad = k - merged_v.shape[1]
        merged_v = np.pad(merged_v, ((0, 0), (0, pad)),
                          constant_values=NEG_INF)
        merged_i = np.pad(merged_i, ((0, 0), (0, pad)), constant_values=-1)
    order = np.argsort(-merged_v, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(merged_v, order, 1),
            np.take_along_axis(merged_i, order, 1))
