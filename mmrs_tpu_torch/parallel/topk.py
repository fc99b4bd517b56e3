"""Top-k over a row-sharded gallery.

Counterpart of mmrs_tpu/parallel/topk.py. The queries go to every shard;
each shard runs the fused top-k scan over ITS rows on its own device (K1
`cosine_topk`, or K4 `cosine_topk_quantized` for int8 rows: the kernels on
a card, their plain versions on the CPU), local ids + the shard's offset
give global rows, the [Q, k] candidates of every shard are moved to the
first device (and across processes, parallel/multihost.py) and merged
there. Launches on distinct cards run under each card's device guard on
its current stream; the merge's copy to the first device is the only
synchronisation.

A placed gallery is a list of one row block a data position (N_pad / S
rows each, None where another process owns the position) plus the real
row count `n_valid`: ragged galleries are padded with zero rows to the
next multiple of S and masked by global row id in the merge, so any N
runs on any mesh. The merge takes the stable top k of the shard-major
[Q, S * k] candidates (ops/topk.sorted_topk), so equal scores keep the
lower shard, then the earlier place, as JAX's `lax.top_k`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from mmrs_tpu_torch.ops.topk import NEG_INF, _pad, cosine_topk, sorted_topk
from mmrs_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, first_device,
                                          local_positions, shard_rows)
from mmrs_tpu_torch.parallel.multihost import all_gather_processes

Blocks = List[Optional[torch.Tensor]]


def padded_rows(n: int, n_shards: int) -> int:
    return ((n + n_shards - 1) // n_shards) * n_shards


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = x.new_zeros((rows - x.shape[0], *x.shape[1:]))
    return torch.cat([x, pad])


def _blocks(x: Union[torch.Tensor, Sequence], mesh: Mesh, axis: str
            ) -> Tuple[Blocks, int]:
    """(one block a data position, rows a block): a placed list as it is,
    a whole tensor padded and split."""
    if isinstance(x, torch.Tensor):
        x = shard_rows(_pad_rows(x, padded_rows(x.shape[0],
                                                mesh.shape[axis])),
                       mesh, axis)
    blocks = list(x)
    if len(blocks) != mesh.shape[axis]:
        raise ValueError(f"{len(blocks)} blocks for {mesh.shape[axis]} "
                         f"shards")
    per = next(b.shape[0] for b in blocks if b is not None)
    return blocks, per


def _on(x: torch.Tensor, dev: torch.device, cache: dict) -> torch.Tensor:
    """x on dev, one copy a device."""
    if dev not in cache:
        cache[dev] = x.to(dev)
    return cache[dev]


def merge_candidates(parts, k: int, mesh: Mesh, axis: str = DATA_AXIS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """parts: this process's [(values [Q, k], GLOBAL ids [Q, k])], one a
    local shard in position order, ids < 0 for missing candidates. Moves
    them to the first local device, gathers every process's, and takes
    the stable top k of the shard-major [Q, S * k] (-1 where the value is
    -inf). Returns (values [Q, k] f32, ids [Q, k] int32) on that device,
    the same in every process."""
    dev = first_device(mesh, axis)
    vals = torch.stack([torch.where(i < 0, NEG_INF, v).to(dev)
                        for v, i in parts])                  # [L, Q, k]
    ids = torch.stack([i.to(dev) for _, i in parts])
    vals, ids = all_gather_processes(vals), all_gather_processes(ids)
    s, qn, kk = vals.shape
    flat_v = vals.permute(1, 0, 2).reshape(qn, s * kk)
    flat_i = ids.permute(1, 0, 2).reshape(qn, s * kk)
    best_v, pos = sorted_topk(flat_v, k)
    best_i = torch.gather(flat_i, 1, pos.long().clamp_min(0))
    return best_v, torch.where(best_v == NEG_INF, -1, best_i).to(torch.int32)


def _sharded_scan(scan: Callable, queries: torch.Tensor, blocks: Blocks,
                  extra: Blocks, per: int, k: int, mesh: Mesh, axis: str,
                  n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """scan(q, block, extra_block, k) -> (values, local ids) on each local
    shard at k = min(k, rows a shard), topped up with (-inf, -1); local
    ids + the shard's offset, masked past n_valid; then the merge."""
    kk = min(k, per)
    qs: dict = {}
    parts = []
    for pos in local_positions(mesh, axis):
        blk = blocks[pos]
        v, i = _pad(*scan(_on(queries, blk.device, qs), blk, extra[pos], kk),
                    k)
        g = i.long() + pos * per
        g = torch.where((i < 0) | (g >= n_valid), -1, g)
        parts.append((v, g))
    return merge_candidates(parts, k, mesh, axis)


def sharded_cosine_topk(
    queries: torch.Tensor,     # [Q, D], L2-normalized, the gallery's dtype
    gallery,                   # [N, D] tensor, or place_gallery's blocks
    k: int,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    impl: str = "auto",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (values [Q, k] f32, global ids [Q, k] int32) on the first
    local shard's device. `n_valid` is the real row count of a padded
    gallery (place_gallery pads); it defaults to the padded length."""
    blocks, per = _blocks(gallery, mesh, axis)
    n_valid = per * len(blocks) if n_valid is None else n_valid
    return _sharded_scan(
        lambda q, g, _, kk: cosine_topk(q, g, kk, impl=impl), queries,
        blocks, [None] * len(blocks), per, k, mesh, axis, n_valid)


def sharded_cosine_topk_quantized(
    queries: torch.Tensor,     # [Q, D] float, L2-normalized
    gallery_q,                 # int8 [N, D] tensor or blocks
    scales,                    # f32 [N] tensor or blocks
    k: int,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    impl: str = "auto",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 gallery x mesh: each shard's fused quantized top-k (K4), then
    the same merge."""
    from mmrs_tpu_torch.ops.quant import cosine_topk_quantized

    blocks, per = _blocks(gallery_q, mesh, axis)
    sblocks, _ = _blocks(scales, mesh, axis)
    n_valid = per * len(blocks) if n_valid is None else n_valid
    return _sharded_scan(
        lambda q, g, s, kk: cosine_topk_quantized(q, g, s, kk, impl=impl),
        queries, blocks, sblocks, per, k, mesh, axis, n_valid)


def gather_columns(strips: List[torch.Tensor], mesh: Mesh,
                   axis: str = DATA_AXIS) -> torch.Tensor:
    """[Q, N / S] column strips of this process's shards -> [Q, N_pad] on
    the first local device (every process's, in position order)."""
    dev = first_device(mesh, axis)
    local = torch.stack([s.to(dev) for s in strips])        # [L, Q, n]
    full = all_gather_processes(local)
    return full.permute(1, 0, 2).reshape(full.shape[1], -1)


def sharded_similarities(
    queries: torch.Tensor,     # [Q, D] in the gallery's dtype
    gallery,                   # [N, D] tensor or blocks
    mesh: Mesh,
    axis: str = DATA_AXIS,
) -> torch.Tensor:
    """Full similarity rows [Q, N_pad] f32 (sums of exact products): each
    shard computes its own column strip, gathered on the first device.
    The calibration input."""
    from mmrs_tpu_torch.models.layers import _mm_f32

    blocks, _ = _blocks(gallery, mesh, axis)
    qs: dict = {}
    return gather_columns(
        [_mm_f32(_on(queries, blocks[p].device, qs), blocks[p])
         for p in local_positions(mesh, axis)], mesh, axis)


def sharded_similarities_quantized(
    q_q: torch.Tensor,         # [Q, D] int8 queries
    q_scale: torch.Tensor,     # [Q] f32
    gallery_q,                 # int8 [N, D] tensor or blocks
    scales,                    # f32 [N] tensor or blocks
    mesh: Mesh,
    axis: str = DATA_AXIS,
) -> torch.Tensor:
    """[Q, N_pad] int8 scores (exact int32 dots, the f32 epilogue of the
    single-device scan), one column strip a shard."""
    from mmrs_tpu_torch.ops.quant import scores_q8

    blocks, _ = _blocks(gallery_q, mesh, axis)
    sblocks, _ = _blocks(scales, mesh, axis)
    qs: dict = {}
    ss: dict = {}
    return gather_columns(
        [scores_q8(_on(q_q, blocks[p].device, qs),
                   _on(q_scale, blocks[p].device, ss), blocks[p], sblocks[p])
         for p in local_positions(mesh, axis)], mesh, axis)


def place_gallery(gallery: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS
                  ) -> Blocks:
    """The gallery split over the mesh: ragged row counts zero-padded to
    the next multiple of the shard count (mask with n_valid at query
    time), one block a data position on its device."""
    rows = padded_rows(gallery.shape[0], mesh.shape[axis])
    return shard_rows(_pad_rows(gallery, rows), mesh, axis)


def place_gallery_quantized(gallery: torch.Tensor, mesh: Mesh,
                            axis: str = DATA_AXIS) -> Tuple[Blocks, Blocks]:
    """Quantize to int8 + per-row scales, then pad (zero codes, zero
    scales: a padding row scores exactly 0.0) and split both over the
    mesh. Returns (code blocks, scale blocks)."""
    from mmrs_tpu_torch.ops.quant import quantize_rows

    g_q, scales = quantize_rows(gallery)
    rows = padded_rows(g_q.shape[0], mesh.shape[axis])
    return (shard_rows(_pad_rows(g_q, rows), mesh, axis),
            shard_rows(_pad_rows(scales, rows), mesh, axis))
