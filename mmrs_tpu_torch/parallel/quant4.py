"""int4 packed gallery x mesh — the residency ladder's top rung, sharded.

Counterpart of mmrs_tpu/parallel/quant4.py over the port's own row-major
[N, D/2] packed layout (ops/quant4.py): the packed rows and their scales
are split by rows, each shard runs the fused int4 scan (K5) on its own
device, and the merge is parallel/topk.py's. The JAX package shards its
transposed [D/8, N] words by columns and rounds each strip to 128 lanes;
both are TPU layout artefacts with no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmrs_tpu_torch.ops.quant4 import (cosine_topk_int4, quantize_rows_int4,
                                       similarities_int4)
from mmrs_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, local_positions,
                                          shard_rows)
from mmrs_tpu_torch.parallel.topk import (_blocks, _on, _pad_rows,
                                          _sharded_scan, gather_columns,
                                          padded_rows)


def place_gallery_int4(gallery: torch.Tensor, mesh: Optional[Mesh],
                       axis: str = DATA_AXIS):
    """Quantize [N, D] (L2-normalized) rows to packed int4 and split rows
    and scales over the mesh. The FLOAT rows are padded before quantizing
    (a zero byte would decode to a low code of -8): a padding row packs
    to all-zero codes and scores exactly 0.0, so it cannot crowd a real
    row out of a shard's top k before the merge masks it. Without a mesh,
    quantize_rows_int4(gallery)."""
    if mesh is None:
        return quantize_rows_int4(gallery)
    rows = padded_rows(gallery.shape[0], mesh.shape[axis])
    packed, scales = quantize_rows_int4(_pad_rows(gallery, rows))
    return shard_rows(packed, mesh, axis), shard_rows(scales, mesh, axis)


def sharded_cosine_topk_int4(
    queries: torch.Tensor,     # [Q, D] float, L2-normalized
    packed,                    # uint8 [N, D/2] tensor or blocks
    scales,                    # f32 [N] tensor or blocks
    k: int,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    impl: str = "auto",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each shard's fused int4 scan (K5) + the global candidate merge: the
    sharded_cosine_topk contract over packed rows."""
    blocks, per = _blocks(packed, mesh, axis)
    sblocks, _ = _blocks(scales, mesh, axis)
    n_valid = per * len(blocks) if n_valid is None else n_valid
    return _sharded_scan(
        lambda q, g, s, kk: cosine_topk_int4(q, g, s, kk, impl=impl),
        queries, blocks, sblocks, per, k, mesh, axis, n_valid)


def sharded_similarities_int4(
    queries: torch.Tensor,     # [Q, D] float, L2-normalized
    packed,                    # uint8 [N, D/2] tensor or blocks
    scales,                    # f32 [N] tensor or blocks
    mesh: Mesh,
    axis: str = DATA_AXIS,
) -> torch.Tensor:
    """[Q, N_pad] approximate cosines, one column strip a shard (the
    calibration input)."""
    blocks, _ = _blocks(packed, mesh, axis)
    sblocks, _ = _blocks(scales, mesh, axis)
    qs: dict = {}
    return gather_columns(
        [similarities_int4(_on(queries, blocks[p].device, qs), blocks[p],
                           sblocks[p])
         for p in local_positions(mesh, axis)], mesh, axis)
