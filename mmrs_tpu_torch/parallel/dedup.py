"""All-pairs dedup over a row-sharded matrix: a ring of column blocks.

Counterpart of mmrs_tpu/parallel/dedup.py. The O(N^2) similarity matrix is
covered without any device holding more than its own row block and one
visiting block: at step t, shard i runs the fused `first_match` kernel
(K9) of its rows against block (i + t) % S, copied to its device, and
folds the result into a running per-row minimum global column. The row
and column offsets go into the kernel, so keep-first holds globally
inside it (filtering afterwards would drop valid later in-block columns).
Across processes the visiting block moves to the previous process with
torch.distributed send / recv, as JAX's ppermute moves it to the left
neighbour. The replacement for the reference's O(N^2) Python hash loops
(tool/find_repeated_in_same_folder.py:83-87, tool/delete repeated.py).
"""

from __future__ import annotations

from typing import List

import torch

from mmrs_tpu_torch.ops.allpairs import first_match
from mmrs_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, data_devices,
                                          local_positions, owners)
from mmrs_tpu_torch.parallel.multihost import (all_gather_processes,
                                               ring_exchange)
from mmrs_tpu_torch.parallel.topk import _blocks

BIG = 2 ** 30


def _shift(visiting: List[torch.Tensor], mine: List[int], mesh: Mesh,
           axis: str) -> List[torch.Tensor]:
    """One ring step: local shard j takes the block held by position
    mine[j] + 1 (wrapping), from the next local shard or, for the last
    one, from the process that owns the next position (which takes this
    process's first block in turn)."""
    s = mesh.shape[axis]
    own = owners(mesh, axis)
    nxt = (mine[-1] + 1) % s
    if nxt in mine:       # this process holds the whole ring
        tail = visiting[0]
    else:
        prev = own[(mine[0] - 1) % s]
        tail = ring_exchange(visiting[0], to_rank=prev, from_rank=own[nxt])
    return visiting[1:] + [tail]


def sharded_first_match(
    x,                        # [N, D] tensor or blocks; L2-normalized
    tau: float,
    mesh: Mesh,
    axis: str = DATA_AXIS,
    intra: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """For each row, the first (lowest-index) other row with cosine >= tau,
    or -1 (int64 [N], on the host); with intra=True only earlier rows
    count (keep-first dedup). Every process gets the whole vector.

    A ragged N is zero-padded to the next multiple of S; padding columns
    sit after every real column and are excluded by the `< n` mask, and
    padding rows are cut from the output. A placed list of blocks counts
    all of its rows as real (zero rows match nothing at tau > 0)."""
    blocks, per = _blocks(x, mesh, axis)
    n = x.shape[0] if isinstance(x, torch.Tensor) else per * len(blocks)
    devs = data_devices(mesh, axis)
    mine = local_positions(mesh, axis)
    s = len(blocks)
    runs = {p: torch.full((per,), BIG, dtype=torch.int64, device=devs[p])
            for p in mine}
    visiting = [blocks[p] for p in mine]
    for step in range(s):
        for j, p in enumerate(mine):
            src = (p + step) % s            # where the visiting block began
            block = visiting[j].to(devs[p])
            fm = first_match(blocks[p], block, tau, intra=intra,
                             row_offset=p * per, col_offset=src * per,
                             impl=impl).long()
            # padding columns (global id >= n) close the last block, so
            # masking them cannot hide an earlier real match in the block
            col = torch.where((fm >= 0) & (fm + src * per < n),
                              fm + src * per, BIG)
            runs[p] = torch.minimum(runs[p], col)
        if step + 1 < s:
            visiting = _shift(visiting, mine, mesh, axis)
    out = torch.stack([runs[p].cpu() for p in mine])     # [L, per]
    out = all_gather_processes(out).reshape(-1)[:n]
    return torch.where(out >= BIG, -1, out)
