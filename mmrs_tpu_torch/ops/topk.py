"""Fused cosine top-k gallery scan — Hopper CUDA kernel + plain PyTorch version.

Counterpart of mmrs_tpu/ops/topk.py. The query engine's hot op: the best k
cosine scores of each query against the whole gallery, and their row ids,
without writing the [Q, N] score matrix to device memory. The kernel is
`csrc/cosine_topk.cu` (a scan pass that keeps each 256-row chunk's best k,
then merge passes); the plain version scores with an f32 matmul and takes a
stable descending sort.

Both keep the reference kernel's tie rule (`_topk_merge`: first argmax,
earlier rows first): equal scores come back lowest row id first, and when
the gallery has fewer than k rows the missing places are (-inf, -1).

`cosine_topk(..., impl=)`:
  - "auto":  the kernel for CUDA tensors, the plain version for CPU tensors
  - "torch": the plain version on any device (tests, kernel comparisons)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from mmrs_tpu_torch.ops import _cuda

NEG_INF = float("-inf")
MAX_K = 256           # the scan keeps at most one 256-row chunk per list
MAX_DIM = 2048        # staged queries must fit the scan block's shared memory
CHUNK_ROWS = 256      # csrc/cosine_topk.cu kChunk; checked at first load
MERGE_WIDTH = 1024    # csrc/cosine_topk.cu kMergeWidth; checked at first load


def _cosine_topk_torch(queries: torch.Tensor, gallery: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 scores, stable descending sort (lowest row first among equal
    scores), first k columns; padded with (-inf, -1) past the gallery."""
    scores = queries.float() @ gallery.float().T
    vals, idxs = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idxs = vals[:, :k], idxs[:, :k].to(torch.int32)
    short = k - vals.shape[1]
    if short > 0:
        q = vals.shape[0]
        vals = torch.cat([vals, vals.new_full((q, short), NEG_INF)], dim=1)
        idxs = torch.cat([idxs, idxs.new_full((q, short), -1)], dim=1)
    return vals, idxs


def scan_plan(q: int, n: int, k: int) -> Tuple[int, int, int, list]:
    """Launch shapes: (queries per scan block, gallery chunks, partial lists
    merged per merge block, list count after each pass). The last count is
    1: that pass's output is the answer."""
    qt = 1 if q == 1 else 2 if q == 2 else 4 if q <= 4 else 8
    n_chunks = -(-n // CHUNK_ROWS)
    per = MERGE_WIDTH // k
    lists = [n_chunks]
    while lists[-1] > 1:
        lists.append(-(-lists[-1] // per))
    return qt, n_chunks, per, lists


@lru_cache(maxsize=None)
def _library():
    """The kernel library, after checking that its launch geometry is the
    one `scan_plan` sizes the partial buffers for."""
    lib = _cuda.library()
    built = (lib.mmrs_topk_chunk_rows(), lib.mmrs_topk_merge_width())
    if built != (CHUNK_ROWS, MERGE_WIDTH):
        raise RuntimeError(
            f"csrc/cosine_topk.cu has (kChunk, kMergeWidth) = {built}, but "
            f"ops/topk.py plans for {(CHUNK_ROWS, MERGE_WIDTH)}")
    return lib


def _check_kernel_inputs(queries: torch.Tensor, gallery: torch.Tensor, k: int
                         ) -> None:
    _cuda.require_cuda("cosine_topk", queries, gallery)
    if queries.dtype != torch.bfloat16 or gallery.dtype != torch.bfloat16:
        raise ValueError(f"cosine_topk kernel takes bf16, got "
                         f"{queries.dtype} and {gallery.dtype}")
    if queries.dim() != 2 or gallery.dim() != 2:
        raise ValueError("cosine_topk takes queries [Q, D] and gallery [N, D]")
    (q, d), (n, dg) = queries.shape, gallery.shape
    if d != dg:
        raise ValueError(f"query dim {d} != gallery dim {dg}")
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"cosine_topk kernel needs D % 8 == 0 and D <= "
                         f"{MAX_DIM}, got D={d}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"cosine_topk kernel supports 1 <= k <= {MAX_K}, "
                         f"got k={k}")
    if not (1 <= q <= 65535 and 1 <= n < 2 ** 31):
        raise ValueError(f"cosine_topk kernel needs 1 <= Q <= 65535 and "
                         f"1 <= N < 2^31, got Q={q}, N={n}")
    if queries.data_ptr() % 16 or gallery.data_ptr() % 16:
        raise ValueError("cosine_topk kernel needs 16-byte aligned rows")


def _cosine_topk_cuda(queries: torch.Tensor, gallery: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(queries, gallery, k)
    lib = _library()
    (q, d), n = queries.shape, gallery.shape[0]
    qt, n_chunks, per, lists = scan_plan(q, n, k)
    dev = queries.device
    with torch.cuda.device(dev):
        stream = _cuda.stream_of(queries)
        vals = torch.empty((q, n_chunks, k), dtype=torch.float32, device=dev)
        idxs = torch.empty((q, n_chunks, k), dtype=torch.int32, device=dev)
        _cuda.check(lib.mmrs_topk_scan(
            queries.data_ptr(), gallery.data_ptr(), q, n, d, k, qt,
            vals.data_ptr(), idxs.data_ptr(), stream), "cosine_topk scan")
        cosine_topk.launches += 1
        for s, groups in zip(lists, lists[1:]):
            nv = torch.empty((q, groups, k), dtype=torch.float32, device=dev)
            ni = torch.empty((q, groups, k), dtype=torch.int32, device=dev)
            _cuda.check(lib.mmrs_topk_merge(
                vals.data_ptr(), idxs.data_ptr(), q, s, k, per,
                nv.data_ptr(), ni.data_ptr(), stream), "cosine_topk merge")
            vals, idxs = nv, ni
    return vals.view(q, k), idxs.view(q, k)


def cosine_topk(
    queries: torch.Tensor,   # [Q, D], L2-normalized
    gallery: torch.Tensor,   # [N, D], L2-normalized
    k: int = 10,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine scores and gallery row ids for each query.

    Returns (values [Q, k] f32, ids [Q, k] int32), best first. On a CUDA
    tensor the kernel runs, or this raises: there is no fallback.
    """
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or queries.device.type == "cpu":
        return _cosine_topk_torch(queries, gallery, k)
    return _cosine_topk_cuda(queries, gallery, k)


cosine_topk.launches = 0   # kernel launches, for showing the path ran it
