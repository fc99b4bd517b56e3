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
from typing import Callable, Tuple

import torch

from mmrs_tpu_torch.ops import _cuda

NEG_INF = float("-inf")
MAX_K = 256           # the scan keeps at most one 256-row chunk per list
MAX_DIM = 2048        # staged queries must fit the scan block's shared memory
CHUNK_ROWS = 256      # csrc/topk_common.cuh kChunk; checked at first load
MERGE_WIDTH = 1024    # csrc/topk_common.cuh kMergeWidth; checked at first load


def sorted_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain top-k of every scan here: stable descending sort of the
    f32 scores [Q, N] (lowest row first among equal scores), first k
    columns; padded with (-inf, -1) past the gallery."""
    vals, idxs = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idxs = vals[:, :k], idxs[:, :k].to(torch.int32)
    short = k - vals.shape[1]
    if short > 0:
        q = vals.shape[0]
        vals = torch.cat([vals, vals.new_full((q, short), NEG_INF)], dim=1)
        idxs = torch.cat([idxs, idxs.new_full((q, short), -1)], dim=1)
    return vals, idxs


def _cosine_topk_torch(queries: torch.Tensor, gallery: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return sorted_topk(queries.float() @ gallery.float().T, k)


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
            f"csrc/topk_common.cuh has (kChunk, kMergeWidth) = {built}, but "
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
    check_scan_shapes("cosine_topk", q, n, k)
    if queries.data_ptr() % 16 or gallery.data_ptr() % 16:
        raise ValueError("cosine_topk kernel needs 16-byte aligned rows")


def scan_and_merge(q: int, n: int, k: int, device: torch.device,
                   scan: Callable[[int, int, int, int], int], what: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a gallery scan kernel and the merge passes that reduce its
    per-chunk partials to the top k. `scan(qt, part_v, part_i, stream)`
    launches the scan (pointers as ints) and returns its CUDA error code;
    it writes the best k of each 256-row chunk, sorted, into partials
    [Q, n_chunks, k] (f32 values, int32 ids), the format `mmrs_topk_merge`
    reads. Every gallery scan (bf16, int8, int4) shares this plumbing."""
    lib = _library()
    qt, n_chunks, per, lists = scan_plan(q, n, k)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        vals = torch.empty((q, n_chunks, k), dtype=torch.float32,
                           device=device)
        idxs = torch.empty((q, n_chunks, k), dtype=torch.int32,
                           device=device)
        _cuda.check(scan(qt, vals.data_ptr(), idxs.data_ptr(), stream),
                    f"{what} scan")
        for s, groups in zip(lists, lists[1:]):
            nv = torch.empty((q, groups, k), dtype=torch.float32,
                             device=device)
            ni = torch.empty((q, groups, k), dtype=torch.int32,
                             device=device)
            _cuda.check(lib.mmrs_topk_merge(
                vals.data_ptr(), idxs.data_ptr(), q, s, k, per,
                nv.data_ptr(), ni.data_ptr(), stream), f"{what} merge")
            vals, idxs = nv, ni
    return vals.view(q, k), idxs.view(q, k)


def check_scan_shapes(name: str, q: int, n: int, k: int) -> None:
    """Limits every gallery scan kernel shares (one 256-row chunk per
    partial list, the grid's query tiles)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name} kernel supports 1 <= k <= {MAX_K}, "
                         f"got k={k}")
    if not (1 <= q <= 65535 and 1 <= n < 2 ** 31):
        raise ValueError(f"{name} kernel needs 1 <= Q <= 65535 and "
                         f"1 <= N < 2^31, got Q={q}, N={n}")


def _cosine_topk_cuda(queries: torch.Tensor, gallery: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_kernel_inputs(queries, gallery, k)
    (q, d), n = queries.shape, gallery.shape[0]
    out = scan_and_merge(
        q, n, k, queries.device,
        lambda qt, pv, pi, stream: _library().mmrs_topk_scan(
            queries.data_ptr(), gallery.data_ptr(), q, n, d, k, qt, pv, pi,
            stream), "cosine_topk")
    cosine_topk.launches += 1
    return out


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
