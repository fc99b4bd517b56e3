"""Fused cosine top-k gallery scan — Hopper CUDA kernel + plain PyTorch version.

Counterpart of mmrs_tpu/ops/topk.py. The query engine's hot op: the best k
cosine scores of each query against the whole gallery, and their row ids,
without writing the [Q, N] score matrix to device memory. The kernel is
`csrc/cosine_topk.cu` (a scan pass on tensor cores, `csrc/span_scan.cuh`,
that keeps each span's best k by a running threshold when k <= 32, else
each 256-row chunk's best min(k, 256), then merge passes down to one list
of k; `span_rows` sizes the spans); the plain version
scores with an f32 matmul and takes a stable descending sort. Any k runs
on the card, as in mmrs_tpu: past the gallery's rows the answer is padded.

Both keep the reference kernel's tie rule (`_topk_merge`: first argmax,
earlier rows first): equal scores come back lowest row id first, and when
the gallery has fewer than k rows the missing places are (-inf, -1).

`cosine_topk(..., impl=)`:
  - "auto":  the kernel for CUDA tensors, the plain version for CPU tensors
  - "torch": the plain version on any device (tests, kernel comparisons)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from mmrs_tpu_torch.ops import _cuda

NEG_INF = float("-inf")
ROW_ALIGN = {"bf16": 8, "int8": 16}   # K1 / K4 row values a 16-byte multiple
CHUNK_ROWS = 256      # csrc/topk_common.cuh kChunk; checked at first load
SORT_MAX = 8192       # csrc/topk_common.cuh kMaxSort; checked at first load
SELECT_MAX = 32       # csrc/topk_common.cuh kSelectMax; checked at first load
SPAN_MAX = 2048       # most rows one K1 / K4 / K5 partial list covers
SPANS = 512           # K1 / K4 / K5 partial lists wanted for a large gallery
MERGE_WIDTH = 1024    # most candidates a merge block takes while k <= 256
MAX_QUERIES = 65535   # queries a launch takes (the merge grid's y extent)


def _pad(vals: torch.Tensor, idxs: torch.Tensor, k: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad [Q, n] lists to k columns with (-inf, -1)."""
    short = k - vals.shape[1]
    if short > 0:
        q = vals.shape[0]
        vals = torch.cat([vals, vals.new_full((q, short), NEG_INF)], dim=1)
        idxs = torch.cat([idxs, idxs.new_full((q, short), -1)], dim=1)
    return vals, idxs


def sorted_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain top-k of every scan here: stable descending sort of the
    f32 scores [Q, N] (lowest row first among equal scores), first k
    columns; padded with (-inf, -1) past the gallery."""
    vals, idxs = torch.sort(scores, dim=1, descending=True, stable=True)
    return _pad(vals[:, :k], idxs[:, :k].to(torch.int32), k)


def _cosine_topk_torch(queries: torch.Tensor, gallery: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    return sorted_topk(queries.float() @ gallery.float().T, k)


class MergePass(NamedTuple):
    """One merge pass: `lists` sorted lists of `length` -> ceil(lists /
    per) lists of `out`. width > 0: each block merges `per` lists in
    shared memory, each padded to a power of two, the group to `width`
    entries; width == 0: a merge-path pass over list pairs (per == 2)."""
    lists: int
    length: int
    per: int
    width: int
    out: int


# csrc/span_scan.cuh's shared memory: a ring stage of 256 128-byte row
# slices (+ 256 f32 row scales for int8 / int4), the staged query planes of
# 8 rows, a chunk's scores and the select buffers
_SCAN_STAGE = CHUNK_ROWS * 128
_SCAN_ONE = 232448 - 1024      # kScanSmemLimit: one block an SM
_SCAN_PAIR = 112 * 1024        # kScanSmemPair: two blocks an SM
_SCAN_FIXED = 8 * (CHUNK_ROWS + 2 * 384) * 4


def span_smem(kind: str, d: int, stages: int) -> int:
    """Dynamic shared memory of a span-scan block (csrc: scan_smem) for
    row kind "bf16", "int8" or "int4" at dim d."""
    row_bytes = {"bf16": 2 * d, "int8": d, "int4": d // 2}[kind]
    ksteps = -(-d // 16) if kind == "bf16" else -(-row_bytes // 32)
    planes = 2 if kind == "int4" else 1
    scales = 0 if kind == "bf16" else CHUNK_ROWS * 4
    return (stages * (_SCAN_STAGE + scales) + planes * 8 * (32 * ksteps + 16)
            + _SCAN_FIXED)


def span_stages(kind: str, d: int) -> int:
    """The ring depth of a span scan at dim d (csrc: scan_stages): 2 where
    two blocks fit an SM, else 5, else 3 (the query planes of a wide row
    take the room: bf16 past D = 2,160, int8 past 3,680); 0 where even 3
    stages do not fit (bf16 past D = 6,256, int8 past 12,128)."""
    if span_smem(kind, d, 2) <= _SCAN_PAIR:
        return 2
    return next((st for st in (5, 3) if span_smem(kind, d, st) <= _SCAN_ONE),
                0)


def pad_columns(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """x [..., D] with zero columns appended up to a multiple of
    `multiple` (x itself when D is one). A zero column adds an exact zero
    to every dot product, so scores, ids and int8 scales are unchanged;
    the search engine pads its gallery once when it places it on the
    card, a direct kernel call with a ragged D pads its inputs."""
    pad = -x.shape[-1] % multiple
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def span_rows(n: int, k: int) -> int:
    """Rows one partial list of the span scans (K1, K4, K5) covers: a 256-row
    chunk when k > SELECT_MAX (the chunk's candidates are sorted); else a
    span of whole chunks, up to SPAN_MAX rows, sized from N so that a
    large gallery gives about SPANS lists (2048 rows at N = 2^20): a block
    walks its span, so fewer lists cost fewer merges and block starts, but
    the card needs a few blocks per SM."""
    if k > SELECT_MAX:
        return CHUNK_ROWS
    chunks = -(-n // (SPANS * CHUNK_ROWS))
    return min(SPAN_MAX, max(1, chunks) * CHUNK_ROWS)


def scan_plan(n: int, k: int, rows: int = CHUNK_ROWS
              ) -> Tuple[int, int, List[MergePass]]:
    """Launch shapes: (partial lists a query = ceil(n / rows), the scan's
    partial list length kc = min(k, 256), the merge passes). `rows`: the
    gallery rows one partial list covers (256 for the bucket probes K7,
    K8, whose n counts 256-slot chunks; `span_rows` for the span scans
    K1, K4 and K5). Every pass merges at least two lists, so the list
    count falls to 1 for any k;
    the last pass's lists hold min(k, n_parts * kc) entries (the caller
    pads to k). Up to k = 256 a pass merges at most MERGE_WIDTH candidates
    per block (many blocks at small k); above, up to SORT_MAX, and lists
    too long for two to fit are merged in pairs by merge path."""
    n_parts = -(-n // rows)
    kc = min(k, CHUNK_ROWS)
    cap = MERGE_WIDTH if k <= CHUNK_ROWS else SORT_MAX
    passes, lists, length = [], n_parts, kc
    while lists > 1:
        padded = 1 << (length - 1).bit_length()     # a list's run in the sort
        if 2 * padded <= cap:
            per = min(lists, cap // padded)
            width = padded << (per - 1).bit_length()
        else:
            per, width = 2, 0
        out = min(k, per * length)
        passes.append(MergePass(lists, length, per, width, out))
        lists, length = -(-lists // per), out
    return n_parts, kc, passes


@lru_cache(maxsize=None)
def _library():
    """The kernel library, after checking that its launch geometry is the
    one `scan_plan` sizes the partial buffers for."""
    lib = _cuda.library()
    built = (lib.mmrs_topk_chunk_rows(), lib.mmrs_topk_max_sort(),
             lib.mmrs_topk_select_max())
    if built != (CHUNK_ROWS, SORT_MAX, SELECT_MAX):
        raise RuntimeError(
            f"csrc/topk_common.cuh has (kChunk, kMaxSort, kSelectMax) = "
            f"{built}, but ops/topk.py plans for "
            f"{(CHUNK_ROWS, SORT_MAX, SELECT_MAX)}")
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
    if d % ROW_ALIGN["bf16"] or not span_stages("bf16", d):
        raise ValueError(f"cosine_topk kernel needs D % 8 == 0 (a ragged D "
                         f"is padded first) and the 8 staged query rows in "
                         f"shared memory, got D={d}")
    check_scan_shapes("cosine_topk", q, n, k)
    if queries.data_ptr() % 16 or gallery.data_ptr() % 16:
        raise ValueError("cosine_topk kernel needs 16-byte aligned rows")


def scan_and_merge(q: int, n: int, k: int, device: torch.device,
                   scan: Callable[[int, int, int, int, int], int], what: str,
                   rows: int = CHUNK_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a gallery scan kernel and the merge passes that reduce its
    partials to the top k. `scan(kc, part_v, part_i, stream)` launches
    the scan (pointers as ints) and returns its CUDA error code; it writes
    the best kc of each `rows` gallery rows, sorted, into partials [Q,
    ceil(n / rows), kc] (f32 values, int32 ids), the format
    `mmrs_topk_merge` reads. Every gallery scan (bf16, int8, int4, the
    IVF probes) shares this plumbing. Q <= MAX_QUERIES (`by_query_slices`)."""
    lib = _library()
    n_parts, kc, passes = scan_plan(n, k, rows)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        vals = torch.empty((q, n_parts, kc), dtype=torch.float32,
                           device=device)
        idxs = torch.empty((q, n_parts, kc), dtype=torch.int32,
                           device=device)
        _cuda.check(scan(kc, vals.data_ptr(), idxs.data_ptr(), stream),
                    f"{what} scan")
        for p in passes:
            groups = -(-p.lists // p.per)
            nv = torch.empty((q, groups, p.out), dtype=torch.float32,
                             device=device)
            ni = torch.empty((q, groups, p.out), dtype=torch.int32,
                             device=device)
            _cuda.check(lib.mmrs_topk_merge(
                vals.data_ptr(), idxs.data_ptr(), q, p.lists, p.length,
                p.per, p.width, p.out, nv.data_ptr(), ni.data_ptr(), stream),
                f"{what} merge")
            vals, idxs = nv, ni
    return _pad(vals.view(q, -1), idxs.view(q, -1), k)


def by_query_slices(q: int, run: Callable[[int, int], Tuple[torch.Tensor,
                                                            torch.Tensor]]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`run(start, stop)` over query slices of at most MAX_QUERIES (one
    launch sequence each), the results concatenated along Q."""
    if q <= MAX_QUERIES:
        return run(0, q)
    parts = [run(a, min(q, a + MAX_QUERIES))
             for a in range(0, q, MAX_QUERIES)]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))


def check_scan_shapes(name: str, q: int, n: int, k: int) -> None:
    """Limits every gallery scan kernel shares: any k (past the gallery
    the answer is padded with (-inf, -1)), the [Q, k] outputs and the
    gallery positions indexed in 32 bits."""
    if not (1 <= k and min(q, MAX_QUERIES) * k < 2 ** 31):
        raise ValueError(f"{name} kernel needs 1 <= k and min(Q, "
                         f"{MAX_QUERIES}) * k < 2^31, got Q={q}, k={k}")
    if not (1 <= q and 1 <= n < 2 ** 31):
        raise ValueError(f"{name} kernel needs 1 <= Q and 1 <= N < 2^31, "
                         f"got Q={q}, N={n}")


def _cosine_topk_cuda(queries: torch.Tensor, gallery: torch.Tensor, k: int,
                      rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel path; `rows` (tests only) forces the span that
    `span_rows` would pick. A D off a multiple of 8 is zero-padded (a copy
    of the gallery: the engine pads once when it places it)."""
    if queries.dim() == 2 and gallery.dim() == 2:
        queries = pad_columns(queries, ROW_ALIGN["bf16"])
        gallery = pad_columns(gallery, ROW_ALIGN["bf16"])
    _check_kernel_inputs(queries, gallery, k)
    (q, d), n = queries.shape, gallery.shape[0]
    rows = rows or span_rows(n, k)

    def run(a: int, b: int):
        qs = queries[a:b]
        return scan_and_merge(
            b - a, n, k, queries.device,
            lambda kc, pv, pi, stream: _library().mmrs_topk_scan(
                qs.data_ptr(), gallery.data_ptr(), b - a, n, d, kc, rows, pv,
                pi, stream), "cosine_topk", rows)

    out = by_query_slices(q, run)
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
    if _cuda.takes_kernel(impl, queries):
        return _cosine_topk_cuda(queries, gallery, k)
    return _cosine_topk_torch(queries, gallery, k)


cosine_topk.launches = 0   # kernel launches, for showing the path ran it
