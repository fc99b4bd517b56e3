"""All-pairs first match above a threshold — Hopper CUDA kernel + plain PyTorch version.

Counterpart of mmrs_tpu/ops/allpairs.py, the semantic-dedup engine:
  - intra-set dedup: for each row i, the FIRST earlier row j < i with
    cosine >= tau (keep-first; chains are resolved on the host);
  - cross-set leakage: for each train row, the first test row with
    cosine >= tau.
The [N, M] similarity matrix is never kept whole: the kernel
(`csrc/first_match.cu`, K9) reduces each tile in registers, and the plain
version scores row blocks of at most ~1 GiB of f32 at a time (131,072^2 f32
would be 64 GiB).

The kernel runs bf16 products on tensor cores. f32 rows first go through a
pre-pass that writes each row as three bf16 planes hi + mid + lo (== the
row, exactly, for normal values; `split_bf16x3` is its plain form) into a
[3, N, D] bf16 buffer, 1.5x the f32 input's bytes (one buffer under
`intra`, where a and b are one tensor); the kernel then sums six of the
nine plane products (`SPLIT_PRODUCTS`) in f32: the five smaller ones over
all of D first, then hi.hi, so that the tensor cores' accumulation, which
drops low bits toward zero as it adds, works on a small sum while the
corrections go in. The three it drops are at most 3 * 2^-24 * sum
|a_i b_i|.

`first_match(..., impl=)`:
  - "auto":  the kernel for CUDA tensors, the plain version for CPU tensors
  - "torch": the plain version on any device (tests, kernel comparisons)
  - "cuda":  the kernel (raises on CPU tensors)
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.ops import _cuda
from mmrs_tpu_torch.ops.topk import pad_columns

BIG = 2 ** 30
PLAIN_BLOCK_BYTES = 1 << 30      # f32 similarity rows per plain-version block
# csrc/first_match.cu's geometry, checked against the built library at
# first load: tile rows and columns, and by input planes (1: bf16 rows; 3:
# the hi/mid/lo planes of f32 rows) the K step (bf16 values a stage: 128-
# or 64-byte rows), the ring stages and the dynamic shared memory (a stage
# holds every plane's A and B tiles; + the 1024-byte tile alignment)
TILE_M = 128
TILE_N = 256
K_STEP = {1: 64, 3: 32}
STAGES = {1: 4, 3: 3}
SMEM_BYTES = {p: STAGES[p] * p * (TILE_M + TILE_N) * 2 * K_STEP[p] + 1024
              for p in K_STEP}
# the (a plane, b plane) of each product the f32 route sums, in the
# kernel's order, smallest first (0 hi, 1 mid, 2 lo): kPlaneA / kPlaneB;
# the first five in a first pass over D, hi.hi in a second
SPLIT_PRODUCTS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
_PLANES = {torch.bfloat16: 1, torch.float32: 3}


def _f32(tau: float) -> float:
    """tau rounded to f32, as the reference passes it (jnp.asarray([tau],
    f32)): both versions then compare f32 sums against the same number."""
    return float(np.float32(tau))


def _first_match_torch(a: torch.Tensor, b: torch.Tensor, tau: float,
                       intra: bool = False, row_offset: int = 0,
                       col_offset: int = 0) -> torch.Tensor:
    """The reference's `_first_match_xla`, over row blocks: f32 scores of
    the inputs' values, `>= tau`, the keep-first mask, the lowest column."""
    n, m = a.shape[0], b.shape[0]
    out = torch.full((n,), -1, dtype=torch.int32, device=a.device)
    if n == 0 or m == 0:
        return out
    tau = _f32(tau)
    bf = b.float()
    cols = torch.arange(m, dtype=torch.int32, device=a.device)
    rows_per = max(1, PLAIN_BLOCK_BYTES // (4 * m))
    for r0 in range(0, n, rows_per):
        r1 = min(r0 + rows_per, n)
        mask = (a[r0:r1].float() @ bf.T) >= tau
        if intra:
            rows = torch.arange(r0, r1, dtype=torch.int64, device=a.device)
            mask &= (cols[None, :].long() + col_offset) < (
                rows[:, None] + row_offset)
        first = torch.where(mask, cols[None, :], BIG).amin(dim=1)
        out[r0:r1] = torch.where(first >= BIG, -1, first).to(torch.int32)
    return out


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """[3, *x.shape] bf16 planes hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid) of f32 x, each rounded to nearest even; the
    subtractions are exact in f32, so hi + mid + lo == x for normal
    values. The plain form of the kernel's pre-pass."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


class FirstMatchPlan(NamedTuple):
    planes: int           # bf16 planes a row: 1, or 3 (hi, mid, lo) for f32
    tile_m: int           # rows of a block (two warpgroups of 64)
    tile_n: int           # columns of a walk step (one wgmma n256)
    k_step: int           # bf16 values of K a ring stage
    stages: int           # cp.async ring depth


def first_match_plan(n: int, m: int, d: int,
                     dtype: torch.dtype) -> FirstMatchPlan:
    """Launch shape of the kernel for a [n, d] against b [m, d] in `dtype`.
    Refuses, with a message, what it cannot run: D % 8 (16-byte row
    chunks; `first_match` pads a ragged D with zero columns first), N or
    M past 2^31, an input type other than bf16 or f32."""
    if dtype not in _PLANES:
        raise ValueError(f"first_match kernel takes f32 or bf16 inputs of "
                         f"one dtype, got {dtype}")
    if d % 8 or d < 8:
        raise ValueError(f"first_match kernel needs D % 8 == 0 (16-byte "
                         f"row vectors), got D={d}")
    if n >= 2 ** 31 or m >= 2 ** 31 or n < 0 or m < 0:
        raise ValueError(f"first_match kernel needs N, M < 2^31, got "
                         f"N={n}, M={m}")
    planes = _PLANES[dtype]
    return FirstMatchPlan(planes, TILE_M, TILE_N, K_STEP[planes],
                          STAGES[planes])


@lru_cache(maxsize=None)
def _library():
    """The kernel library, after checking that its geometry is the one
    `first_match_plan` describes."""
    lib = _cuda.library()
    built = tuple(lib.mmrs_first_match_geometry(i) for i in range(8))
    want = (TILE_M, TILE_N, *(v for p in (1, 3)
                              for v in (K_STEP[p], STAGES[p], SMEM_BYTES[p])))
    if built != want:
        raise RuntimeError(
            f"csrc/first_match.cu has the geometry {built}, but "
            f"ops/allpairs.py plans for {want}")
    return lib


def _split_cuda(lib, x: torch.Tensor) -> torch.Tensor:
    """The kernel's pre-pass: `split_bf16x3(x)` on the card."""
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    _cuda.check(lib.mmrs_split_bf16x3(x.data_ptr(), out.data_ptr(),
                                      x.numel(), _cuda.stream_of(x)),
                "first_match split")
    return out


def _first_match_cuda(a: torch.Tensor, b: torch.Tensor, tau: float,
                      intra: bool, row_offset: int, col_offset: int
                      ) -> torch.Tensor:
    _cuda.require_cuda("first_match", a, b)
    if b.dtype != a.dtype:
        raise ValueError(f"first_match kernel takes f32 or bf16 inputs of "
                         f"one dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"first_match takes a [N, D] and b [M, D], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] % 8:   # zero columns: every dot product exactly as it was
        shared = a.data_ptr() == b.data_ptr() and a.shape == b.shape
        a = pad_columns(a, 8)
        b = a if shared else pad_columns(b, 8)
    (n, d), m = a.shape, b.shape[0]
    plan = first_match_plan(n, m, d, a.dtype)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("first_match kernel needs 16-byte aligned rows")
    out = torch.empty((n,), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    with torch.cuda.device(a.device):
        lib = _library()
        if plan.planes > 1:
            shared = a.data_ptr() == b.data_ptr() and a.shape == b.shape
            a = _split_cuda(lib, a)
            b = a if shared else _split_cuda(lib, b)
        _cuda.check(lib.mmrs_first_match(
            a.data_ptr(), b.data_ptr(), n, m, d, _f32(tau), int(intra),
            int(row_offset), int(col_offset), plan.planes, out.data_ptr(),
            _cuda.stream_of(out)), "first_match")
    first_match.launches += 1
    return out


def first_match(
    a: torch.Tensor,       # [N, D] rows to test, L2-normalized
    b: torch.Tensor,       # [M, D] candidate keepers, L2-normalized
    tau: float,
    intra: bool = False,
    row_offset: int = 0,
    col_offset: int = 0,
    impl: str = "auto",
) -> torch.Tensor:
    """For each row of `a`, the LOCAL index of the first row of `b` with
    cosine >= tau, or -1 (int32 [N]). With `intra=True` only columns whose
    global id (local + col_offset) precedes the row's global id (local +
    row_offset) count: keep-first dedup; offsets of 0 when a and b are the
    same unsharded matrix. On a CUDA tensor the kernel runs, or this
    raises: there is no fallback."""
    if _cuda.takes_kernel(impl, a):
        return _first_match_cuda(a, b, tau, intra, int(row_offset),
                                 int(col_offset))
    return _first_match_torch(a, b, tau, intra, int(row_offset),
                              int(col_offset))


first_match.launches = 0   # kernel launches, for showing the path ran it


def dedup_groups(first) -> Tuple[List[int], Dict[int, int]]:
    """Resolve first-match chains on the host: (keeper rows, {dup row:
    keeper row}). A row whose first match is -1 is a keeper; otherwise it
    is a duplicate of its (transitively resolved) keeper."""
    f = first.cpu().numpy() if isinstance(first, torch.Tensor) else \
        np.asarray(first)
    keeper_of: Dict[int, int] = {}
    keepers: List[int] = []
    for i in range(len(f)):
        j = int(f[i])
        if j < 0:
            keepers.append(i)
        else:
            keeper_of[i] = keeper_of.get(j, j)
    return keepers, keeper_of
