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

`first_match(..., impl=)`:
  - "auto":  the kernel for CUDA tensors, the plain version for CPU tensors
  - "torch": the plain version on any device (tests, kernel comparisons)
  - "cuda":  the kernel (raises on CPU tensors)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.ops import _cuda

BIG = 2 ** 30
PLAIN_BLOCK_BYTES = 1 << 30      # f32 similarity rows per plain-version block
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


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


def _first_match_cuda(a: torch.Tensor, b: torch.Tensor, tau: float,
                      intra: bool, row_offset: int, col_offset: int
                      ) -> torch.Tensor:
    _cuda.require_cuda("first_match", a, b)
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"first_match kernel takes f32 or bf16 inputs of "
                         f"one dtype, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"first_match takes a [N, D] and b [M, D], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    (n, d), m = a.shape, b.shape[0]
    if d % 8:
        raise ValueError(f"first_match kernel needs D % 8 == 0 (16-byte "
                         f"row vectors), got D={d}")
    if n >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"first_match kernel needs N, M < 2^31, got "
                         f"N={n}, M={m}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("first_match kernel needs 16-byte aligned rows")
    out = torch.empty((n,), dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    with torch.cuda.device(a.device):
        _cuda.check(_cuda.library().mmrs_first_match(
            a.data_ptr(), b.data_ptr(), n, m, d, _f32(tau), int(intra),
            int(row_offset), int(col_offset), _DTYPE_CODE[a.dtype],
            out.data_ptr(), _cuda.stream_of(a)), "first_match")
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
    if impl not in ("auto", "torch", "cuda"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or (impl == "auto" and a.device.type == "cpu"):
        return _first_match_torch(a, b, tau, intra, int(row_offset),
                                  int(col_offset))
    return _first_match_cuda(a, b, tau, intra, int(row_offset),
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
