"""Exact cosine top-k over a gallery held on the host, in float32 blocks."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark.reference.common import fake_int8, l2_normalize

BLOCK_ROWS = 1 << 18


def _rows(gallery: np.ndarray, a: int, b: int, device) -> torch.Tensor:
    return l2_normalize(torch.from_numpy(np.asarray(gallery[a:b])).to(
        device).float())


def topk(queries: torch.Tensor, gallery: np.ndarray, k: int,
         int8: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k], rows [Q, k]) of the k best cosines of each query
    against every gallery row, best first. `int8` (the control) rounds the
    query and gallery rows to int8 codes first."""
    q = l2_normalize(queries.float())
    if int8:
        q = fake_int8(q)
    best_v = torch.full((q.shape[0], k), float("-inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.long,
                        device=q.device)
    for a in range(0, gallery.shape[0], BLOCK_ROWS):
        g = _rows(gallery, a, a + BLOCK_ROWS, q.device)
        if int8:
            g = fake_int8(g)
        v, i = (q @ g.T).topk(min(k, g.shape[0]), dim=1)
        v = torch.cat([best_v, v], 1)
        i = torch.cat([best_i, i + a], 1)
        best_v, order = v.topk(k, dim=1)
        best_i = i.gather(1, order)
    return best_v, best_i


def scores_of(queries: torch.Tensor, gallery: np.ndarray,
              rows: np.ndarray) -> torch.Tensor:
    """float32 cosines [Q, k] of each query against its listed rows."""
    q = l2_normalize(queries.float())
    flat = np.asarray(rows).reshape(-1)
    g = l2_normalize(torch.from_numpy(np.asarray(gallery[flat])).to(
        q.device).float()).reshape(*rows.shape, -1)
    return torch.einsum("qd,qkd->qk", q, g)
