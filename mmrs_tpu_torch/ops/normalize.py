"""L2 normalization used everywhere in the retrieval path.

Counterpart of mmrs_tpu/ops/normalize.py: the reference normalizes every
embedding before similarity (CLIP/lab1.py:89); the math runs in f32 even
for bf16 inputs so that cosine rankings are stable.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    x32 = x.float()
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    return (x32 / torch.clamp(norm, min=eps)).to(x.dtype)
