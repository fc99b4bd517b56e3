"""Streaming top-k over galleries larger than device memory.

Counterpart of mmrs_tpu/index/stream.py on one device: row chunks of an
on-disk (memmapped) gallery are uploaded in their source dtype, cast to
bf16 on the device and scanned by the fused top-k (ops/topk.py: K1 on a
GPU); only [Q, k] candidates per chunk are kept, and they are merged on
the host at the end with a stable sort (equal scores: earlier chunk, then
lower row first — the flat scan's rule). Device memory is bounded by one
chunk whatever the gallery size. The exact oracle of `ivf.tune_nprobe`.
The multi-device branch is ported with ROADMAP A.12.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mmrs_tpu_torch.ops.topk import NEG_INF, cosine_topk
from mmrs_tpu_torch.pipeline import default_device


def streaming_topk(
    embeddings,                   # [N, D] array-like (np.memmap ok), f16/f32
    queries: np.ndarray,          # [Q, D] (unnormalized ok — caller's call)
    k: int = 10,
    chunk_rows: int = 1 << 20,
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (values [Q, k] f32, global row ids [Q, k] int64). When the
    gallery holds fewer than k rows the surplus places are (-inf, -1)."""
    device = torch.device(device) if device is not None else default_device()
    n = embeddings.shape[0]
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(device).to(dtype)
    vals, idxs = [], []
    for a in range(0, n, chunk_rows):
        b = min(a + chunk_rows, n)
        chunk = torch.from_numpy(np.array(embeddings[a:b]))
        v, i = cosine_topk(q, chunk.to(device).to(dtype), k=min(k, b - a),
                           impl=impl)
        vals.append(v)
        idxs.append(i.long() + a)
    merged_v = torch.cat(vals, dim=1).cpu().numpy()
    merged_i = torch.cat(idxs, dim=1).cpu().numpy()
    if merged_v.shape[1] < k:     # tiny gallery: pad with sentinels
        pad = k - merged_v.shape[1]
        merged_v = np.pad(merged_v, ((0, 0), (0, pad)),
                          constant_values=NEG_INF)
        merged_i = np.pad(merged_i, ((0, 0), (0, pad)), constant_values=-1)
    order = np.argsort(-merged_v, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(merged_v, order, 1),
            np.take_along_axis(merged_i, order, 1))
