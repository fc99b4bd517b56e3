"""K-means for k-shot prototypes, and the silhouette score.

Counterpart of mmrs_tpu/ops/kmeans.py, which replaces sklearn's KMeans in
the reference's cluster prototypes (code/search_image.py:185-232, k=2) and
its silhouette scan (code/search_image.py:234-293). The seeding is the
JAX package's deterministic farthest-point rule and the iteration count
is fixed, so both packages pick the same seeds and, up to the order of
the f32 sums, the same centroids. Ties go to the lowest index, as
`jnp.argmax` / `jnp.argmin` resolve them (and as `torch.argmax` /
`torch.argmin` do). Plain PyTorch: the k-shot sets are tiny.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sq_dists(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """[N, k] squared distances by the matmul expansion (as the JAX
    package computes them)."""
    x2 = (x * x).sum(1, keepdim=True)
    c2 = (cents * cents).sum(1)[None, :]
    return x2 + c2 - 2.0 * (x @ cents.T)


def kmeans(x: torch.Tensor, k: int, iters: int = 25
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, D] -> (centroids [k, D] f32, assignments [N] int64)."""
    x = x.float()
    # farthest-point seeds: each new seed is the row farthest from the
    # seeds so far; the newest seed sits at row 0 of the centroid array
    cents = x[0].repeat(k, 1)
    dists = ((x - x[0]) ** 2).sum(1)
    for _ in range(k - 1):
        new_c = x[torch.argmax(dists)]
        cents = torch.roll(cents, 1, dims=0)
        cents[0] = new_c
        dists = torch.minimum(dists, ((x - new_c) ** 2).sum(1))

    for _ in range(iters):
        # one-hot sums, as the JAX package takes them: a matmul, so the
        # same inputs give the same centroids on a GPU too (index_add_
        # there adds with atomics, in no fixed order)
        onehot = torch.nn.functional.one_hot(
            torch.argmin(_sq_dists(x, cents), dim=1), k).float()
        counts = onehot.sum(0)
        cents = torch.where(counts[:, None] > 0,
                            (onehot.T @ x) / counts.clamp_min(1.0)[:, None],
                            cents)
    return cents, torch.argmin(_sq_dists(x, cents), dim=1)


def silhouette_score(x: torch.Tensor, assign: torch.Tensor, k: int
                     ) -> torch.Tensor:
    """Mean silhouette coefficient (O(N^2) pairwise distances, for the
    small k-shot sets it is applied to). Empty clusters read +inf as the
    nearest other cluster, not 0, so they cannot force s = -1."""
    x = x.float()
    n = x.shape[0]
    x2 = (x * x).sum(1)
    d = torch.sqrt(torch.clamp(x2[:, None] + x2[None, :] - 2.0 * (x @ x.T),
                               min=0.0))
    onehot = torch.nn.functional.one_hot(assign.long(), k).float()  # [N, k]
    counts = onehot.sum(0)
    sums = d @ onehot                                               # [N, k]
    own_count = counts[assign]
    a = sums[torch.arange(n), assign] / torch.clamp(own_count - 1.0, min=1.0)
    mean_to = torch.where(counts[None, :] > 0,
                          sums / counts.clamp_min(1.0)[None, :],
                          torch.tensor(float("inf")))
    b = torch.where(onehot.bool(), torch.tensor(float("inf")),
                    mean_to).amin(1)
    s = torch.where(own_count > 1,
                    (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12),
                    torch.zeros(()))
    return s.mean()
