"""Tip-Adapter and Tip-Adapter-F few-shot classification over CLIP features.

Counterpart of mmrs_tpu/adapt/tip_adapter.py (reference:
code/main_custom.py:108-247 and code/utils.py:99-206), as tensor
functions:
  - cache model (`build_cache`): augment_epoch feature passes over the
    k-shot train set, MEAN over passes, L2-normalize -> cache keys; the
    values are the one-hot labels;
  - training-free Tip-Adapter:
        affinity     = feat @ keys.T
        cache_logits = exp(-beta * (1 - affinity)) @ values
        clip_logits  = 100 * feat @ clip_weights
        tip_logits   = clip_logits + alpha * cache_logits
  - Tip-Adapter-F: the keys become a trainable f32 matrix initialized from
    the cache keys; AdamW (weight decay 0.01 on every parameter, as optax's
    `adamw` without a mask) under optax's cosine decay, stepped once per
    optimizer step; CE loss on the tip logits; the best checkpoint by
    macro-F1. Batches come from numpy's `default_rng(seed).permutation`,
    so both packages train on the same batches;
  - hyperparameter search (`search_hp`): the F1 grid over beta in (0,
    scale0] and alpha in (0, scale1]. The JAX package evaluates the whole
    grid in one vmap; here the betas go in chunks whose [betas, N, NK]
    temporaries stay within GRID_BYTES.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mmrs_tpu_torch.ops.normalize import l2_normalize
from mmrs_tpu_torch.search.metrics import macro_f1

GRID_BYTES = 64 << 20   # the largest temporaries of one chunk of the grid


def _tensor(x, device=None, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype)


def build_cache(
    aug_features,                 # [E, NK, D] one row per augment pass
    labels,                       # [NK] int
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (keys [NK, D] L2-normalized, values [NK, C] one-hot), f32 on the
    features' device."""
    aug = _tensor(aug_features, dtype=torch.float32)
    keys = l2_normalize(aug.mean(dim=0))
    values = F.one_hot(_tensor(labels, aug.device).long(),
                       num_classes).float()
    return keys, values


def build_cache_from_folder(
    image_encode_raw,             # pixels_u8 [B,S,S,3] -> RAW [B,D] feats
    shot_paths,                   # NK image paths (k per class)
    shot_labels,                  # NK int labels
    num_classes: int,
    augment_epoch: int = 10,
    image_size: int = 224,
    batch_size: int = 64,
    seed: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The build_cache_model driver (code/utils.py:99-132): augment_epoch
    tower passes over the k-shot images with RandomResizedCrop(0.5-1.0,
    bicubic) + HFlip, RAW features meaned over passes then L2-normalized
    into the cache keys. Returns (keys [NK,D], values [NK,C],
    aug_normalized [E,NK,D] — per-pass L2-normalized features for
    per-epoch adapter training), on `device` (default: the CPU)."""
    from mmrs_tpu_torch.io.augment import augmented_epochs

    passes = []
    for views in augmented_epochs(shot_paths, augment_epoch,
                                  size=image_size, seed=seed):
        passes.append(np.concatenate([
            np.asarray(image_encode_raw(views[a:a + batch_size]), np.float32)
            for a in range(0, len(views), batch_size)]))
    aug = torch.from_numpy(np.stack(passes)).to(device)     # [E, NK, D] raw
    keys, values = build_cache(aug, np.asarray(shot_labels, np.int64),
                               num_classes)
    return keys, values, l2_normalize(aug)


def tip_logits(
    feats: torch.Tensor,          # [N, D] L2-normalized test features
    keys: torch.Tensor,           # [NK, D]
    values: torch.Tensor,         # [NK, C]
    clip_weights: torch.Tensor,   # [D, C] normalized text classifier
    alpha: float,
    beta: float,
) -> torch.Tensor:
    affinity = feats @ keys.T                                   # [N, NK]
    cache_logits = torch.exp(-beta * (1.0 - affinity)) @ values  # [N, C]
    clip_logits = 100.0 * feats @ clip_weights                  # [N, C]
    return clip_logits + alpha * cache_logits


def _macro_f1_f32(cm: torch.Tensor) -> torch.Tensor:
    """Macro F1 of [..., C, C] f32 confusion matrices, in f32 as the JAX
    package's jit-friendly inline form (`_grid_f1`)."""
    tp = torch.diagonal(cm, dim1=-2, dim2=-1)
    fp = cm.sum(-2) - tp
    fn = cm.sum(-1) - tp
    one = torch.ones_like(tp)
    zero = torch.zeros_like(tp)
    p = torch.where(tp + fp > 0, tp / torch.where(tp + fp > 0, tp + fp, one),
                    zero)
    r = torch.where(tp + fn > 0, tp / torch.where(tp + fn > 0, tp + fn, one),
                    zero)
    f1 = torch.where(p + r > 0, 2 * p * r / torch.where(p + r > 0, p + r, one),
                     zero)
    return f1.mean(-1)


def grid_chunk(n: int, nk: int, c: int, n_alpha: int) -> int:
    """Betas per chunk of the F1 grid: the chunk's exp(-beta (1 -
    affinity)) [b, N, NK], cache logits [b, N, C], tip logits [b, A, N, C]
    and predictions [b, A, N] (int64) stay within GRID_BYTES."""
    per_beta = 4 * n * (nk + c + n_alpha * c) + 8 * n_alpha * n
    return max(1, GRID_BYTES // per_beta)


@torch.no_grad()
def _grid_f1(feats, keys, values, clip_weights, labels, betas, alphas,
             num_classes: int) -> torch.Tensor:
    """F1 over the (beta, alpha) grid -> [B, A] f32, in chunks of betas."""
    c = num_classes
    affinity = feats @ keys.T                                   # [N, NK]
    clip_logits = 100.0 * feats @ clip_weights                  # [N, C]
    n, nk = affinity.shape
    a = alphas.shape[0]
    labels = labels.long()
    out = []
    step = grid_chunk(n, nk, c, a)
    for b0 in range(0, betas.shape[0], step):
        b = betas[b0:b0 + step]
        cache = torch.exp(-b[:, None, None] * (1.0 - affinity)[None]) @ values
        logits = clip_logits + alphas[None, :, None, None] * cache[:, None]
        preds = logits.argmax(-1)                               # [b, A, N]
        cells = b.shape[0] * a
        flat = (torch.arange(cells, device=preds.device)[:, None] * (c * c)
                + labels[None] * c + preds.reshape(cells, n))
        cm = torch.bincount(flat.reshape(-1), minlength=cells * c * c)
        out.append(_macro_f1_f32(cm.reshape(b.shape[0], a, c, c).float()))
    return torch.cat(out)


@dataclass
class HPResult:
    beta: float
    alpha: float
    f1: float
    grid: np.ndarray   # [B, A] F1 surface


def search_hp(
    feats, keys, values, clip_weights, labels,
    num_classes: int,
    search_scale: Tuple[float, float] = (7.0, 3.0),
    search_step: Tuple[int, int] = (200, 20),
    mesh=None,
) -> HPResult:
    """Grid semantics of utils.py:159-206: beta_i = (i+1)*scale0/steps0.
    The grid's betas and alphas are f32 from the JAX package's Python
    expressions, and its arg-max is the first maximum in row-major order,
    so the chosen (beta, alpha) is the JAX package's where the best is
    separated. Runs on the features' device; with `mesh`, the beta axis
    of the grid is split over the mesh's data axis (a count that does not
    divide is padded with the last beta), each device evaluates its betas
    on its own copy of the features and cache, and the F1 rows are
    gathered on the host."""
    feats = _tensor(feats, dtype=torch.float32)
    n_beta = search_step[0]
    betas = torch.tensor(
        [(i + 1) * search_scale[0] / search_step[0]
         for i in range(n_beta)], dtype=torch.float32)
    alphas = torch.tensor(
        [(i + 1) * search_scale[1] / search_step[1]
         for i in range(search_step[1])], dtype=torch.float32)

    def grid_on(dev, b):
        return _grid_f1(feats.to(dev), _tensor(keys, dev, torch.float32),
                        _tensor(values, dev, torch.float32),
                        _tensor(clip_weights, dev, torch.float32),
                        _tensor(labels, dev), b.to(dev), alphas.to(dev),
                        num_classes)

    if mesh is None:
        grid = grid_on(feats.device, betas).cpu().numpy()
    else:
        from mmrs_tpu_torch.parallel.mesh import data_devices, local_positions
        from mmrs_tpu_torch.parallel.multihost import all_gather_processes

        shards = mesh.shape["data"]
        pad = (-n_beta) % shards
        betas = torch.cat([betas, betas[-1:].expand(pad)])
        per = betas.shape[0] // shards
        devs = data_devices(mesh)
        rows = torch.stack([grid_on(devs[p], betas[p * per:(p + 1) * per])
                            .cpu() for p in local_positions(mesh)])
        grid = all_gather_processes(rows).reshape(-1, alphas.shape[0])
        grid = grid.numpy()[:n_beta]
    bi, ai = np.unravel_index(np.argmax(grid), grid.shape)
    return HPResult(beta=float(betas[bi]), alpha=float(alphas[ai]),
                    f1=float(grid[bi, ai]), grid=grid)


@dataclass
class TipAdapterFResult:
    adapter_keys: np.ndarray     # trained keys [NK, D]
    best_f1: float
    best_epoch: int
    history: list                # per-epoch eval F1
    hp: Optional[HPResult] = None


def cosine_decay(count: int, decay_steps: int) -> float:
    """optax.cosine_decay_schedule's factor at `count` (alpha 0), in f32
    as optax computes it: 0.5 * (1 + cos(pi * min(count, steps) / steps))."""
    c = np.float32(min(count, decay_steps))
    return float(np.float32(0.5) * (np.float32(1) + np.cos(
        np.float32(np.pi) * c / np.float32(decay_steps))))


def train_tip_adapter_f(
    train_feats,                  # [N, D] or [E, N, D] L2-normalized
    train_labels,                 # [N]
    test_feats,
    test_labels,
    keys,                         # cache keys init [NK, D]
    values,                       # [NK, C]
    clip_weights,                 # [D, C]
    num_classes: int,
    lr: float = 1e-3,
    epochs: int = 20,
    batch_size: int = 256,
    alpha: float = 1.0,
    beta: float = 1.0,
    run_search_hp: bool = True,
    search_scale: Tuple[float, float] = (7.0, 3.0),
    search_step: Tuple[int, int] = (200, 20),
    seed: int = 0,
    device=None,
) -> TipAdapterFResult:
    """Tip-Adapter-F: train the adapter (the keys matrix as a linear layer)
    with AdamW + cosine-annealed LR; track the best test F1
    (main_custom.py saves/reloads the best adapter at :212-214).

    `train_feats` may be [N, D] (fixed features) or [E, N, D]: one
    augmented view set per pass, cycled across epochs, as the reference
    re-encodes the augmented train loader every epoch
    (main_custom.py:166-189). Runs on `device` (default:
    pipeline.default_device())."""
    from mmrs_tpu_torch.pipeline import default_device

    dev = torch.device(device) if device is not None else default_device()
    train = _tensor(train_feats, dev, torch.float32)
    per_epoch = train if train.dim() == 3 else train[None]
    n = per_epoch.shape[1]
    train_y = _tensor(train_labels, dev).long()
    test = _tensor(test_feats, dev, torch.float32)
    vals = _tensor(values, dev, torch.float32)
    cw = _tensor(clip_weights, dev, torch.float32)
    steps_per_epoch = max(1, (n + batch_size - 1) // batch_size)
    total = epochs * steps_per_epoch

    adapter = torch.nn.Parameter(_tensor(keys, dev, torch.float32).clone())
    opt = torch.optim.AdamW([adapter], lr=lr, weight_decay=0.01)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: cosine_decay(count, total))

    rng = np.random.default_rng(seed)
    best_f1, best_epoch = -1.0, -1
    best_keys = adapter.detach().cpu().numpy().copy()
    history = []
    for epoch in range(epochs):
        feats_e = per_epoch[epoch % per_epoch.shape[0]]
        order = rng.permutation(n)
        for s in range(steps_per_epoch):
            idx = torch.from_numpy(
                order[s * batch_size:(s + 1) * batch_size]).to(dev)
            logits = tip_logits(feats_e[idx], adapter, vals, cw, alpha, beta)
            loss = F.cross_entropy(logits, train_y[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            sched.step()
        with torch.no_grad():
            preds = tip_logits(test, adapter, vals, cw, alpha,
                               beta).argmax(-1)
        f1 = macro_f1(preds, test_labels, num_classes)
        history.append(f1)
        if f1 > best_f1:
            best_f1, best_epoch = f1, epoch
            best_keys = adapter.detach().cpu().numpy().copy()

    hp = None
    if run_search_hp:
        hp = search_hp(test, best_keys, vals, cw, test_labels, num_classes,
                       search_scale, search_step)
    return TipAdapterFResult(adapter_keys=best_keys, best_f1=best_f1,
                             best_epoch=best_epoch, history=history, hp=hp)


def clip_classifier(text_embeds_per_class) -> torch.Tensor:
    """Prompt-ensemble classifier weights (utils.py `clip_classifier`:79-96):
    mean over templates, L2-normalized, transposed to [D, C].
    text_embeds_per_class: [C, P, D], P prompt-template embeddings."""
    x = _tensor(text_embeds_per_class, dtype=torch.float32)
    return l2_normalize(l2_normalize(x).mean(dim=1)).T
