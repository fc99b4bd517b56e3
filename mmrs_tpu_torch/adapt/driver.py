"""End-to-end few-shot Tip-Adapter(-F) from an image folder.

Counterpart of mmrs_tpu/adapt/driver.py, over the port's `Towers`: the
glue the reference runs as `python code/main_custom.py --config cfg.yaml`
(code/main_custom.py:250-299), in the JAX package's order: k-shot sample
the train folder, build the augmented cache model through the image tower
(`image_encode_raw`: K3 and K2 on a GPU, K6 too for an int8 tower),
encode the test set, build the prompt classifier from the text tower,
compute zero-shot and training-free Tip F1, train Tip-Adapter-F, and
grid-search (beta, alpha). The adapter trains on the towers' device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.adapt import tip_adapter as tip
from mmrs_tpu_torch.io.dataset import FolderDataset, few_shot_sample
from mmrs_tpu_torch.ops.normalize import l2_normalize
from mmrs_tpu_torch.search.metrics import macro_f1
from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

DEFAULT_TEMPLATE = "a photo of {}"   # code/utils.py:84 single-template case


@dataclass
class FewShotRun:
    classes: List[str]
    keys: np.ndarray
    values: np.ndarray
    result: tip.TipAdapterFResult
    zero_shot_f1: float
    tip_f1: float                 # training-free Tip-Adapter at init
    # host-clock seconds of each stage: cache, test_encode, classifier,
    # tip_f (training), search_hp
    seconds: Dict[str, float] = field(default_factory=dict)


def encode_folder(towers, samples: Sequence[Tuple[str, str]],
                  class_to_idx, batch_size: int = 64,
                  image_size: int = 224):
    """Center-crop encode of (path, class) samples -> (normalized feats,
    int labels); corrupt images quarantined."""
    ds = FolderDataset(list(samples), image_size=image_size)
    feats, labels = [], []
    for b in ds.batches(batch_size):
        f = towers.image_encode(b.pixels)
        for row, cls, ok in zip(f, b.labels, b.ok):
            if ok:
                feats.append(row)
                labels.append(class_to_idx[cls])
    return (np.asarray(feats, np.float32), np.asarray(labels, np.int32))


def _towers_device(towers) -> torch.device:
    params = getattr(towers, "params", None)
    if isinstance(params, torch.nn.Module):
        return next(params.parameters()).device
    from mmrs_tpu_torch.pipeline import default_device

    return default_device()


def run_few_shot(
    towers,
    root: str,
    shots: int = 4,
    augment_epoch: int = 5,
    template: str = DEFAULT_TEMPLATE,
    lr: float = 1e-3,
    epochs: int = 20,
    alpha: float = 1.0,
    beta: float = 1.0,
    run_search_hp: bool = True,
    batch_size: int = 64,
    seed: int = 0,
    image_size: Optional[int] = None,
) -> FewShotRun:
    """main_custom.py's flow end-to-end from a class-per-folder tree:
    train = k random shots per class, test = every remaining image."""
    size = image_size or towers.clip_config.vision.image_size
    dev = _towers_device(towers)
    seconds: Dict[str, float] = {}
    ds = FolderDataset.from_root(root, image_size=size)
    classes = ds.classes
    class_to_idx = {c: i for i, c in enumerate(classes)}

    shot_samples = few_shot_sample(ds.samples, shots, seed=seed)
    shot_set = set(shot_samples)
    test_samples = [s for s in ds.samples if s not in shot_set]
    if not test_samples:      # tiny trees: evaluate on the shots themselves
        test_samples = shot_samples
    shot_paths = [p for p, _ in shot_samples]
    shot_labels = np.asarray([class_to_idx[c] for _, c in shot_samples],
                             np.int32)

    log.info("few-shot: %d classes, %d shots, %d test images",
             len(classes), len(shot_samples), len(test_samples))

    # cache model: augment_epoch tower passes (code/utils.py:99-132)
    t0 = time.perf_counter()
    keys, values, aug_norm = tip.build_cache_from_folder(
        towers.image_encode_raw, shot_paths, shot_labels, len(classes),
        augment_epoch=augment_epoch, image_size=size,
        batch_size=batch_size, seed=seed, device=dev)
    seconds["cache"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    test_feats, test_labels = encode_folder(
        towers, test_samples, class_to_idx, batch_size, size)
    seconds["test_encode"] = time.perf_counter() - t0
    test_t = torch.from_numpy(test_feats).to(dev)

    # prompt classifier (code/utils.py:79-96, single template)
    if towers.text_encode is None:
        raise ValueError("few-shot driver needs a text tower / tokenizer "
                         "for the prompt classifier")
    t0 = time.perf_counter()
    txt = towers.text_encode([template.format(c) for c in classes])
    clip_weights = l2_normalize(torch.from_numpy(
        np.asarray(txt, np.float32)).to(dev)).T                 # [D, C]
    cw = clip_weights.cpu().numpy()
    zs_preds = np.argmax(test_feats @ cw, axis=-1)
    zero_shot_f1 = macro_f1(zs_preds, test_labels, len(classes))
    with torch.no_grad():
        tf_logits = tip.tip_logits(test_t, keys, values, clip_weights,
                                   alpha, beta)
    tip_f1 = macro_f1(tf_logits.argmax(-1), test_labels, len(classes))
    seconds["classifier"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    result = tip.train_tip_adapter_f(
        aug_norm,                       # [E, NK, D]: per-epoch augmented
        shot_labels, test_t, test_labels,
        keys, values, clip_weights,
        num_classes=len(classes),
        lr=lr, epochs=epochs, batch_size=batch_size,
        alpha=alpha, beta=beta, run_search_hp=False, seed=seed, device=dev)
    seconds["tip_f"] = time.perf_counter() - t0
    if run_search_hp:   # train_tip_adapter_f's own search, timed apart
        t0 = time.perf_counter()
        result.hp = tip.search_hp(test_t, result.adapter_keys, values,
                                  clip_weights, test_labels, len(classes))
        seconds["search_hp"] = time.perf_counter() - t0

    return FewShotRun(classes=classes, keys=keys.cpu().numpy(),
                      values=values.cpu().numpy(), result=result,
                      zero_shot_f1=zero_shot_f1, tip_f1=tip_f1,
                      seconds=seconds)
