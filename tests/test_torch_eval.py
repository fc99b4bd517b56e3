"""The port's metrics, calibration sweeps and evaluation harnesses
(search/metrics.py, search/calibrate.py, eval/zeroshot.py, eval/sweep.py)
against mmrs_tpu's on seeded inputs: equal results, equal files."""

import dataclasses

import numpy as np
import pytest
import torch

from mmrs_tpu.eval import sweep as j_sweep
from mmrs_tpu.eval import zeroshot as j_zeroshot
from mmrs_tpu.search import calibrate as j_calibrate
from mmrs_tpu.search import metrics as j_metrics
from mmrs_tpu_torch.eval import sweep, zeroshot
from mmrs_tpu_torch.search import calibrate, metrics

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _logits(seed, n=200, c=7, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    if ties:   # rounded to a coarse grid: many equal scores in a row
        logits = np.round(logits * 2) / 2
    labels = rng.integers(0, c, n)
    return logits, labels


def _table(report):
    """A {name: PRF1} report as plain tuples (the two packages' PRF1
    classes are distinct types)."""
    return {k: dataclasses.astuple(v) for k, v in report.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("topk", [1, 3, 10])
@pytest.mark.parametrize("exclude", [None, 2])
def test_topk_accuracy_equals_jax(seed, ties, topk, exclude):
    logits, labels = _logits(seed, ties=ties)
    want = j_metrics.topk_accuracy(logits, labels, topk, exclude)
    for x, y in ((logits, labels),
                 (torch.from_numpy(logits), torch.from_numpy(labels))):
        assert metrics.topk_accuracy(x, y, topk, exclude) == want


def test_topk_accuracy_with_every_sample_excluded():
    logits, _ = _logits(2, n=10)
    labels = np.full(10, 3)
    assert metrics.topk_accuracy(logits, labels, 1, 3) == \
        j_metrics.topk_accuracy(logits, labels, 1, 3) == 0.0


@pytest.mark.parametrize("c", [2, 5, 9])
def test_confusion_matrix_and_macro_f1_equal_jax(c):
    rng = np.random.default_rng(c)
    preds, labels = rng.integers(0, c, 300), rng.integers(0, c, 300)
    want = np.asarray(j_metrics.confusion_matrix(preds, labels, c))
    got = metrics.confusion_matrix(torch.from_numpy(preds),
                                   torch.from_numpy(labels), c)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for exclude in (None, 0, c - 1):
        assert metrics.macro_f1(preds, labels, c, exclude) == \
            j_metrics.macro_f1(preds, labels, c, exclude)
    names = [f"class{i}" for i in range(c)]
    assert _table(metrics.per_class_report(torch.from_numpy(preds), labels,
                                           names)) == \
        _table(j_metrics.per_class_report(preds, labels, names))


def _sims(seed, n_pos=120, n_neg=400):
    rng = np.random.default_rng(seed)
    pos = np.clip(rng.normal(0.31, 0.03, n_pos), 0, 1).astype(np.float32)
    neg = np.clip(rng.normal(0.24, 0.03, n_neg), 0, 1).astype(np.float32)
    return pos, neg


def _same_sweep(got, want):
    for field in ("thresholds", "precision", "recall", "f1"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("best_threshold", "best_f1", "best_precision",
                  "best_recall"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_thresholds_equals_jax(seed):
    pos, neg = _sims(seed)
    _same_sweep(calibrate.evaluate_thresholds(pos, neg),
                j_calibrate.evaluate_thresholds(pos, neg))
    _same_sweep(calibrate.evaluate_thresholds(pos, neg, 0.5, 0.01),
                j_calibrate.evaluate_thresholds(pos, neg, 0.5, 0.01))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_thresholds_overlap_equals_jax(seed):
    pos, neg = _sims(seed)
    pos, neg = 100 * pos, 100 * neg      # logit-scaled, as main_custom.py
    _same_sweep(calibrate.find_thresholds_overlap(pos, neg),
                j_calibrate.find_thresholds_overlap(pos, neg))
    _same_sweep(calibrate.find_thresholds(pos, neg),
                j_calibrate.find_thresholds(pos, neg))


def test_plot_f1_curve_writes_the_image(tmp_path):
    pytest.importorskip("matplotlib")
    res = calibrate.evaluate_thresholds(*_sims(3))
    out = calibrate.plot_f1_curve(res, "dog", str(tmp_path / "dog.jpg"))
    assert out == str(tmp_path / "dog.jpg") and (tmp_path / "dog.jpg").stat(
    ).st_size > 1000


def _feats(seed, n, d=32):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_multiclass_zeroshot_equals_jax(tmp_path, as_tensor):
    img, txt = _feats(0, 150), _feats(1, 6)
    labels = np.random.default_rng(2).integers(0, 6, 150)
    names = ["dog", "cat", "horse", "donkey", "wolf", "others"]
    want = j_zeroshot.multiclass_zeroshot(img, txt, labels, names)
    args = ((torch.from_numpy(img), torch.from_numpy(txt)) if as_tensor
            else (img, txt))
    got = zeroshot.multiclass_zeroshot(*args, labels, names)
    assert got.accuracy == want.accuracy and got.macro_f1 == want.macro_f1
    assert _table(got.per_class) == _table(want.per_class)
    assert np.array_equal(got.preds, want.preds)
    assert np.array_equal(got.probs, want.probs)
    zeroshot.write_multiclass_csv(got, str(tmp_path / "t.csv"))
    j_zeroshot.write_multiclass_csv(want, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_binary_zeroshot_equals_jax():
    targets = ("dog", "cat", "lynx")
    imgs = {t: _feats(i, 40) for i, t in enumerate(targets)}
    pos = {t: _feats(10 + i, 1)[0] for i, t in enumerate(targets)}
    neg = {t: _feats(20 + i, 1)[0] for i, t in enumerate(targets)}
    labels = {t: np.random.default_rng(30 + i).integers(0, 2, 40).astype(bool)
              for i, t in enumerate(targets)}
    want = j_zeroshot.binary_zeroshot(imgs, pos, neg, labels)
    got = zeroshot.binary_zeroshot(
        {t: torch.from_numpy(v) for t, v in imgs.items()}, pos, neg, labels)
    assert _table(got.per_target) == _table(want.per_target)
    assert got.mean_f1 == want.mean_f1


@pytest.mark.parametrize("pairs", ["default", "chinese"])
def test_pair_threshold_sweep_equals_jax(tmp_path, pairs):
    pair_list = (sweep.DEFAULT_PAIRS if pairs == "default"
                 else sweep.CHINESE_PAIRS)
    assert pair_list == (j_sweep.DEFAULT_PAIRS if pairs == "default"
                         else j_sweep.CHINESE_PAIRS)
    pos_sims, neg_sims = {}, {}
    for i, (p, _) in enumerate(pair_list[:4]):    # the last pair is absent
        pos_sims[p], neg_sims[p] = _sims(40 + i, 60, 80)
    got = sweep.pair_threshold_sweep(pos_sims, neg_sims, pair_list)
    want = j_sweep.pair_threshold_sweep(pos_sims, neg_sims, pair_list)
    assert list(got) == list(want) and len(got) == 4
    for k in got:
        assert (got[k].positive, got[k].negative) == (want[k].positive,
                                                       want[k].negative)
        _same_sweep(got[k].result, want[k].result)
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    sweep.write_sweep_csv(got, str(t_dir))
    j_sweep.write_sweep_csv(want, str(j_dir))
    names = sorted(p.name for p in j_dir.iterdir())
    assert sorted(p.name for p in t_dir.iterdir()) == names
    for name in names:
        assert (t_dir / name).read_text(encoding="utf-8") == (
            j_dir / name).read_text(encoding="utf-8")
