"""The composed search slice on both packages, as tests/test_composed_parity
does for mmrs_tpu against the reference.

Synthetic JPEGs go through load_image -> build_towers -> build_index ->
SearchEngine -> sweep_class in mmrs_tpu and in mmrs_tpu_torch, with the
same weights (one `clip.init` tree saved with mmrs_tpu's save_npz). Pixels
are byte-identical, top-10 ids identical, calibrated thresholds within
1e-3. Galleries written by either package load in the other, and the
tokenizer copies agree.
"""

import io as _io

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from mmrs_tpu import config as j_config
from mmrs_tpu import pipeline as j_pipeline
from mmrs_tpu.index import gallery as j_gallery
from mmrs_tpu.io import dataset as j_dataset
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models import tokenizer as j_tokenizer
from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
from mmrs_tpu.search import engine as j_engine
from mmrs_tpu.search import prototypes as j_prototypes
from mmrs_tpu_torch import config as t_config
from mmrs_tpu_torch import pipeline as t_pipeline
from mmrs_tpu_torch.index import gallery as t_gallery
from mmrs_tpu_torch.io import dataset as t_dataset
from mmrs_tpu_torch.models import tokenizer as t_tokenizer
from mmrs_tpu_torch.search import engine as t_engine
from mmrs_tpu_torch.search import prototypes as t_prototypes

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _jpeg(rng, cls: str) -> bytes:
    h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    if cls == "stripes":
        phase, freq = rng.uniform(0, np.pi), rng.uniform(0.2, 0.6)
        img[..., 0] = 0.5 + 0.5 * np.sin(freq * xx + phase)
        img[..., 1] = 0.5 + 0.5 * np.sin(freq * xx + phase + 1.0)
        img[..., 2] = rng.uniform(0.1, 0.4)
    else:
        for _ in range(4):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), \
                rng.uniform(5, 15)
            img[..., int(rng.integers(0, 3))] += np.exp(
                -(((yy - cy) ** 2 + (xx - cx) ** 2) / r ** 2))
    buf = _io.BytesIO()
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=92)
    return buf.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A class-per-folder JPEG tree, 4 query shots, and one f32 weight
    checkpoint at the vit_tiny preset shared by both packages."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(7)
    for cls in ("stripes", "blobs"):
        (root / cls).mkdir()
    for i in range(24):
        cls = "stripes" if i % 2 == 0 else "blobs"
        (root / cls / f"img_{i:02d}.jpg").write_bytes(_jpeg(rng, cls))
    shots = root.parent / "shots"
    shots.mkdir(exist_ok=True)
    for i in range(4):
        (shots / f"s{i}.jpg").write_bytes(_jpeg(rng, "stripes"))
    ckpt = str(root.parent / "tiny.npz")
    params = j_clip.init(jax.random.key(3), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY))
    j_checkpoint.save_npz(params, ckpt)
    return str(root), sorted(str(p) for p in shots.iterdir()), ckpt


def _model_cfg(mod, ckpt):
    return mod.Config(model=mod.ModelConfig(
        image_tower="vit_tiny", dtype="float32", checkpoint_path=ckpt))


def test_composed_slice_matches_jax(world, tmp_path):
    root, shot_paths, ckpt = world
    j_towers = j_pipeline.build_towers(_model_cfg(j_config, ckpt))
    t_towers = t_pipeline.build_towers(_model_cfg(t_config, ckpt),
                                       device="cpu")

    j_ds = j_dataset.FolderDataset.from_root(root, num_workers=2)
    t_ds = t_dataset.FolderDataset.from_root(root, num_workers=2)
    j_batch, t_batch = next(j_ds.batches(64)), next(t_ds.batches(64))
    np.testing.assert_array_equal(t_batch.pixels, j_batch.pixels)
    assert t_batch.paths == j_batch.paths and t_batch.ok.all()

    j_idx = j_gallery.build_index(j_ds, j_towers.image_encode,
                                  str(tmp_path / "j"), batch_size=8)
    t_idx = t_gallery.build_index(t_ds, t_towers.image_encode,
                                  str(tmp_path / "t"), batch_size=8)
    assert t_idx.paths == j_idx.paths and t_idx.classes == j_idx.classes
    np.testing.assert_allclose(t_idx.embeddings, j_idx.embeddings, atol=1e-4)

    from mmrs_tpu.io.images import load_image as j_load
    from mmrs_tpu_torch.io.images import load_image as t_load

    j_px = np.stack([j_load(p).pixels for p in shot_paths])
    t_px = np.stack([t_load(p).pixels for p in shot_paths])
    np.testing.assert_array_equal(t_px, j_px)
    j_shots, t_shots = j_towers.image_encode(j_px), t_towers.image_encode(t_px)

    j_eng = j_engine.SearchEngine(j_idx)
    t_eng = t_engine.SearchEngine(t_idx, device="cpu")
    j_hits = j_eng.query_prototype(j_shots, top_k=10)[0]
    t_hits = t_eng.query_prototype(t_shots, top_k=10)[0]
    assert [h.path for h in t_hits] == [h.path for h in j_hits]
    np.testing.assert_allclose([h.score for h in t_hits],
                               [h.score for h in j_hits], atol=2e-2)

    labels = np.asarray([c == "stripes" for c in j_idx.classes])
    j_res = j_eng.sweep_class(j_prototypes.mean_prototype(j_shots), labels)
    t_res = t_eng.sweep_class(t_prototypes.mean_prototype(t_shots), labels)
    assert abs(t_res.best_threshold - j_res.best_threshold) <= 1e-3
    assert abs(t_res.best_f1 - j_res.best_f1) <= 1e-9


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_gallery_written_by_either_package_loads_in_the_other(tmp_path,
                                                              writer):
    rng = np.random.default_rng(11)
    rows = rng.standard_normal((10, 16)).astype(np.float32)
    samples = [(f"/data/c{i % 3}/{i}.jpg", f"c{i % 3}") for i in range(10)]
    # two shards, so the reader consolidates them
    (tmp_path / "idx").mkdir()
    out = str(tmp_path / "idx")
    mod = j_gallery if writer == "jax" else t_gallery
    shards = [mod._write_shard(out, 0, rows[:6], samples[:6]),
              mod._write_shard(out, 1, rows[6:], samples[6:])]
    mod._write_manifest(out, shards, 16)
    j_idx, t_idx = (j_gallery.GalleryIndex.load(out),
                    t_gallery.GalleryIndex.load(out))
    np.testing.assert_array_equal(t_idx.embeddings, j_idx.embeddings)
    np.testing.assert_array_equal(t_idx.embeddings, rows)
    assert t_idx.paths == j_idx.paths == [p for p, _ in samples]
    assert t_idx.classes == j_idx.classes == [c for _, c in samples]


def test_clip_tokenizer_ids_match_jax_copy():
    words = ["a", "photo", "of", "lychee", "fruit"]
    texts = ["a photo of a lychee", "Lychee  fruit!", "unseen wørds 42",
             "&amp; html"]
    want = j_tokenizer.CLIPTokenizer.synthetic(words)(texts)
    got = t_tokenizer.CLIPTokenizer.synthetic(words)(texts)
    np.testing.assert_array_equal(got, want)
    tok = t_tokenizer.CLIPTokenizer.synthetic(words)
    assert tok.decode(got[0]) == j_tokenizer.CLIPTokenizer.synthetic(
        words).decode(want[0])
