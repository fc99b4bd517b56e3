"""The index path's spans: `build_index` / `update_index` under a capture
on the CPU record `gallery.build` around the batches' `towers.upload`,
`towers.encode` and `towers.fetch`, one `gallery.flush` a shard and the
final `gallery.load`, with counts that match the rows and shards
written."""

import dataclasses
from collections import Counter
from typing import List, Tuple

import numpy as np
import pytest
import torch

from mmrs_tpu_torch import config as t_config
from mmrs_tpu_torch import pipeline
from mmrs_tpu_torch.index import gallery
from mmrs_tpu_torch.io.dataset import Batch
from mmrs_tpu_torch.utils import profiling

torch.set_num_threads(2)

SIZE = 224          # the vit_tiny preset's image size
TOWER_SPANS = ("towers.upload", "towers.encode", "towers.fetch")


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def towers():
    cfg = t_config.Config(model=t_config.ModelConfig(
        image_tower="vit_tiny", dtype="float32"))
    return pipeline.build_towers(cfg, device="cpu")


@dataclasses.dataclass
class Images:
    """An in-memory dataset: `samples` and `batches()` as FolderDataset."""
    samples: List[Tuple[str, str]]
    pixels: np.ndarray

    def batches(self, batch_size: int):
        for a in range(0, len(self.samples), batch_size):
            chunk = self.samples[a:a + batch_size]
            ids = [int(p.split("_")[1]) for p, _ in chunk]
            yield Batch(pixels=self.pixels[ids], labels=[c for _, c in chunk],
                        paths=[p for p, _ in chunk],
                        ok=np.ones(len(chunk), bool))


def _images(n: int, seed: int = 0) -> Images:
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    return Images([(f"img_{i}", f"c{i % 3}") for i in range(n)], px)


def _captured(fn):
    profiling.spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    got, dropped = profiling.spans()
    assert dropped == 0
    return out, got


def _check_tree(got, rows: int, shard_rows: List[int], loaded: int,
                consolidated: int, batch: int, dim: int):
    by = {s.sid: s for s in got}
    builds = [s for s in got if s.name == "gallery.build"]
    assert len(builds) == 1
    build = builds[0]
    assert build.parent == 0 and build.items == rows
    children = [s for s in got if s is not build]
    assert all(s.parent == build.sid for s in children)
    assert all(build.start_ns <= s.start_ns <= s.end_ns <= build.end_ns
               for s in children)
    assert len({s.thread for s in got}) == 1
    names = Counter(s.name for s in children)
    batches = -(-rows // batch)
    assert names == Counter({**{n: batches for n in TOWER_SPANS},
                             "gallery.flush": len(shard_rows),
                             "gallery.load": 1})
    for name in TOWER_SPANS:
        spans = [s for s in children if s.name == name]
        assert sum(s.items for s in spans) == rows
    uploads = [s for s in children if s.name == "towers.upload"]
    assert sum(s.nbytes for s in uploads) == rows * SIZE * SIZE * 3
    fetches = [s for s in children if s.name == "towers.fetch"]
    assert sum(s.nbytes for s in fetches) == rows * dim * 4
    # each batch: upload, then encode, then fetch, in order
    tower = sorted((s for s in children if s.name in TOWER_SPANS),
                   key=lambda s: s.start_ns)
    assert [s.name for s in tower] == list(TOWER_SPANS) * batches
    assert all(a.end_ns <= b.start_ns for a, b in zip(tower, tower[1:]))
    flushes = [s for s in children if s.name == "gallery.flush"]
    assert [s.items for s in flushes] == shard_rows
    assert [s.nbytes for s in flushes] == [r * dim * 4 for r in shard_rows]
    (load,) = [s for s in children if s.name == "gallery.load"]
    assert (load.items, load.nbytes) == (loaded, consolidated)
    assert load.start_ns >= max(s.end_ns for s in flushes)
    assert all(by[s.parent] is build for s in children)


def test_build_index_spans(towers, tmp_path):
    data = _images(40)
    index, got = _captured(lambda: gallery.build_index(
        data, towers.image_encode, str(tmp_path), batch_size=8,
        shard_rows=16))
    assert len(index) == 40
    dim = index.dim
    # shards of 16, 16 and 8 rows; three shards consolidate into one file
    _check_tree(got, 40, [16, 16, 8], 40, 40 * dim * 4, batch=8, dim=dim)


def test_update_index_spans(towers, tmp_path):
    data = _images(24, seed=1)
    first = dataclasses.replace(data, samples=data.samples[:16])
    gallery.build_index(first, towers.image_encode, str(tmp_path),
                        batch_size=8, shard_rows=64)
    index, got = _captured(lambda: gallery.update_index(
        data, towers.image_encode, str(tmp_path), batch_size=8,
        shard_rows=64))
    assert len(index) == 24
    _check_tree(got, 8, [8], 24, 24 * index.dim * 4, batch=8,
                dim=index.dim)


def test_a_single_shard_load_consolidates_nothing(towers, tmp_path):
    data = _images(12, seed=2)
    index, got = _captured(lambda: gallery.build_index(
        data, towers.image_encode, str(tmp_path), batch_size=8,
        shard_rows=64))
    _check_tree(got, 12, [12], 12, 0, batch=8, dim=index.dim)


def test_no_capture_no_spans(towers, tmp_path):
    profiling.spans()
    gallery.build_index(_images(8, seed=3), towers.image_encode,
                        str(tmp_path), batch_size=8)
    assert profiling.spans() == ([], 0)
