"""Index build traffic through any image tower the benchmark knows by kind.

The window and the release are `index`'s (generators/index.py): decoded
uint8 images streamed through `build_index(stream, towers.image_encode,
out_dir)` as `mmrs-torch index` does. What differs is found by the image
tower's kind: the pair is built by `builders/<kind>.py` (`build`) and
the sampled rows are held against `reference/<kind>.py` (`encode`) by
`index.check`, so a tower joins with those two files, a configuration
and entries.

The readers of index builds (`metrics/*.index.py`, `index_img_per_s`)
know a run by its generator's name, `index`; a run of this mix is an
index build in every number they read (the rows indexed, the build's
seconds, the spans and the idle gaps), and set-up names it so
(`run.traffic["generator"]`). Only the readers that count work from the
tower's shapes (`metrics/*.index_kind.py`) are this mix's own, and know
it by `run.index_kind`.

Traffic parameters: index's.
"""

from __future__ import annotations

import importlib
from unittest import mock

from benchmark import data, weights
from benchmark.generators import index
from benchmark.generators.index import release, window  # noqa: F401


def kind_module(run, folder: str):
    """benchmark.<folder>.<the image tower's kind>."""
    kind = run.cfg["image_tower"]["kind"]
    return importlib.import_module(f"benchmark.{folder}.{kind}")


def setup(run) -> None:
    cfg, tr = run.cfg, run.traffic
    run.ref = kind_module(run, "reference")
    builder = kind_module(run, "builders")
    run.traffic = dict(tr, generator="index")
    run.index_kind = True
    run.mark("imports")
    run.weights = weights.make(cfg, run.seed, run.device)
    run.towers = builder.build(cfg, run.weights, run.device,
                               dtype="int8" if run.control else "")
    run.mark("towers")
    size = cfg["image_tower"]["image_size"]
    run.pool = data.image_pool(tr["pool_images"], size, run.seed, run.device)
    run.mark("images")
    batch = tr["batch"]
    for a in (0, batch):        # the window's one shape, twice
        run.towers.image_encode(run.pool[a:a + batch])
    run.mark("warm-up")


def check(run):
    """`index.check`, against the kind's reference tower."""
    with mock.patch.object(index, "vit", run.ref):
        return index.check(run)
