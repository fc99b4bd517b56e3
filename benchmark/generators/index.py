"""Index build traffic: decoded images streamed through `build_index`.

The window calls `index.gallery.build_index(stream, towers.image_encode,
out_dir)` as `mmrs-torch index` does, over an in-memory stream of decoded
uint8 images (a pool of distinct images drawn from the seed, batch after
batch) that stops at the window's end; shards go under TMPDIR and are
deleted at exit. The rate counts every indexed row over the whole call,
shard writes and the index's final load included.

Traffic parameters: batch (images a call), pool_images (distinct images),
shard_rows (rows a shard file), sample_rows (rows held against the
reference), reference_block (images a reference call), idle_label.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from benchmark import data, system, weights
from benchmark.reference import no_tf32, vit
from mmrs_tpu_torch.index.gallery import build_index


def setup(run) -> None:
    cfg, tr = run.cfg, run.traffic
    run.mark("imports")
    run.weights = weights.make(cfg, run.seed, run.device)
    run.towers = system.towers(cfg, run.weights, None, run.device,
                               dtype="int8" if run.control else "")
    run.mark("towers")
    size = cfg["image_tower"]["image_size"]
    run.pool = data.image_pool(tr["pool_images"], size, run.seed, run.device)
    run.mark("images")
    batch = tr["batch"]
    for a in (0, batch):        # the window's one shape, twice
        run.towers.image_encode(run.pool[a:a + batch])
    run.mark("warm-up")


def window(run) -> None:
    tr = run.traffic
    ids = data.stream_ids(len(run.pool), tr["batch"], run.seed)
    run.stream = data.ImageStream(data.Samples(ids), run.pool, tick=run.tick)
    run.out_dir = tempfile.mkdtemp(prefix="bench-index-")
    run.cleanup.append(run.out_dir)
    encode = run.spans.wrap("encode_fn", run.towers.image_encode)
    start = run.start_window()
    run.stream.deadline = start + run.seconds
    index = build_index(run.stream, encode, run.out_dir,
                        batch_size=tr["batch"], shard_rows=tr["shard_rows"])
    run.elapsed = time.perf_counter() - start
    run.index = index
    run.items = len(index)
    run.attempted = run.stream.yielded[0]


def release(run) -> None:
    run.towers = run.weights = None
    system.free_device()


def check(run):
    """Over the sampled rows, against the reference tower's embeddings:
    rows lost (missing, or under another path); rows misplaced (nearer the
    embedding of another image, among the sampled rows' and their
    neighbours' in the stream, than their own: a row that says the wrong
    thing); and the 90th percentile of the rows' L2 gaps from their own
    image's embedding (the precision of the path: the widest gap swings
    with the few rows that rounding flips, and gross errors are the
    count's)."""
    tr, index = run.traffic, run.index
    n = len(index)
    want = data.Samples(data.stream_ids(len(run.pool), tr["batch"],
                                        run.seed))
    wrong = sum(index.paths[r] != want[r][0] for r in range(n))
    run.failed = run.attempted - n
    r = data.rng(run.seed)
    take = min(tr["sample_rows"], n)
    rows = np.unique(np.concatenate([r.choice(n, take, replace=False),
                                     [0, n - 1]])) if n else np.zeros(0, int)
    def pool_id(i):
        return int(index.paths[i].split("/")[1])

    pool_ids = np.array([pool_id(i) for i in rows])
    near = {pool_id(j) for i in rows for j in (i - 1, i + 1) if 0 <= j < n}
    got = torch.from_numpy(np.asarray(index.embeddings[rows],
                                      np.float32)).to(run.device)
    no_tf32()
    w = weights.make(run.cfg, run.seed, run.device)
    spec = run.cfg["image_tower"]
    images = np.unique(np.concatenate([pool_ids, sorted(near)]))
    where = np.searchsorted(images, pool_ids)
    block = tr["reference_block"]
    ref = torch.cat([vit.encode(w, spec, torch.from_numpy(
        run.pool[images[a:a + block]]).to(run.device))
        for a in range(0, len(images), block)])
    own = torch.from_numpy(where).to(run.device)
    gaps = (got - ref[own]).norm(dim=1)
    misplaced = int((torch.cdist(got, ref).argmin(dim=1) != own).sum())
    p90 = float(torch.quantile(gaps, 0.9)) if len(rows) else 0.0
    return [("rows_lost", float(run.failed + wrong)),
            ("rows_misplaced", float(misplaced)), ("row_gap_p90", p90)]
