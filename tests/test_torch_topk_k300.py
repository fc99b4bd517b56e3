"""k past one 256-row chunk: the port's SearchEngine against mmrs_tpu's.

The JAX package's top-k has no bound on k; the port's scans keep each
chunk's best min(k, 256) and merge them down to k (ops/topk.py:scan_plan).
Here `query_vectors(top_k=300)` runs through both engines on the same
seeded gallery, flat (bf16, int8, int4) and IVF (every bucket probed, so
the answer is the exact top 300): the same 300 hits, scores within 1e-3
of the JAX engine's (logit scale 100), paths equal wherever the JAX scores
are more than that apart. The kernels' merge passes at these k run on the
card (tests/test_torch_cuda.py); the plan's passes are modelled on the CPU
in tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrs_tpu.config import SearchConfig as JConfig
from mmrs_tpu.index.gallery import GalleryIndex as JIndex
from mmrs_tpu.search.engine import SearchEngine as JEngine
from mmrs_tpu_torch.config import SearchConfig as TConfig
from mmrs_tpu_torch.index.gallery import GalleryIndex as TIndex
from mmrs_tpu_torch.search.engine import SearchEngine as TEngine

torch.set_num_threads(2)
TOP_K = 300


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def gallery():
    """700 clustered unit rows of width 64 (8 blobs) and 3 queries."""
    rng = np.random.default_rng(300)
    centers = rng.standard_normal((8, 64)).astype(np.float32)
    which = rng.integers(0, 8, 700)
    x = centers[which] + 0.6 * rng.standard_normal((700, 64)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[[3, 250, 611]] + 0.05 * rng.standard_normal((3, 64)).astype(
        np.float32)
    paths = [f"/data/{i}.jpg" for i in range(700)]
    return x, q, paths


@pytest.mark.parametrize("ann,quant", [("none", ""), ("none", "int8"),
                                       ("none", "int4"), ("ivf", ""),
                                       ("ivf", "int8"), ("ivf", "int4")])
def test_query_vectors_top_300_matches_jax(gallery, ann, quant):
    x, q, paths = gallery
    knobs = dict(ann=ann)
    if ann == "ivf":
        knobs.update(ann_clusters=8, ann_nprobe=8, ann_train_iters=2)
    je = JEngine(JIndex(x, paths, ["c"] * len(x)), JConfig(**knobs),
                 quantize=quant)
    te = TEngine(TIndex(x, paths, ["c"] * len(x)), TConfig(**knobs),
                 quantize=quant, device="cpu")
    assert (te.ivf is None) == (ann == "none")
    for th, jh in zip(te.query_vectors(q, top_k=TOP_K),
                      je.query_vectors(jnp.asarray(q), top_k=TOP_K)):
        assert len(th) == len(jh) == TOP_K
        assert [h.rank for h in th] == list(range(TOP_K))
        js = np.asarray([h.score for h in jh])
        np.testing.assert_allclose([h.score for h in th], js, atol=1e-3,
                                   rtol=0)
        gap = np.full(js.shape, np.inf)       # to the nearer neighbour
        d = np.abs(np.diff(js))
        gap[1:] = d
        gap[:-1] = np.minimum(gap[:-1], d)
        assert all(g <= 1e-3 or a.path == b.path
                   for a, b, g in zip(th, jh, gap))
        assert len({h.path for h in th}) == TOP_K
