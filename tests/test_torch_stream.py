"""The port's streaming top-k (index/stream.py) against mmrs_tpu's
`impl="xla"` form on the same memmapped rows: several chunks, a ragged
tail, n < k, and every prefetch depth (0: one chunk, no overlap; 1 and 2:
the upload ring). On the CPU the ring's slots are host buffers reused in
turn, so a slot refilled too early or a stale row in a ragged tail shows
as a wrong id. Ids equal; values within 1e-5 (f32 scan on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrs_tpu.index.stream import streaming_topk as j_streaming_topk
from mmrs_tpu_torch.index import stream
from mmrs_tpu_torch.index.stream import streaming_topk

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def memmap(tmp_path_factory):
    """3,000 x 48 f16 rows on disk; row 2,990 (in the ragged tail at chunk
    700) is planted as query 0."""
    emb = _rows(3000, 48)
    queries = _rows(5, 48, seed=1)
    emb[2990] = queries[0]
    path = tmp_path_factory.mktemp("stream") / "idx.npy"
    np.save(path, emb.astype(np.float16))
    return np.load(path, mmap_mode="r"), queries


@pytest.mark.parametrize("prefetch", [0, 1, 2])
@pytest.mark.parametrize("chunk_rows,k", [(700, 10), (1024, 7), (3000, 10),
                                          (97, 300)])
def test_streaming_equals_jax(memmap, prefetch, chunk_rows, k):
    mm, queries = memmap
    jv, ji = j_streaming_topk(mm, queries, k=k, chunk_rows=chunk_rows,
                              device_dtype=jnp.float32, impl="xla",
                              prefetch=prefetch)
    tv, ti = streaming_topk(mm, queries, k=k, chunk_rows=chunk_rows,
                            dtype=torch.float32, prefetch=prefetch)
    assert ti.dtype == np.int64 and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    assert ti[0, 0] == 2990


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_bf16_chunks_equal_the_flat_scan(memmap, prefetch):
    """The bf16 device dtype: every prefetch gives the flat bf16 scan's
    ids over the same rows where the scores are apart."""
    from mmrs_tpu_torch.ops.topk import cosine_topk

    mm, queries = memmap
    tv, ti = streaming_topk(mm, queries, k=10, chunk_rows=512,
                            prefetch=prefetch)
    fv, fi = cosine_topk(torch.from_numpy(queries).bfloat16(),
                         torch.from_numpy(np.array(mm)).bfloat16(), 10)
    np.testing.assert_allclose(tv, fv.numpy(), atol=1e-6)
    gaps = np.diff(-fv.numpy(), axis=1) > 1e-6
    sure = np.concatenate([gaps[:, :1], gaps[:, 1:] & gaps[:, :-1]], 1)
    assert (ti[:, :-1][sure] == fi.numpy()[:, :-1][sure]).all()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fewer_rows_than_k_uses_minus_one(prefetch):
    emb = _rows(7, 16)
    jv, ji = j_streaming_topk(emb, emb[:2], k=10, chunk_rows=32,
                              device_dtype=jnp.float32, impl="xla")
    tv, ti = streaming_topk(emb, emb[:2], k=10, chunk_rows=32,
                            dtype=torch.float32, prefetch=prefetch)
    np.testing.assert_array_equal(ti, ji)
    assert (ti[:, 7:] == -1).all() and np.isneginf(tv[:, 7:]).all()


@pytest.mark.parametrize("prefetch", [1, 2])
def test_tail_smaller_than_k(prefetch):
    emb = _rows(100, 16)
    v, i = streaming_topk(emb, emb[:2], k=8, chunk_rows=97,
                          dtype=torch.float32, prefetch=prefetch)
    assert (i >= 0).all() and (i < 100).all()
    assert i[0, 0] == 0 and i[1, 0] == 1


def test_ring_reuses_prefetch_plus_one_slots(memmap, monkeypatch):
    """The ring holds prefetch + 1 buffers of one chunk and hands them out
    in turn; a slot's rows past a ragged tail are never read."""
    mm, queries = memmap
    made = []
    real = stream._UploadRing

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(stream, "_UploadRing", Spy)
    stream.streaming_topk(mm, queries, k=5, chunk_rows=700, prefetch=2)
    (ring,) = made
    assert len(ring.host) == 3 and ring.turn == 5
    assert tuple(ring.host[0].shape) == (700, 48)
    assert ring.host[0].dtype == torch.float16


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("chunk_rows,k,shards", [(700, 10, 8), (1024, 7, 3),
                                                 (250, 300, 4), (3000, 10, 2)])
def test_streaming_on_a_mesh_equals_jax(memmap, prefetch, chunk_rows, k,
                                        shards):
    """mesh=: each chunk split by rows over S CPU entries (a ring each)
    and scanned by sharded_cosine_topk, against JAX's sharded stream over
    S of its 8 CPU devices and the one-device stream: ids equal, values
    within 1e-5 (tests/test_multihost.py:257 holds the JAX pair to
    1e-5)."""
    import jax

    from mmrs_tpu.config import MeshConfig as JMeshConfig
    from mmrs_tpu.parallel.mesh import make_mesh as j_make_mesh
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.parallel.mesh import make_mesh

    mm, queries = memmap
    jm = j_make_mesh(JMeshConfig(data_size=shards), jax.devices()[:shards])
    tm = make_mesh(MeshConfig(data_size=shards), [torch.device("cpu")]
                   * shards)
    jv, ji = j_streaming_topk(mm, queries, k=k, chunk_rows=chunk_rows,
                              device_dtype=jnp.float32, impl="xla",
                              prefetch=prefetch, mesh=jm)
    tv, ti = streaming_topk(mm, queries, k=k, chunk_rows=chunk_rows,
                            dtype=torch.float32, prefetch=prefetch, mesh=tm)
    ov, oi = streaming_topk(mm, queries, k=k, chunk_rows=chunk_rows,
                            dtype=torch.float32, prefetch=prefetch)
    assert ti.dtype == np.int64 and tv.shape == (5, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti, oi)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    np.testing.assert_allclose(tv, ov, atol=1e-6)
    assert ti[0, 0] == 2990
