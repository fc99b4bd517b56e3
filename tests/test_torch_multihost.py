"""The port's multi-process mesh helpers (parallel/multihost.py) against
mmrs_tpu's: the single-process forms on CPU meshes (JAX's on the 8-device
CPU mesh of tests/conftest.py), then real multi-process runs over
torch.distributed (gloo, TCP on 127.0.0.1), as tests/test_multihost.py
runs jax.distributed. The multi-process answers must be identical in
every process and equal to the numpy oracles of tests/test_multihost.py.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mmrs_tpu.config import MeshConfig as JMeshConfig
from mmrs_tpu.parallel import multihost as j_mh
from mmrs_tpu.parallel import topk as j_topk
from mmrs_tpu_torch.config import MeshConfig
from mmrs_tpu_torch.parallel import multihost as mh
from mmrs_tpu_torch.parallel import topk

torch.set_num_threads(2)
CPU = torch.device("cpu")
EIGHT = [CPU] * 8


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def test_distributed_init_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mh.distributed_init() is False
    assert j_mh.distributed_init() is False
    assert mh.process_count() == 1 and mh.process_index() == 0
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_hybrid_mesh_single_process_matches_jax():
    for cfg in (dict(model_size=2), dict()):
        tm = mh.make_hybrid_mesh(MeshConfig(**cfg), EIGHT)
        jm = j_mh.make_hybrid_mesh(JMeshConfig(**cfg))
        assert tm.shape == dict(jm.shape)
        assert (tm.owner == 0).all()
    assert mh.make_hybrid_mesh(MeshConfig(model_size=2), EIGHT).shape == {
        "data": 4, "model": 2}


def test_hybrid_mesh_validates_model_axis():
    for make, cfg, extra in ((mh.make_hybrid_mesh, MeshConfig, (EIGHT,)),
                             (j_mh.make_hybrid_mesh, JMeshConfig, ())):
        with pytest.raises(ValueError, match="must divide local device "
                                             "count"):
            make(cfg(model_size=3), *extra)
        with pytest.raises(ValueError, match="data_size"):
            make(cfg(model_size=2, data_size=8), *extra)


def test_process_local_rows_covers_everything():
    tm = mh.make_hybrid_mesh(MeshConfig(), EIGHT)
    jm = j_mh.make_hybrid_mesh(JMeshConfig())
    for n in (1000, 9, 5, 1, 8, 16):
        assert mh.process_local_rows(n, tm) == j_mh.process_local_rows(n, jm)
    assert mh.process_local_rows(1000, tm) == (0, 1000)


def test_sharded_topk_on_hybrid_mesh():
    tm = mh.make_hybrid_mesh(MeshConfig(model_size=1), EIGHT)
    jm = j_mh.make_hybrid_mesh(JMeshConfig(model_size=1))
    rng = np.random.default_rng(0)
    g = rng.normal(size=(1000, 64)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[[3, 997]]
    tv, ti = topk.sharded_cosine_topk(torch.from_numpy(q),
                                      torch.from_numpy(g), 5, tm)
    jv, ji = j_topk.sharded_cosine_topk(q, g, k=5, mesh=jm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    assert list(ti[:, 0].numpy()) == [3, 997]


def test_place_global_rows_single_process_matches_place_gallery():
    tm = mh.make_hybrid_mesh(MeshConfig(), EIGHT)
    jm = j_mh.make_hybrid_mesh(JMeshConfig())
    rng = np.random.default_rng(1)
    g = rng.normal(size=(1001, 16)).astype(np.float32)     # ragged tail
    a = mh.place_global_rows(g, 1001, tm)
    b = topk.place_gallery(torch.from_numpy(g), tm)
    assert len(a) == len(b) == 8
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    want = np.asarray(j_mh.place_global_rows(g, 1001, jm))
    np.testing.assert_array_equal(torch.cat(a).numpy(), want)
    with pytest.raises(ValueError, match="process owns rows"):
        mh.place_global_rows(g[:10], 1001, tm)


@pytest.mark.parametrize("n", [9, 5, 1, 8, 16])
def test_place_global_rows_small_awkward_n(n):
    """n small enough to leave trailing data-axis shards holding only
    padding must still place (tests/test_multihost.py:287)."""
    tm = mh.make_hybrid_mesh(MeshConfig(), EIGHT)
    lo, hi = mh.process_local_rows(n, tm)
    assert 0 <= lo <= hi <= n
    g = np.arange((hi - lo) * 4, dtype=np.float32).reshape(hi - lo, 4)
    blocks = mh.place_global_rows(g, n, tm)
    got = torch.cat(blocks).numpy()
    np.testing.assert_array_equal(got[lo:hi], g)
    assert got.shape[0] == 8 * -(-n // 8)
    jm = j_mh.make_hybrid_mesh(JMeshConfig())
    np.testing.assert_array_equal(
        got, np.asarray(j_mh.place_global_rows(g, n, jm)))


# -- real multi-process runs ---------------------------------------------------

def _oracle():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(1000, 32)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    return np.argsort(-(g[[3, 500, 997]] @ g.T), axis=1)[:, :5]


def _dedup_oracle():
    """Numpy keep-first first-match on the worker's planted corpus."""
    rng_d = np.random.default_rng(7)
    xd = rng_d.normal(size=(96, 16)).astype(np.float32)
    xd[41] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[77] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[90] = xd[58]
    xd /= np.linalg.norm(xd, axis=1, keepdims=True)
    sims = xd @ xd.T
    out = np.full(96, -1, np.int64)
    for i in range(96):
        js = np.flatnonzero(sims[i, :i] >= 0.999)
        if js.size:
            out[i] = js[0]
    return out


LCFG = dict(vocab_size=96, dim=64, layers=2, heads=4, kv_heads=2,
            mlp_dim=128, max_seq=64)


def _decode_weights(tmp_path) -> str:
    """tests/_multihost_worker.py's LLaMA (JAX init from key 3) as an
    npz the workers load."""
    import jax

    from mmrs_tpu.models import llama as j_llama
    from mmrs_tpu.models.llama import LlamaConfig as JLlamaConfig
    from mmrs_tpu_torch.models import checkpoint

    params = jax.tree.map(np.asarray, j_llama.init(jax.random.key(3),
                                                   JLlamaConfig(**LCFG)))
    path = str(tmp_path / "llama.npz")
    checkpoint.save_npz(params, path)
    return path


def _decode_oracles(weights: str):
    """The workers' decode on one device in one process: the port's
    greedy_generate and JAX's, from the same weights and prompt."""
    import jax
    import jax.numpy as jnp

    from mmrs_tpu.models import llama as j_llama
    from mmrs_tpu.models.llama import LlamaConfig as JLlamaConfig
    from mmrs_tpu_torch.models import checkpoint, convert_jax, llama

    prompt = np.random.default_rng(4).integers(3, 90, (4, 5))
    tree = checkpoint.load_npz(weights)
    model = convert_jax.from_jax_llama(tree, llama.LlamaConfig(**LCFG))
    port = llama.greedy_generate(
        model, llama.embed_tokens(model, torch.from_numpy(prompt)), 6, -1,
        torch.float32).numpy()
    jparams = jax.tree.map(jnp.asarray, jax_tree(tree))
    jax_out = np.asarray(j_llama.greedy_generate(
        jparams, j_llama.embed_tokens(jparams, jnp.asarray(prompt,
                                                           jnp.int32)),
        JLlamaConfig(**LCFG), max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32))
    return port, jax_out


def jax_tree(tree):
    """A loaded tree's torch leaves as numpy arrays (JAX takes them)."""
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _spawn_workers(tmp_path, nproc: int, local_devices: int,
                   model_size: int, weights: str = ""):
    """nproc torch.distributed worker processes over gloo, joined by a
    file rendezvous under tmp_path (no port is picked, so nothing else
    on the machine can take it first); their JSON. A failed worker's
    exit code and the tail of its stderr are in the assertion message."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MMRS_TORCH_DEVICE="cpu",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    worker = os.path.join(os.path.dirname(__file__),
                          "_torch_multihost_worker.py")
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    outs = [str(tmp_path / f"out{i}.json") for i in range(nproc)]
    errs = [tmp_path / f"err{i}.txt" for i in range(nproc)]
    procs = []
    for i in range(nproc):
        with open(errs[i], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, worker, rendezvous, str(nproc), str(i),
                 outs[i], str(local_devices), str(model_size), weights],
                env=env, stderr=err))
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if rcs != [0] * nproc:
        tails = "\n".join(f"worker {i} exit {rc}:\n"
                          + errs[i].read_text()[-2000:]
                          for i, rc in enumerate(rcs) if rc != 0)
        raise AssertionError(f"worker exit codes {rcs}\n{tails}")
    return [json.load(open(o)) for o in outs]


def test_two_process_sharded_topk_ivf_and_dedup(tmp_path):
    """2 processes x 2 CPU entries (data axis 4 = 2 x 2, process-major):
    disjoint per-process row placement, and a cross-process sharded
    top-k, slot-sharded IVF at nprobe == C and dedup ring that agree in
    both processes and with the numpy oracles. About 4 s here."""
    t0 = time.perf_counter()
    r0, r1 = _spawn_workers(tmp_path, nproc=2, local_devices=2,
                            model_size=1)
    assert r0["decode"] is None
    assert r0["mesh_shape"] == {"data": 4, "model": 1}
    assert r0["proc_grid"] == [[0], [0], [1], [1]] == r1["proc_grid"]
    assert r0["local_rows"] == [0, 500] and r1["local_rows"] == [500, 1000]
    assert r0["placed"] == [True, True, False, False]
    assert r1["placed"] == [False, False, True, True]
    oracle = _oracle()
    for key in ("idxs", "vals", "ivf_idxs", "dedup_first"):
        assert r0[key] == r1[key], key
    np.testing.assert_array_equal(np.asarray(r0["idxs"]), oracle)
    np.testing.assert_array_equal(np.asarray(r0["ivf_idxs"]), oracle)
    np.testing.assert_array_equal(np.asarray(r0["dedup_first"]),
                                  _dedup_oracle())
    assert time.perf_counter() - t0 < 120


def test_four_process_distributed(tmp_path):
    """4 processes x 2 CPU entries with a model axis of 2: each data row is
    one whole process, so the entire data axis (4) crosses processes; the
    decode runs the decoder TP over each process's two entries and one
    batch row a process, and must equal the single-process decode (the
    port's and JAX's). About 7 s here, so it stays in the default tier."""
    weights = _decode_weights(tmp_path)
    rs = _spawn_workers(tmp_path, nproc=4, local_devices=2, model_size=2,
                        weights=weights)
    r0 = rs[0]
    assert r0["mesh_shape"] == {"data": 4, "model": 2}
    assert r0["proc_grid"] == [[0, 0], [1, 1], [2, 2], [3, 3]]
    assert [r["local_rows"] for r in rs] == [
        [0, 250], [250, 500], [500, 750], [750, 1000]]
    for r in rs[1:]:
        for key in ("proc_grid", "idxs", "vals", "ivf_idxs", "dedup_first",
                    "decode"):
            assert r[key] == r0[key], key
    oracle = _oracle()
    np.testing.assert_array_equal(np.asarray(r0["idxs"]), oracle)
    np.testing.assert_array_equal(np.asarray(r0["ivf_idxs"]), oracle)
    np.testing.assert_array_equal(np.asarray(r0["dedup_first"]),
                                  _dedup_oracle())
    port, jax_out = _decode_oracles(weights)
    np.testing.assert_array_equal(np.asarray(r0["decode"]), port)
    np.testing.assert_array_equal(port, jax_out)
