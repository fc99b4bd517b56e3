"""The port's ops (mmrs_tpu_torch/ops) against mmrs_tpu's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX op (its Pallas
kernel in interpret mode, as mmrs_tpu's own tests run it, and its XLA
form) and through the port's plain PyTorch version, which is what the
port runs on a CPU tensor. The CUDA/Triton kernels themselves are held
against these plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrs_tpu.ops import attention as j_attention
from mmrs_tpu.ops import normalize as j_normalize
from mmrs_tpu.ops import preprocess as j_preprocess
from mmrs_tpu.ops import topk as j_topk
from mmrs_tpu_torch.ops import (_cuda, attention, mlp_int8, normalize,
                                preprocess, quant, quant4, topk)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# -- normalize_images (K3) ----------------------------------------------------

@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
def test_normalize_images_matches_jax_f32(jax_impl):
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    want = np.asarray(j_preprocess.normalize_images(
        jnp.asarray(px), dtype=jnp.float32, impl=jax_impl))
    got = preprocess.normalize_images(torch.from_numpy(px),
                                      dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_normalize_images_bf16_within_one_ulp_of_jax():
    rng = np.random.default_rng(1)
    px = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    want = np.asarray(j_preprocess.normalize_images(
        jnp.asarray(px), impl="pallas_interpret"), np.float32)
    got = preprocess.normalize_images(torch.from_numpy(px)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


# -- l2_normalize ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_normalize_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 33)).astype(np.float32) * 3.0
    want = np.asarray(j_normalize.l2_normalize(
        jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = normalize.l2_normalize(
        torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "float32"
                               else 1e-2)


# -- cosine_topk (K1) --------------------------------------------------------

@pytest.mark.parametrize("q,n,d,k,tile_n", [
    (3, 300, 64, 10, 128),      # ragged last tile
    (1, 1000, 96, 16, 256),
    (4, 5, 64, 10, 128),        # N < k: (-inf, -1) sentinels
])
def test_cosine_topk_matches_jax_pallas(q, n, d, k, tile_n):
    rng = np.random.default_rng(n)
    gal, qs = _unit_rows(rng, n, d), _unit_rows(rng, q, d)
    jv, ji = j_topk.cosine_topk(jnp.asarray(qs), jnp.asarray(gal), k=k,
                                impl="pallas_interpret", tile_n=tile_n)
    tv, ti = topk.cosine_topk(torch.from_numpy(qs), torch.from_numpy(gal), k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_cosine_topk_bf16_gallery_matches_jax_pallas():
    rng = np.random.default_rng(7)
    gal, qs = _unit_rows(rng, 500, 128), _unit_rows(rng, 2, 128)
    jv, ji = j_topk.cosine_topk(jnp.asarray(qs, jnp.bfloat16),
                                jnp.asarray(gal, jnp.bfloat16), k=10,
                                impl="pallas_interpret", tile_n=128)
    tv, ti = topk.cosine_topk(torch.from_numpy(qs).bfloat16(),
                              torch.from_numpy(gal).bfloat16(), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_cosine_topk_ties_return_lowest_row_first():
    rng = np.random.default_rng(3)
    gal = _unit_rows(rng, 400, 64)
    for dup in (150, 260, 399):      # exact copies across several tiles
        gal[dup] = gal[40]
    jv, ji = j_topk.cosine_topk(jnp.asarray(gal[40:41]), jnp.asarray(gal),
                                k=6, impl="pallas_interpret", tile_n=128)
    tv, ti = topk.cosine_topk(torch.from_numpy(gal[40:41]),
                              torch.from_numpy(gal), 6)
    assert ti[0, :4].tolist() == [40, 150, 260, 399]
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("q,n,k", [(1, 1, 1), (1, 1 << 20, 10),
                                   (64, 70000, 10), (5, 20000, 256),
                                   (9, 257, 100)])
def test_topk_scan_plan_ends_in_one_list(q, n, k):
    qt, n_chunks, per, lists = topk.scan_plan(q, n, k)
    assert qt == min(8, 1 << (q - 1).bit_length())   # smallest tile >= q
    assert n_chunks * topk.CHUNK_ROWS >= n > (n_chunks - 1) * topk.CHUNK_ROWS
    assert per * k <= topk.MERGE_WIDTH and per >= 4
    assert lists[0] == n_chunks and lists[-1] == 1
    assert all(b == -(-a // per) for a, b in zip(lists, lists[1:]))


# -- mha_short_seq (K2) ---------------------------------------------------------

@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "pallas_bd_interpret"])
@pytest.mark.parametrize("b,t,w,heads", [(2, 50, 768, 12), (2, 7, 96, 3)])
def test_mha_matches_jax_pallas(jax_impl, b, t, w, heads):
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((b, t, w)).astype(np.float32)
               for _ in range(3))
    q *= (w // heads) ** -0.5
    want = np.asarray(j_attention.mha_short_seq(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
        impl=jax_impl))
    got = attention.mha_short_seq(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), heads).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("t,hd,itemsize,tq", [
    (50, 64, 2, 50), (257, 64, 2, 32), (577, 64, 2, 32), (257, 64, 4, 32),
    (7, 32, 4, 7)])
def test_mha_tile_fits_hopper_shared_memory(t, hd, itemsize, tq):
    got_tq, smem = attention.mha_tile(t, hd, itemsize)
    assert got_tq == tq and smem <= attention.SMEM_LIMIT


def test_mha_tile_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        attention.mha_tile(4096, 128, 4)


# -- dispatch -------------------------------------------------------------------

def test_kernel_paths_refuse_cpu_tensors():
    """The kernel wrappers never run on the CPU: a CPU tensor reaches them
    only by mistake, and they raise instead of computing."""
    x = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention._mha_cuda(x, x, x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        topk._cosine_topk_cuda(x[0], x[1], 3)
    with pytest.raises(ValueError, match="CUDA"):
        preprocess._normalize_triton(torch.zeros((1, 4, 4, 3),
                                                 dtype=torch.uint8),
                                     torch.bfloat16)


def test_quantized_kernel_paths_refuse_cpu_tensors():
    """The same for the int8 / int4 scans (K4, K5) and the int8 MLP (K6)."""
    q = torch.zeros((2, 64), dtype=torch.int8)
    packed = torch.zeros((2, 32), dtype=torch.uint8)
    s = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA"):
        quant._topk_quant_cuda(q, s, q, s, 1)
    with pytest.raises(ValueError, match="CUDA"):
        quant4._topk_int4_cuda(q, s, s, packed, s, 1)
    w1, w2 = torch.zeros((128, 64), dtype=torch.int8), torch.zeros(
        (64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        mlp_int8._mlp_int8_cuda(torch.zeros((2, 64)), w1, torch.ones(128),
                                torch.zeros(128), w2, torch.ones(64),
                                torch.zeros(64), "gelu")


def test_unknown_impl_raises():
    x = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="impl"):
        topk.cosine_topk(x, x, 1, impl="pallas")


def test_kernel_build_is_keyed_by_source_hash():
    path = _cuda.library_path()
    assert path.startswith(_cuda.BUILD_DIR)
    assert _cuda._source_hash() in path
    for name in _cuda.CUDA_SOURCES:
        with open(f"{_cuda.CSRC_DIR}/{name}", encoding="utf-8") as f:
            head = f.read(600)
        assert "Replaces the Pallas TPU kernel" in head
