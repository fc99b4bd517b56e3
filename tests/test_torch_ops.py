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
from mmrs_tpu_torch.index import ivf
from mmrs_tpu_torch.models import layers
from mmrs_tpu_torch.ops import (_cuda, allpairs, attention, decode_attention,
                                dense_epilogue, layer_norm, mlp_int8,
                                normalize, preprocess, quant, quant4, topk)

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


def _merge_plan_model(scores: torch.Tensor, k: int):
    """What the scan and merge kernels compute, pass by pass, in plain
    PyTorch: each 256-row chunk's best kc, then each planned pass (a sort
    of `per` lists, or a merge of list pairs) keeps the best `out` of its
    candidates. Lists are ordered (score desc, id asc), the kernels' rule."""
    q, n = scores.shape
    n_chunks, kc, passes = topk.scan_plan(n, k)
    pad = n_chunks * topk.CHUNK_ROWS - n
    v = torch.cat([scores, scores.new_full((q, pad), float("-inf"))], 1)
    i = torch.cat([torch.arange(n).expand(q, n),
                   torch.full((q, pad), -1)], 1)

    def best(v, i, keep):          # rows of candidates -> their best `keep`
        _, o = torch.sort(i, dim=-1, stable=True)              # id asc
        v, i = v.gather(-1, o), i.gather(-1, o)
        _, o = torch.sort(v, dim=-1, descending=True, stable=True)
        return v.gather(-1, o)[..., :keep], i.gather(-1, o)[..., :keep]

    v, i = best(v.view(q, n_chunks, -1), i.view(q, n_chunks, -1), kc)
    for p in passes:
        groups = -(-p.lists // p.per)
        extra = groups * p.per - p.lists
        v = torch.cat([v, v.new_full((q, extra, p.length), float("-inf"))],
                      1)
        i = torch.cat([i, i.new_full((q, extra, p.length), -1)], 1)
        v, i = best(v.reshape(q, groups, -1), i.reshape(q, groups, -1),
                    p.out)
    return topk._pad(v.reshape(q, -1), i.reshape(q, -1).int(), k)


@pytest.mark.parametrize("q,n,k", [(1, 1, 1), (1, 1 << 20, 10),
                                   (64, 70000, 10), (5, 20000, 256),
                                   (9, 257, 100), (2, 20000, 257),
                                   (1, 20000, 513), (1, 20000, 1025),
                                   (1, 20000, 5000)])
def test_topk_scan_plan_ends_in_one_list(q, n, k):
    n_chunks, kc, passes = topk.scan_plan(n, k)
    assert n_chunks * topk.CHUNK_ROWS >= n > (n_chunks - 1) * topk.CHUNK_ROWS
    assert kc == min(k, topk.CHUNK_ROWS)
    lists, length = n_chunks, kc
    for p in passes:                  # each pass reads what the last wrote
        assert (p.lists, p.length) == (lists, length)
        if p.width:                   # a sort of >= 2 lists in shared memory
            assert p.per >= min(2 if k > topk.CHUNK_ROWS else 4, p.lists)
            assert p.per * p.length <= p.width <= (
                topk.MERGE_WIDTH if k <= topk.CHUNK_ROWS else topk.SORT_MAX)
            assert p.width & (p.width - 1) == 0
        else:                         # merge path: pairs too long to sort
            assert p.per == 2 and 2 * p.length > topk.SORT_MAX
        assert p.out == min(k, p.per * p.length)
        lists, length = -(-lists // p.per), p.out
        assert lists < p.lists        # the count strictly falls ...
    assert lists == 1                 # ... to one list
    assert length == min(k, n_chunks * kc)


@pytest.mark.parametrize("q,n,k", [(2, 3000, 10), (1, 20000, 300),
                                   (2, 9000, 4500), (1, 20000, 20000),
                                   (1, 3000, 5000)])
def test_topk_scan_plan_model_equals_plain_topk(q, n, k):
    """The planned passes keep the plain top-k, ties (scores rounded to
    0.01) lowest row first, k past N padded with (-inf, -1)."""
    rng = np.random.default_rng(n + k)
    s = torch.from_numpy(np.round(rng.standard_normal((q, n)), 2)
                         .astype(np.float32))
    v, i = _merge_plan_model(s, k)
    rv, ri = topk.sorted_topk(s, k)
    assert torch.equal(i, ri) and torch.equal(v, rv)


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


@pytest.mark.parametrize("t,hd,dtype,route,rows", [
    (50, 64, torch.bfloat16, "mma", 64), (257, 64, torch.bfloat16, "mma", 96),
    (577, 64, torch.bfloat16, "mma", 128), (257, 64, torch.float32, "fma", 64),
    (7, 32, torch.float32, "fma", 64), (1, 32, torch.bfloat16, "mma", 16),
    (64, 256, torch.bfloat16, "fma", 64)])
def test_mha_plan_fits_hopper_shared_memory(t, hd, dtype, route, rows):
    plan = attention.mha_plan(t, hd, dtype)
    assert (plan.route, plan.rows) == (route, rows)
    assert plan.smem <= attention.SMEM_LIMIT
    if route == "mma":   # Q tile and two K/V stages, bounded whatever T is
        hdp = 32 if hd <= 32 else 64 if hd <= 64 else 128
        assert plan.smem == 2 * (rows + 4 * 64) * (hdp + 8)
        most = 2 * (128 + 4 * 64) * (hdp + 8)   # 8 warps
        assert plan.smem <= most
        assert attention.mha_plan(100_000, hd, dtype).smem <= most


@pytest.mark.parametrize("t", [1, 64, 420, 421, 577, 4096, 100_000])
@pytest.mark.parametrize("hd,dtype", [
    (64, torch.float32), (128, torch.float32), (256, torch.float32),
    (160, torch.bfloat16), (512, torch.bfloat16), (1024, torch.float32)])
def test_mha_plan_stays_under_shared_memory_for_any_t(t, hd, dtype):
    """The CUDA-core route streams key tiles and 64-dim chunks of the head,
    so no T and no hd is refused: f32 at T = 577 (the 336-px L/14 at f32)
    and bf16 heads past 128 fit, in the same 64 x 64 tiles."""
    plan = attention.mha_plan(t, hd, dtype)
    assert plan.route == "fma" and plan.smem <= attention.SMEM_LIMIT
    assert (plan.rows, plan.smem) == (64, 4 * 64 * 68 * 4)


def _fma_tiles_model(q, k, v, heads, keys):
    """The CUDA-core route's arithmetic in plain PyTorch: a running max and
    sum over key tiles of `keys`, then p = exp(s - m) / l rounded to v's
    type once and P.V summed tile by tile in f32."""
    b, t, w = q.shape
    hd = w // heads
    split = [x.reshape(b, t, heads, hd).transpose(1, 2).float()
             for x in (q, k, v)]
    qf, kf, vf = split
    m = torch.full((b, heads, t, 1), float("-inf"))
    ls = torch.zeros((b, heads, t, 1))
    for k0 in range(0, t, keys):
        s = qf @ kf[:, :, k0:k0 + keys].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        scale = torch.where(torch.isinf(m), torch.zeros_like(m),
                            torch.exp(m - m_new))
        ls = ls * scale + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new
    o = torch.zeros_like(qf)
    for k0 in range(0, t, keys):
        s = qf @ kf[:, :, k0:k0 + keys].transpose(-1, -2)
        p = (torch.exp(s - m) / ls).to(v.dtype).float()
        o = o + p @ vf[:, :, k0:k0 + keys]
    return o.transpose(1, 2).reshape(b, t, w).to(q.dtype)


@pytest.mark.parametrize("t,keys", [(7, 7), (130, 64), (577, 64), (65, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_mha_key_tile_softmax_matches_plain(t, keys, dtype, tol):
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn((2, t, 64), generator=g).to(dtype)
               for _ in range(3))
    q = q * 32 ** -0.5
    got = _fma_tiles_model(q, k, v, 2, keys)
    ref = attention.mha_short_seq(q, k, v, 2, impl="torch")
    assert float((got.float() - ref.float()).abs().max()) <= tol


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


def _route_cases():
    """(entry point, its CPU arguments) for every op that takes `impl`, and
    the float dense that hands the towers' `impl` to the epilogue."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    def unit(n, d):
        x = rand(n, d)
        return x / x.norm(dim=1, keepdim=True)

    bf16 = torch.bfloat16
    q, gal = unit(3, 16), unit(40, 16)
    w1 = rand(64, 32).mul(20).round().clamp(-127, 127).to(torch.int8)
    w2 = rand(32, 64).mul(20).round().clamp(-127, 127).to(torch.int8)
    buckets, bucket_ids = rand(4, 6, 16, dtype=bf16), torch.arange(
        24, dtype=torch.int32).reshape(4, 6)
    bucket_ids[:, 4:] = -1
    probe = torch.tensor([[0, 2], [3, 1]], dtype=torch.int32)
    packed, scales = quant4.quantize_rows_int4(rand(24, 16))
    lin = torch.nn.Linear(32, 16)
    lin.weight.data = lin.weight.data.to(bf16)
    lin.requires_grad_(False)
    kv = rand(1, 2, 8, 16, dtype=bf16)
    return {
        "cosine_topk": (topk.cosine_topk, (q, gal, 5)),
        "cosine_topk_quantized": (quant.cosine_topk_quantized,
                                  (q, *quant.quantize_rows(gal), 5)),
        "cosine_topk_int4": (quant4.cosine_topk_int4,
                             (q, *quant4.quantize_rows_int4(gal), 5)),
        "mha_short_seq": (attention.mha_short_seq,
                          (*(rand(2, 7, 32, dtype=bf16) for _ in "qkv"), 4)),
        "bias_act": (dense_epilogue.bias_act,
                     (rand(5, 16), rand(16), "quick_gelu", bf16)),
        "layer_norm": (layer_norm.layer_norm,
                       (rand(5, 32, dtype=bf16), rand(32), rand(32), 1e-5)),
        "mlp_int8_fused": (mlp_int8.mlp_int8_fused,
                           (rand(4, 32, dtype=bf16), w1, rand(64).abs() / 50,
                            rand(64), w2, rand(32).abs() / 50, rand(32),
                            "gelu")),
        "normalize_images": (preprocess.normalize_images,
                             (torch.randint(0, 256, (2, 8, 8, 3), generator=g,
                                            dtype=torch.uint8),)),
        "first_match": (allpairs.first_match,
                        (torch.cat([gal[:6], gal[:4]]),) * 2 + (0.9, True)),
        "decode_attention": (decode_attention.decode_attention,
                             (rand(1, 2, 2, 16, dtype=bf16), kv, None, kv,
                              None, 5)),
        "chunk_attention": (decode_attention.chunk_attention,
                            (rand(1, 2, 2, 3, 16, dtype=bf16), kv, None, kv,
                             None, 2)),
        "probe_buckets": (ivf.probe_buckets,
                          (rand(2, 16, dtype=bf16), probe, buckets,
                           bucket_ids, None, 3)),
        "probe_buckets_q4": (ivf.probe_buckets_q4,
                             (*quant4.prep_queries(unit(2, 16)), probe,
                              packed.reshape(4, 6, 8), bucket_ids,
                              scales.reshape(4, 6), 3)),
        "dense": (layers.dense, (rand(5, 32, dtype=bf16), lin, bf16,
                                 layers.quick_gelu)),
    }


@pytest.mark.parametrize("name", list(_route_cases()))
def test_every_entry_point_takes_the_one_route_rule(name):
    """_cuda.takes_kernel: an unknown `impl` raises before any work, and on
    CPU tensors "auto" is the plain version, bit for bit."""
    fn, args = _route_cases()[name]
    with pytest.raises(ValueError, match="unknown impl"):
        fn(*args, impl="pallas")
    auto, plain = ([out] if isinstance(out, torch.Tensor) else list(out)
                   for out in (fn(*args, impl=i) for i in ("auto", "torch")))
    assert len(auto) == len(plain)
    for a, p in zip(auto, plain):
        assert a.dtype == p.dtype and torch.equal(a, p), name


def test_kernel_build_is_keyed_by_source_hash():
    path = _cuda.library_path()
    assert path.startswith(_cuda.BUILD_DIR)
    assert _cuda._source_hash() in path
    for name in _cuda.CUDA_SOURCES:
        with open(f"{_cuda.CSRC_DIR}/{name}", encoding="utf-8") as f:
            head = f.read(600)
        assert "Replaces the Pallas TPU kernel" in head
