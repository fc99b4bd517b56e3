"""The port's GPU kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. On the GPU
machine (which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes include the edges the kernels handle in their own code: ragged
gallery chunks, N < k, multi-level top-k merges, k = 256, k past one
chunk (sort merges and merge-path merges, k = N), more queries than one
launch takes, ties, query tiles over T, ragged key tiles and narrow heads
of the tensor-core attention, ragged row tiles of the int8 MLP, f32
inputs, masked bucket slots and equal scores across probed buckets. The int8 and int4 scans and the
int4 bucket probe must equal their plain versions exactly (ids and values),
and so must the fused int8 MLP (nonzero biases, rows of exact rounding
ties), the all-pairs first match (every id, f32 and bf16 inputs) and the
float dense layer's epilogue (every bf16 bit, with zeros, ties, exp
overflows and subnormal sums). The
KV-cache attention kernels read strided layer views of stacked caches, with
per-row positions and kv_limit windows; they must agree with their plain
versions to 2e-2 (both round the probabilities to bf16, and a last-bit
difference of exp() or of the f32 sums can flip one rounding: one ulp of
a probability, 2^-8 at most, times |v| < 5), 99% of the outputs to 1e-4.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from mmrs_tpu_torch.index.ivf import (build_ivf_streaming, ivf_topk,
                                      probe_buckets, probe_buckets_q4)
from mmrs_tpu_torch.models import layers
from mmrs_tpu_torch.models.llama import _quantize_kv
from mmrs_tpu_torch.ops.allpairs import first_match
from mmrs_tpu_torch.ops import topk as topk_mod
from mmrs_tpu_torch.ops.decode_attention import (_chunk_cuda, _decode_cuda,
                                                 chunk_attention,
                                                 decode_attention,
                                                 group_pieces)
from mmrs_tpu_torch.ops.attention import mha_short_seq
from mmrs_tpu_torch.ops.dense_epilogue import _bias_act_cuda, bias_act
from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused
from mmrs_tpu_torch.ops.preprocess import normalize_images
from mmrs_tpu_torch.ops.quant import (_topk_quant_cuda, cosine_topk_quantized,
                                      quantize_rows)
from mmrs_tpu_torch.ops.quant4 import (_topk_int4_cuda, cosine_topk_int4,
                                       prep_queries, quantize_rows_int4)
from mmrs_tpu_torch.ops.topk import cosine_topk

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _unit_rows(n, d, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), device=dev, generator=g)
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("q,n,d,k", [
    (1, 1000, 512, 10),        # one query tile of 1, ragged last chunk
    (3, 257, 64, 5),           # tile of 4 with a padded query row
    (8, 5000, 768, 100),       # L/14 width, one merge pass
    (13, 300, 24, 256),        # k = 256 = one whole chunk
    (2, 3, 512, 10),           # N < k: (-inf, -1) sentinels
    (64, 70000, 512, 10),      # two merge passes
    (5, 20000, 128, 256),      # k = 256: four merge passes
])
def test_cosine_topk_kernel_matches_plain(dev, q, n, d, k):
    gal = _unit_rows(n, d, dev, seed=n)
    qs = _unit_rows(q, d, dev, seed=q + 1)
    before = cosine_topk.launches
    vals, ids = cosine_topk(qs, gal, k)
    torch.cuda.synchronize()
    assert cosine_topk.launches == before + 1
    rv, ri = cosine_topk(qs, gal, k, impl="torch")
    assert vals.shape == (q, k) and ids.dtype == torch.int32
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals), finite)
    assert torch.equal(ids[~finite], ri[~finite])            # the -1s
    assert float((vals[finite] - rv[finite]).abs().max()) <= 1e-5
    # ids agree wherever the plain scores are not within 1e-5 of a neighbour
    gap = torch.full_like(rv, float("inf"))
    diff = (rv[:, :-1] - rv[:, 1:]).abs()
    gap[:, :-1] = diff
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    clear = finite & (gap > 1e-5)
    assert torch.equal(ids[clear], ri[clear])


def test_cosine_topk_ties_lowest_row_first(dev):
    gal = _unit_rows(3000, 512, dev, seed=5)
    for dup in (700, 1400, 2999):
        gal[dup] = gal[300]
    vals, ids = cosine_topk(gal[300:301], gal, 6)
    assert ids[0, :4].tolist() == [300, 700, 1400, 2999]
    rv, ri = cosine_topk(gal[300:301], gal, 6, impl="torch")
    assert torch.equal(ids, ri)


def test_cosine_topk_kernel_rejects_what_it_cannot_run(dev):
    gal = _unit_rows(100, 64, dev, seed=0)
    with pytest.raises(ValueError, match="1 <= k"):
        cosine_topk(gal[:1], gal, 0)
    with pytest.raises(ValueError, match="bf16"):
        cosine_topk(gal[:1].float(), gal.float(), 5)
    wide = _unit_rows(20, 6264, dev, seed=1)    # query rows past the block
    with pytest.raises(ValueError, match="shared memory"):
        cosine_topk(wide[:1], wide, 5)


@pytest.mark.parametrize("b,t,w,heads,dtype,tol", [
    (2, 50, 768, 12, torch.bfloat16, 2e-2),     # ViT-B/32
    (3, 257, 1024, 16, torch.bfloat16, 2e-2),   # ViT-L/14: 9 query tiles
    (1, 577, 1024, 16, torch.bfloat16, 2e-2),   # 336-px L/14
    (2, 7, 96, 3, torch.float32, 1e-5),         # odd T and heads
    (2, 65, 128, 2, torch.float32, 1e-5),       # T just over one tile
    (1, 257, 1024, 16, torch.float32, 1e-5),
    (8, 577, 1024, 16, torch.float32, 1e-5),    # 336-px L/14 at f32
    (4, 257, 1024, 16, torch.bfloat16, 2e-2),   # the Taiyi pair's L/14
    (2, 577, 320, 2, torch.bfloat16, 2e-2),     # hd 160 on CUDA cores
    (1, 4096, 256, 2, torch.float32, 1e-5),     # a long f32 sequence
    (2, 1, 96, 3, torch.bfloat16, 2e-2),        # hd 32 on tensor cores:
    (2, 16, 96, 3, torch.bfloat16, 2e-2),       # one warp's rows,
    (2, 17, 96, 3, torch.bfloat16, 2e-2),       # one row into the next,
    (2, 63, 96, 3, torch.bfloat16, 2e-2),       # a ragged key tile,
    (2, 65, 96, 3, torch.bfloat16, 2e-2),       # one key past a tile,
    (2, 129, 96, 3, torch.bfloat16, 2e-2),      # three key tiles
    (2, 33, 120, 3, torch.bfloat16, 2e-2),      # hd 40, zero-padded to 64
    (2, 70, 100, 4, torch.bfloat16, 2e-2),      # hd 25: element loads
])
def test_mha_kernel_matches_plain(dev, b, t, w, heads, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn((b, t, w), device=dev, generator=g).to(dtype)
               for _ in range(3))
    q = q * (w // heads) ** -0.5
    before = mha_short_seq.launches
    out = mha_short_seq(q, k, v, heads)
    torch.cuda.synchronize()
    assert mha_short_seq.launches == before + 1
    ref = mha_short_seq(q, k, v, heads, impl="torch")
    assert out.dtype == dtype and out.shape == (b, t, w)
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("shape", [(2, 224, 224, 3), (1, 5, 7, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_normalize_kernel_matches_plain(dev, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(0, 256, shape, device=dev, dtype=torch.uint8,
                      generator=g)
    before = normalize_images.launches
    out = normalize_images(x, dtype=dtype)
    torch.cuda.synchronize()
    assert normalize_images.launches == before + 1
    ref = normalize_images(x, dtype=dtype, impl="torch")
    assert out.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    else:   # one bf16 ulp: f32 rounding of (x*c - m)*s may fuse differently
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-6,
                                   rtol=2 ** -7)


# -- int8 / int4 gallery scans (K4, K5): exact against plain ---------------------

QUANT_CASES = [
    (1, 1000, 512, 10),        # ragged last chunk
    (3, 257, 64, 5),           # tile of 4 with a padded query row
    (8, 5000, 768, 100),       # L/14 width, one merge pass
    (13, 300, 32, 256),        # k = 256 = one whole chunk
    (2, 3, 512, 10),           # N < k: (-inf, -1) sentinels
    (64, 70000, 512, 10),      # two merge passes
    (5, 20000, 128, 256),      # k = 256: four merge passes
]


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("q,n,d,k", QUANT_CASES)
def test_quantized_topk_kernels_equal_plain(dev, mode, q, n, d, k):
    gal = _unit_rows(n, d, dev, seed=n).float()
    qs = _unit_rows(q, d, dev, seed=q + 1).float()
    if mode == "int8":
        fn, packed = cosine_topk_quantized, quantize_rows(gal)
    else:
        fn, packed = cosine_topk_int4, quantize_rows_int4(gal)
    before = fn.launches
    vals, ids = fn(qs, *packed, k)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rv, ri = fn(qs, *packed, k, impl="torch")
    assert vals.shape == (q, k) and ids.dtype == torch.int32
    assert torch.equal(ids, ri)
    assert torch.equal(vals, rv)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_topk_ties_lowest_row_first(dev, mode):
    gal = _unit_rows(3000, 512, dev, seed=5).float()
    for dup in (700, 1400, 2999):
        gal[dup] = gal[300]
    fn = cosine_topk_quantized if mode == "int8" else cosine_topk_int4
    packed = (quantize_rows if mode == "int8" else quantize_rows_int4)(gal)
    vals, ids = fn(gal[300:301], *packed, 6)
    assert ids[0, :4].tolist() == [300, 700, 1400, 2999]
    rv, ri = fn(gal[300:301], *packed, 6, impl="torch")
    assert torch.equal(ids, ri) and torch.equal(vals, rv)


def test_quantized_topk_kernels_reject_what_they_cannot_run(dev):
    gal = _unit_rows(100, 64, dev, seed=0).float()
    q8, q4 = quantize_rows(gal), quantize_rows_int4(gal)
    for fn, packed in ((cosine_topk_quantized, q8), (cosine_topk_int4, q4)):
        with pytest.raises(ValueError, match="1 <= k"):
            fn(gal[:1], *packed, 0)
    odd = _unit_rows(10, 24, dev, seed=1).float()       # D % 16 != 0
    got = cosine_topk_quantized(odd[:1], *quantize_rows(odd), 3)   # padded
    want = cosine_topk_quantized(odd[:1], *quantize_rows(odd), 3,
                                 impl="torch")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="D % 16"):
        cosine_topk_int4(odd[:1], *quantize_rows_int4(odd), 3)


# -- fused int8 MLP (K6) -----------------------------------------------------------

def _mlp_weights(w, h, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def qlinear(n_in, n_out):
        lin = torch.nn.Linear(n_in, n_out).to(dev)
        with torch.no_grad():
            lin.weight.copy_(torch.randn((n_out, n_in), device=dev,
                                         generator=g) * 0.02)
            lin.bias.copy_(torch.randn(n_out, device=dev, generator=g) * 0.3)
        return layers.QLinear.from_linear(lin)

    return qlinear(w, h), qlinear(h, w)


def _mlp_input(m, w, dtype, dev, seed):
    """x [m, w] with two rows of exact ties: max |x| = 127 makes the row
    scale 1.0, so the x.5 entries must round half to even."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, w), device=dev, generator=g) * 0.5
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5],
                        device=dev).repeat(w // 8)
    x[0], x[1] = ties, -ties
    return x.to(dtype)


@pytest.mark.parametrize("m,w,h,dtype", [
    (224 * 50, 768, 3072, torch.bfloat16),    # ViT-B/32 serving batch
    (77, 768, 3072, torch.bfloat16),          # ragged last row tile
    (300, 1024, 4096, torch.bfloat16),        # L/14: 8-row tiles
    (33, 128, 512, torch.float32),
])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_int8_kernel_matches_plain(dev, m, w, h, dtype, act):
    w1, w2 = _mlp_weights(w, h, dev, seed=m)
    x = _mlp_input(m, w, dtype, dev, seed=m + 1)
    args = (x, w1.q, w1.s, w1.bias, w2.q, w2.s, w2.bias)
    before = mlp_int8_fused.launches
    out = mlp_int8_fused(*args, act=act)
    torch.cuda.synchronize()
    assert mlp_int8_fused.launches == before + 1
    ref = mlp_int8_fused(*args, act=act, impl="torch")
    assert out.dtype == dtype and out.shape == (m, w)
    # the same f32 operations in the same order: equal in every element
    assert torch.equal(out, ref), int((out != ref).sum())


@pytest.mark.parametrize("m,w,h", [
    (1, 512, 2048), (16, 512, 2048), (17, 512, 2048), (129, 512, 2048),
    (4616, 1024, 4096),                       # L/14-336: 8 x 577 rows
    (129, 96, 384),                           # ragged column tiles
    (577, 1024, 8192),                        # 32 KB f32 h rows
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_int8_kernel_ragged_rows_match_plain(dev, m, w, h, dtype, act):
    """Row counts that leave the last 128-row GEMM tile ragged (or a lone
    row): rows past M are neither read nor written, and every element
    equals the plain version."""
    w1, w2 = _mlp_weights(w, h, dev, seed=m + w)
    x = _mlp_input(m + 1, w, dtype, dev, seed=m)[1:] if m > 1 else \
        _mlp_input(2, w, dtype, dev, seed=m)[:1]
    args = (x.contiguous(), w1.q, w1.s, w1.bias, w2.q, w2.s, w2.bias)
    before = mlp_int8_fused.launches
    out = mlp_int8_fused(*args, act=act)
    torch.cuda.synchronize()
    assert mlp_int8_fused.launches == before + 1
    ref = mlp_int8_fused(*args, act=act, impl="torch")
    assert out.dtype == dtype and out.shape == (m, w)
    assert torch.equal(out, ref), int((out != ref).sum())


def test_mlp_int8_kernel_rejects_what_it_cannot_run(dev):
    w1, w2 = _mlp_weights(96, 384, dev, seed=0)
    x = torch.randn((5, 96), device=dev).bfloat16()
    with pytest.raises(ValueError, match="W % 32"):
        mlp_int8_fused(x[:, :80].contiguous(), w1.q[:, :80].contiguous(),
                       w1.s, w1.bias, w2.q[:80].contiguous(), w2.s[:80],
                       w2.bias[:80])
    with pytest.raises(ValueError, match="bf16 or f32"):
        mlp_int8_fused(x.half(), w1.q, w1.s, w1.bias, w2.q, w2.s, w2.bias)


def test_dense_bf16_on_the_card_matches_the_cpu(dev):
    """The bias repair's f32 sums (cuBLAS `out_dtype`) agree with the CPU
    form up to the order of the sums: a handful of one-ulp differences."""
    g = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(256, 512)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((512, 256), generator=g) * 0.05)
        lin.bias.copy_(torch.randn(512, generator=g) * 0.3)
    x = torch.randn((64, 256), generator=g)
    with torch.no_grad():
        want = layers.dense(x, lin, torch.bfloat16).float()
        got = layers.dense(x.to(dev), lin.to(dev), torch.bfloat16).float()
    assert int((got.cpu() != want).sum()) <= 16


# -- IVF bucket probes (K7 over bf16 / int8 buckets, K8 over int4) -------------

def _probe_index(n, d, c, quant, dev, seed, cap=0):
    """An IVF index over n seeded unit rows (rows 1..3 copies of row 0, so
    equal scores meet in one bucket), built on the card."""
    rows = _unit_rows(n, d, dev, seed).float()
    rows[1:4] = rows[0]
    return rows, build_ivf_streaming(
        lambda: iter([rows]), n, d, n_clusters=c, bucket_cap=cap, iters=3,
        chunk=n, sample=rows, quantize=quant, device=dev)


def _probe_lists(q, c, p, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.stack([torch.randperm(c, device=dev, generator=g)[:p]
                        for _ in range(q)]).int()


def _probe(ivf, qs, probe, k, ids=None, impl="auto"):
    ids = ivf.bucket_ids if ids is None else ids
    if ivf.quant == "int4":
        return probe_buckets_q4(*prep_queries(qs), probe, ivf.buckets, ids,
                                ivf.bucket_scales, k, impl=impl)
    return probe_buckets(qs.bfloat16(), probe, ivf.buckets, ids,
                         ivf.bucket_scales, k, impl=impl)


def _assert_probe_matches(vals, ids, rv, ri, exact):
    """int4: equal. bf16 / int8 (f32 sums in another order): values within
    1e-5, ids equal wherever the plain scores are more than 1e-5 apart."""
    if exact:
        assert torch.equal(ids, ri) and torch.equal(vals, rv)
        return
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals), finite)
    assert torch.equal(ids[~finite], ri[~finite])            # the -1s
    assert float((vals[finite] - rv[finite]).abs().max()) <= 1e-5
    gap = torch.full_like(rv, float("inf"))
    diff = (rv[:, :-1] - rv[:, 1:]).abs()
    gap[:, :-1] = diff
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    clear = finite & (gap > 1e-5)
    assert torch.equal(ids[clear], ri[clear])


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
@pytest.mark.parametrize("d", [512, 768])
@pytest.mark.parametrize("q,p,k", [(1, 8, 1), (7, 16, 10), (64, 32, 100),
                                   (3, 64, 256)])
def test_probe_kernels_match_plain(dev, quant, d, q, p, k):
    rows, ivf = _probe_index(30000, d, 64, quant, dev, seed=d)
    qs = rows[:q] + 0.05 * _unit_rows(q, d, dev, seed=q).float()
    qs = qs / qs.norm(dim=1, keepdim=True)
    probe = _probe_lists(q, 64, p, dev, seed=p)
    fn = probe_buckets_q4 if quant == "int4" else probe_buckets
    # masked slots inside the live prefix as well as the empty tail
    holes = ivf.bucket_ids.clone()
    holes[:, 3::11] = -1
    for ids in (ivf.bucket_ids, holes):
        before = fn.launches
        vals, got = _probe(ivf, qs, probe, k, ids)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        rv, ri = _probe(ivf, qs, probe, k, ids, impl="torch")
        assert vals.shape == (q, k) and got.dtype == torch.int32
        _assert_probe_matches(vals, got, rv, ri, exact=quant == "int4")


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_probe_kernels_tie_rule(dev, quant):
    """Equal scores: the earlier probe rank, then the earlier slot, first;
    k past the live slots pads with (-inf, -1)."""
    rows, ivf = _probe_index(2000, 512, 8, quant, dev, seed=3)
    home = int((ivf.bucket_ids == 0).nonzero()[0, 0])       # row 0's bucket
    other = (home + 1) % 8
    probe = torch.tensor([[other, home]], dtype=torch.int32, device=dev)
    vals, ids = _probe(ivf, rows[:1], probe, 256)
    rv, ri = _probe(ivf, rows[:1], probe, 256, impl="torch")
    assert ids[0, :4].tolist() == [0, 1, 2, 3]
    _assert_probe_matches(vals, ids, rv, ri, exact=quant == "int4")
    assert len(set(vals[0, :4].tolist())) == 1       # the tie is exact
    live = int((ivf.bucket_ids[[other, home]] >= 0).sum())
    if live < 256:
        assert (ids[0, live:] == -1).all() and torch.isinf(vals[0, live:]).all()


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_ivf_topk_on_the_card_matches_plain_with_a_big_spill(dev, quant):
    """bucket_cap 8 sends most rows to the spill (far more rows than a
    bucket holds); the kernel path equals the plain path end to end."""
    rows, ivf = _probe_index(20000, 512, 64, quant, dev, seed=5,
                             cap=8 if quant != "int4" else 128)
    assert int((ivf.spill_ids >= 0).sum()) > 4 * ivf.bucket_cap
    qs = rows[100:108]
    for nprobe in (4, 64):
        vals, ids = ivf_topk(qs, ivf, k=10, nprobe=nprobe)
        rv, ri = ivf_topk(qs, ivf, k=10, nprobe=nprobe, impl="torch")
        _assert_probe_matches(vals, ids, rv, ri, exact=quant == "int4")
        assert torch.equal(ids[:, 0].long(), torch.arange(100, 108,
                                                          device=dev))


@lru_cache(maxsize=None)
def _k7_index(quant, d, cap=0):
    """An IVF index over 30,000 seeded rows at C = 64 (cap ~600, or `cap`:
    three chunks a bucket, the last ragged) for the bucket-major probe
    tests."""
    return _probe_index(30_000, d, 64, quant, torch.device("cuda"),
                        seed=d + 1, cap=cap)


def _k7_lists(kind, q, c, dev, seed):
    """Probe lists [q, p] of one kind: every query the same list; no two
    entries of a query tile sharing a bucket; each list naming one bucket
    twice; or lists with out-of-range cluster ids (c + 5 and -3)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "shared":
        return _probe_lists(1, c, 16, dev, seed).repeat(q, 1)
    if kind == "disjoint":
        p = max(1, c // min(q, 8))
        perm = torch.randperm(c, device=dev, generator=g)
        return torch.stack([perm[(i % 8) * p:(i % 8 + 1) * p]
                            for i in range(q)]).int()
    lists = _probe_lists(q, c, 12, dev, seed)
    if kind == "repeats":
        return torch.cat([lists[:, :5], lists[:, 2:3], lists[:, 5:]], dim=1)
    bad = torch.rand(lists.shape, device=dev, generator=g) < 0.25
    lists[bad] = torch.where(torch.rand(lists.shape, device=dev,
                                        generator=g)[bad] < 0.5, c + 5,
                             -3).int()
    return lists


@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("d", [512, 520])
@pytest.mark.parametrize("kind", ["shared", "disjoint", "repeats",
                                  "out_of_range"])
@pytest.mark.parametrize("q", [1, 8, 64])
@pytest.mark.parametrize("k", [1, 10, 300, 1000])
def test_probe_kernel_bucket_major_matches_plain(dev, quant, d, kind, q, k):
    """K7 reads each bucket a query tile probes once and scores it for
    every query of the tile naming it: shared and disjoint lists, a bucket
    twice in one list (both virtual positions), out-of-range ids (empty
    slots, never read: plain sees an empty bucket C in their place),
    D % 16 == 8, k past one chunk."""
    rows, ivf = _k7_index(quant, d)
    c, cap = ivf.bucket_ids.shape
    qs = rows[:q] + 0.05 * _unit_rows(q, d, dev, seed=q).float()
    qs = qs / qs.norm(dim=1, keepdim=True)
    probe = _k7_lists(kind, q, c, dev, seed=q + k)
    before = probe_buckets.launches
    vals, ids = _probe(ivf, qs, probe, k)
    torch.cuda.synchronize()
    assert probe_buckets.launches == before + 1
    plain_probe = torch.where((probe < 0) | (probe >= c), c, probe)
    buckets = torch.cat([ivf.buckets, ivf.buckets[:1]])
    bucket_ids = torch.cat([ivf.bucket_ids, torch.full_like(
        ivf.bucket_ids[:1], -1)])
    scales = None if ivf.bucket_scales is None else torch.cat(
        [ivf.bucket_scales, ivf.bucket_scales[:1]])
    rv, ri = probe_buckets(qs.bfloat16(), plain_probe, buckets, bucket_ids,
                           scales, k, impl="torch")
    assert vals.shape == (q, k) and ids.dtype == torch.int32
    _assert_probe_matches(vals, ids, rv, ri, exact=False)


@pytest.mark.parametrize("d", [16, 48, 512])
@pytest.mark.parametrize("kind", ["shared", "disjoint", "repeats",
                                  "out_of_range"])
@pytest.mark.parametrize("q", [1, 8, 64])
@pytest.mark.parametrize("k", [1, 10, 33, 300])
def test_probe_kernel_q4_bucket_major_equals_plain(dev, d, kind, q, k):
    """K8, bucket-major on s8 tensor cores like K7: shared and disjoint
    lists, a bucket twice in one list, out-of-range ids, cap 640 (not a
    multiple of 256), empty slots inside the live prefix, D % 32 == 16
    (rows of 8 (mod 16) bytes: 8-byte pieces), k past one chunk; ids and
    values equal to plain in every element."""
    rows, ivf = _k7_index("int4", d, 640)
    c, cap = ivf.bucket_ids.shape
    assert cap == 640
    qs = rows[:q] + 0.05 * _unit_rows(q, d, dev, seed=q).float()
    qs = qs / qs.norm(dim=1, keepdim=True)
    probe = _k7_lists(kind, q, c, dev, seed=q + k)
    holes = ivf.bucket_ids.clone()
    holes[:, 5::13] = -1
    before = probe_buckets_q4.launches
    vals, ids = _probe(ivf, qs, probe, k, holes)
    torch.cuda.synchronize()
    assert probe_buckets_q4.launches == before + 1
    plain_probe = torch.where((probe < 0) | (probe >= c), c, probe)
    rv, ri = probe_buckets_q4(
        *prep_queries(qs), plain_probe, torch.cat([ivf.buckets,
                                                   ivf.buckets[:1]]),
        torch.cat([holes, torch.full_like(holes[:1], -1)]),
        torch.cat([ivf.bucket_scales, ivf.bucket_scales[:1]]), k,
        impl="torch")
    assert vals.shape == (q, k) and ids.dtype == torch.int32
    assert torch.equal(ids, ri) and torch.equal(vals, rv)


def test_probe_kernels_reject_what_they_cannot_run(dev):
    rows, ivf = _probe_index(1000, 64, 4, "", dev, seed=0)
    probe = _probe_lists(1, 4, 2, dev, seed=0)
    with pytest.raises(ValueError, match="1 <= k"):
        _probe(ivf, rows[:1], probe, 0)
    with pytest.raises(ValueError, match="scales"):
        probe_buckets(rows[:1].bfloat16(), probe, ivf.buckets.to(torch.int8),
                      ivf.bucket_ids, None, 5)
    with pytest.raises(ValueError, match="int32"):
        probe_buckets(rows[:1].bfloat16(), probe.long(), ivf.buckets,
                      ivf.bucket_ids, None, 5)
    rows, ivf4 = _probe_index(1000, 24, 4, "int4", dev, seed=0)  # D % 16
    with pytest.raises(ValueError, match="D % 16"):
        _probe(ivf4, rows[:1], probe, 5)


# -- K9: all-pairs first match ------------------------------------------------

def _near(x, cos, g):
    """Unit rows at exactly `cos` to the unit rows x (f32, on x's device)."""
    z = torch.randn(x.shape, device=x.device, generator=g)
    z -= (z * x).sum(1, keepdim=True) * x
    z /= z.norm(dim=1, keepdim=True)
    return cos * x + (1.0 - cos * cos) ** 0.5 * z


def _planted_rows(n, d, dev, seed):
    """f32 unit rows with noisy copies at 0.995 and near misses at 0.985 of
    earlier or later rows (tau 0.99 is then clear of every pair)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), device=dev, generator=g)
    x /= x.norm(dim=1, keepdim=True)
    pos = torch.randperm(n, device=dev, generator=g)
    k = max(1, n // 40)
    if n >= 4 * k:
        x[pos[k:2 * k]] = _near(x[pos[:k]], 0.995, g)
        x[pos[3 * k:4 * k]] = _near(x[pos[2 * k:3 * k]], 0.985, g)
    return x, g


def _k9(a, b, **kw):
    """K9 on the card, counted, against its plain version: every id equal."""
    before = first_match.launches
    got = first_match(a, b, 0.99, **kw)
    torch.cuda.synchronize()
    assert first_match.launches == before + 1
    want = first_match(a, b, 0.99, impl="torch", **kw)
    assert got.dtype == torch.int32 and got.shape == (a.shape[0],)
    assert torch.equal(got, want), int((got != want).sum())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 768, 40])
@pytest.mark.parametrize("n", [3000, 129, 1])
def test_first_match_kernel_intra_matches_plain(dev, dtype, d, n):
    x, _ = _planted_rows(n, d, dev, seed=n + d)
    got = _k9(x.to(dtype), x.to(dtype), intra=True)
    assert n < 100 or int((got >= 0).sum()) >= n // 40


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 768])
def test_first_match_kernel_cross_set_matches_plain(dev, dtype, d):
    x, g = _planted_rows(2500, d, dev, seed=d)
    b = x[:1300].clone()
    a = x[1000:].clone()               # rows 0..298 of a equal rows of b
    fresh = torch.randn((2, d), device=dev, generator=g)
    b[[0, -1]] = fresh / fresh.norm(dim=1, keepdim=True)
    a[7] = _near(b[-1:], 0.995, g)[0]  # its only match is the last column
    a[8] = _near(b[:1], 0.995, g)[0]
    got = _k9(a.to(dtype), b.to(dtype))
    assert got[7] == 1299 and got[8] == 0
    mid = got[9:299]
    assert bool(((mid >= 0) & (mid <= torch.arange(1009, 1299,
                                                  device=dev))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 768])
def test_first_match_kernel_offsets_match_plain(dev, dtype, d):
    """Ring blocks: rows 1000..2499 against columns 300..1399, and the
    halves of a set, which together give the whole set's answer."""
    x, _ = _planted_rows(2500, d, dev, seed=7 + d)
    x = x.to(dtype)
    _k9(x[1000:], x[300:1400], intra=True, row_offset=1000, col_offset=300)
    whole = _k9(x, x, intra=True)
    h1 = _k9(x[1250:], x[:1250], intra=True, row_offset=1250)
    h2 = _k9(x[1250:], x[1250:], intra=True, row_offset=1250,
             col_offset=1250)
    ring = torch.where(h1 >= 0, h1, torch.where(h2 >= 0, h2 + 1250, -1))
    assert torch.equal(whole[1250:], ring)
    none = _k9(x[:1250], x[1250:], intra=True, col_offset=1250)
    assert bool((none == -1).all())


def test_first_match_kernel_early_exit_and_masks(dev):
    x, _ = _planted_rows(700, 64, dev, seed=1)
    # tau -1: every pair matches, so every row's walk stops at its first tile
    assert first_match(x, x, -1.0, intra=True).tolist() == [-1] + [0] * 699
    assert bool((first_match(x, x[:300], -1.0) == 0).all())
    # padded columns (zeros, similarity 0 >= -0.5) must never match
    v = x[:1]
    assert first_match(-v.repeat(5, 1), v, -0.5).tolist() == [-1] * 5
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 512, 768])
@pytest.mark.parametrize("n,m", [(1000, 777), (129, 257), (257, 1)])
def test_first_match_kernel_ragged_shapes_match_plain(dev, dtype, d, n, m):
    """Ragged N and M against every column tile width and K step, cross
    set and intra with offsets (rows n.. of the set against columns
    m..)."""
    x, _ = _planted_rows(n + m, d, dev, seed=n + m + d)
    x = x.to(dtype)
    _k9(x[:n], x[n:])
    _k9(x[m:m + n], x[:m], intra=True, row_offset=m)
    _k9(x[:n], x[:n], intra=True)


def test_first_match_kernel_f32_exact_split_inputs(dev):
    """f32 rows whose bf16 lo planes are zero (f16 values, as the dedup
    command's f16 index gives them), and rows whose entries span
    magnitudes down to 1e-6 of the rest: ids equal to plain."""
    x, g = _planted_rows(3000, 512, dev, seed=11)
    _k9(x.half().float(), x.half().float(), intra=True)
    # copies planted after the scaling, at exactly 0.995
    y = torch.randn(x.shape, device=dev, generator=g)
    y *= torch.where(torch.rand(x.shape, device=dev, generator=g) < 0.25,
                     10.0 ** (-6 * torch.rand(x.shape, device=dev,
                                              generator=g)), 1.0)
    y /= y.norm(dim=1, keepdim=True)
    y[1000:1100] = _near(y[:100], 0.995, g)
    got = _k9(y, y, intra=True)
    assert bool((got[1000:1100] >= 0).all())


def _near_tau_rows(n, d, dev, seed, margin):
    """f32 unit rows with n // 8 copies at cosines f32(0.99) + margin and
    - margin in turn, made in f64 and rounded once to f32 (which moves a
    cosine by about 1e-8)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, d), device=dev, dtype=torch.float64, generator=g)
    x /= x.norm(dim=1, keepdim=True)
    pos = torch.randperm(n, device=dev, generator=g)
    p = n // 8
    src, dup = pos[:p], pos[p:2 * p]
    sign = 1.0 - 2.0 * (torch.arange(p, device=dev) % 2)
    cos = (float(np.float32(0.99)) + margin * sign)[:, None].double()
    z = torch.randn((p, d), device=dev, dtype=torch.float64, generator=g)
    z -= (z * x[src]).sum(1, keepdim=True) * x[src]
    z /= z.norm(dim=1, keepdim=True)
    x[dup] = cos * x[src] + (1.0 - cos * cos) ** 0.5 * z
    return x.float()


def _first_f64(a, b, intra, band=5e-7):
    """First match at f32(0.99) from f64 dots of the f32 rows, and the rows
    no counting score within `band` of tau leaves undecided."""
    tau = float(np.float32(0.99))
    s = a.double() @ b.double().T
    counts = torch.ones_like(s, dtype=torch.bool)
    if intra:
        idx = torch.arange(a.shape[0], device=a.device)
        counts = idx[None, :b.shape[0]] < idx[:, None]
    hit = counts & (s >= tau)
    cols = torch.arange(b.shape[0], device=a.device)
    first = torch.where(hit, cols[None, :], b.shape[0]).amin(dim=1)
    first = torch.where(first < b.shape[0], first, -1).int()
    return first, ~(counts & ((s - tau).abs() <= band)).any(dim=1)


@pytest.mark.parametrize("d", [512, 768])
def test_first_match_kernel_f32_keeps_f32_precision_near_tau(dev, d):
    """Copies 2e-6 either side of tau: the f32 route (six bf16 plane
    products) decides every row as an f64 dot does, intra and cross set;
    bf16 rows (the hi.hi product alone) do not, so this catches an f32
    route that loses a plane."""
    x = _near_tau_rows(4000, d, dev, seed=d, margin=2e-6)
    want, clear = _first_f64(x, x, True)
    assert bool(clear.all()) and int((want >= 0).sum()) >= 4000 // 16
    got = _k9(x, x, intra=True)
    assert torch.equal(got, want), int((got != want).sum())
    a = x[1000:3000]
    want_c, clear_c = _first_f64(a, x, False)
    assert bool(clear_c.all())
    got = _k9(a, x)
    assert torch.equal(got, want_c), int((got != want_c).sum())
    b = x.bfloat16()
    assert bool((first_match(b, b, 0.99, intra=True) != want).any())


def test_first_match_kernel_rejects_what_it_cannot_run(dev):
    x = torch.randn((10, 12), device=dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        first_match(x.half(), x.half(), 0.5)
    with pytest.raises(ValueError, match="one dtype"):
        first_match(x[:, :8].contiguous(), x[:, :8].bfloat16(), 0.5)
    cpu = torch.randn((10, 16))
    with pytest.raises(ValueError, match="CUDA"):
        first_match(cpu, cpu, 0.5, impl="cuda")


def _kv_cache(dev, layers, b, kvh, s, hd, quantized, seed):
    """A stacked [L, B, KVH, S, HD] cache: bf16, or int8 + f32 scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v = (torch.randn((layers, b, kvh, s, hd), device=dev, generator=g)
            for _ in range(2))
    if not quantized:
        return k.bfloat16(), None, v.bfloat16(), None
    (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
    return kq, ks, vq, vs


def _attn_close(out, ref):
    assert out.dtype == torch.float32 and out.shape == ref.shape
    d = (out - ref).abs()
    assert float(d.max()) <= 2e-2, float(d.max())
    assert float((d > 1e-4).float().mean()) <= 0.01


def _layer(t, li):
    return None if t is None else t[li]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b,kvh,g,hd,s,pos", [
    (8, 32, 1, 128, 704, 650),       # LLaMA-2-7B decode step
    (8, 4, 8, 64, 704, 600),         # the 1.1B draft (GQA 8)
    (3, 2, 2, 64, 77, 76),           # ragged S, the last slot
    (2, 3, 4, 128, 130, 0),          # one live key
    (1, 1, 1, 64, 40, 1000),         # pos past the end: every slot
])
def test_decode_attention_kernel_matches_plain(dev, quantized, b, kvh, g,
                                               hd, s, pos):
    k, ks, v, vs = _kv_cache(dev, 3, b, kvh, s, hd, quantized, seed=s + g)
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, kvh, g, hd), device=dev, generator=gen).bfloat16()
    args = (q, k[1], _layer(ks, 1), v[1], _layer(vs, 1))
    before = decode_attention.launches
    out = decode_attention(*args, pos)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    _attn_close(out, decode_attention(*args, pos, impl="torch"))
    # per-row positions, a dead tail past each
    rows = torch.randint(0, s, (b,), device=dev, generator=gen)
    _attn_close(decode_attention(*args, rows),
                decode_attention(*args, rows, impl="torch"))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b,kvh,g,c,hd,s,pos,lim", [
    (8, 32, 1, 64, 128, 704, 576, 640),   # 7B prefill chunk, 640 window
    (8, 32, 1, 64, 128, 704, 0, 64),      # the first chunk
    (8, 32, 1, 5, 128, 704, 600, None),   # the k=4 verify pass
    (8, 4, 8, 2, 64, 704, 599, None),     # the draft's T=2 step
    (2, 3, 2, 37, 64, 100, 20, 64),       # ragged C and window
    (1, 2, 4, 9, 128, 2048, 2000, None),  # the longest cache
])
def test_chunk_attention_kernel_matches_plain(dev, quantized, b, kvh, g, c,
                                              hd, s, pos, lim):
    k, ks, v, vs = _kv_cache(dev, 2, b, kvh, s, hd, quantized, seed=c + s)
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((b, kvh, g, c, hd), device=dev, generator=gen).bfloat16()
    args = (q, k[0], _layer(ks, 0), v[0], _layer(vs, 0))
    before = chunk_attention.launches
    out = chunk_attention(*args, pos, kv_limit=lim)
    torch.cuda.synchronize()
    assert chunk_attention.launches == before + 1
    _attn_close(out, chunk_attention(*args, pos, kv_limit=lim, impl="torch"))
    rows = torch.randint(0, max(1, (lim or s) - c), (b,), device=dev,
                         generator=gen)
    _attn_close(chunk_attention(*args, rows, kv_limit=lim),
                chunk_attention(*args, rows, kv_limit=lim, impl="torch"))


def test_kv_attention_kernels_refuse_what_they_cannot_run(dev):
    k, ks, v, vs = _kv_cache(dev, 1, 2, 2, 64, 64, True, seed=0)
    q = torch.randn((2, 2, 1, 64), device=dev).bfloat16()
    with pytest.raises(ValueError, match="bf16 q"):
        decode_attention(q.float(), k[0], ks[0], v[0], vs[0], 3)
    with pytest.raises(ValueError, match="bf16 cache"):
        decode_attention(q, k[0].float(), None, v[0].float(), None, 3)
    with pytest.raises(ValueError, match="head dims"):   # past 1024
        odd = torch.zeros((2, 2, 64, 1032), dtype=torch.bfloat16, device=dev)
        decode_attention(torch.zeros((2, 2, 1, 1032), dtype=torch.bfloat16,
                                     device=dev), odd, None, odd, None, 3)
    cpu = [t.cpu() for t in (q, k[0], ks[0], v[0], vs[0])]
    with pytest.raises(ValueError, match="CUDA"):
        _decode_cuda(*cpu, 3)
    with pytest.raises(ValueError, match="CUDA"):
        _chunk_cuda(cpu[0][:, :, :, None], *cpu[1:], 3)
    with pytest.raises(ValueError, match="head dims"):   # past 1024
        wide = torch.zeros((2, 2, 64, 1088), dtype=torch.bfloat16, device=dev)
        chunk_attention(torch.zeros((2, 2, 1, 3, 1088), dtype=torch.bfloat16,
                                    device=dev), wide, None, wide, None, 0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hd", [32, 72, 80, 96, 256])
@pytest.mark.parametrize("g", [1, 4, 7, 8])
@pytest.mark.parametrize("s", [704, 8192])
def test_kv_attention_kernels_any_head_dim_match_plain(dev, quantized, hd, g,
                                                       s):
    """Head dims off the 64 / 128 instances run on the smallest instance
    that holds them (32 on 64; 72, 80, 96 on 128; 256), the cache read as
    it is (rows of hd, 8-byte pieces for int8 rows of hd % 16 == 8): K11
    at the last slot, a third of the way and per-row positions; K10 at
    C = 5 and C = 64 with a window."""
    k, ks, v, vs = _kv_cache(dev, 2, 2, 2, s, hd, quantized, seed=hd + s + g)
    gen = torch.Generator(device=dev).manual_seed(hd + g)
    q = torch.randn((2, 2, g, hd), device=dev, generator=gen).bfloat16()
    args = (q, k[1], _layer(ks, 1), v[1], _layer(vs, 1))
    for pos in (s - 1, s // 3):
        _attn_close(*_decode_pair(args, pos))
    _attn_close(*_decode_pair(args, torch.tensor([s - 1, 100], device=dev)))
    for c, pos, lim in ((5, s - 5, None), (64, 576, 640)):
        qc = torch.randn((2, 2, g, c, hd), device=dev,
                         generator=gen).bfloat16()
        cargs = (qc,) + args[1:]
        before = chunk_attention.launches
        out = chunk_attention(*cargs, pos, kv_limit=lim)
        torch.cuda.synchronize()
        assert chunk_attention.launches == before + 1
        _attn_close(out, chunk_attention(*cargs, pos, kv_limit=lim,
                                         impl="torch"))


def _decode_pair(args, pos):
    """K11 (counted) and its plain version on the same inputs."""
    before = decode_attention.launches
    out = decode_attention(*args, pos)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    return out, decode_attention(*args, pos, impl="torch")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b,kvh,g,hd", [(8, 32, 1, 128), (8, 4, 8, 64)])
@pytest.mark.parametrize("s", [704, 1000, 5000])
def test_decode_attention_kernel_masked_rows_and_ragged_spans(
        dev, quantized, b, kvh, g, hd, s):
    """The 7B and draft shapes: pos 0; per-row positions with dead tails
    and a row whose every key is masked (NaN, as plain); S = 1000 and
    5000, whose last span is shorter than the others."""
    k, ks, v, vs = _kv_cache(dev, 1, b, kvh, s, hd, quantized, seed=s + g)
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, kvh, g, hd), device=dev, generator=gen).bfloat16()
    args = (q, k[0], _layer(ks, 0), v[0], _layer(vs, 0))
    _attn_close(*_decode_pair(args, 0))
    rows = torch.randint(0, s, (b,), device=dev, generator=gen)
    rows[1] = -1                                   # every key masked
    rows[2] = s - 1
    out, ref = _decode_pair(args, rows.int())
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan) and bool(nan[1].all())
    _attn_close(out[~nan].view(b - 1, -1), ref[~nan].view(b - 1, -1))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("g,hd", [(1, 128), (8, 64)])
@pytest.mark.parametrize("s", [8192, 32768])
def test_decode_attention_kernel_long_caches_match_plain(dev, quantized, g,
                                                         hd, s):
    """C.2: S past one block's shared memory at G = 8 (the logits of a
    span kept in shared memory at 8192, streamed three times at 32768)."""
    k, ks, v, vs = _kv_cache(dev, 1, 2, 2, s, hd, quantized, seed=s)
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 2, g, hd), device=dev, generator=gen).bfloat16()
    args = (q, k[0], _layer(ks, 0), v[0], _layer(vs, 0))
    for pos in (s - 1, s // 3):
        _attn_close(*_decode_pair(args, pos))
    rows = torch.tensor([s - 1, 100], device=dev)
    _attn_close(*_decode_pair(args, rows))


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_decode_attention_kernel_runs_65536_slots(dev, g):
    for quantized in (False, True):
        k, ks, v, vs = _kv_cache(dev, 1, 1, 2, 65536, 128, quantized, seed=g)
        gen = torch.Generator(device=dev).manual_seed(6)
        q = torch.randn((1, 2, g, 128), device=dev, generator=gen).bfloat16()
        args = (q, k[0], _layer(ks, 0), v[0], _layer(vs, 0))
        _attn_close(*_decode_pair(args, 65535))


@pytest.mark.parametrize("quantized", [False, True])
def test_chunk_attention_kernel_runs_a_long_cache(dev, quantized):
    """S = 8000, where a [16, S] f32 score tile would not fit shared
    memory: the two-pass kernel's shared memory does not grow with S."""
    k, ks, v, vs = _kv_cache(dev, 1, 1, 2, 8000, 64, quantized, seed=8)
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((1, 2, 2, 9, 64), device=dev, generator=gen).bfloat16()
    args = (q, k[0], _layer(ks, 0), v[0], _layer(vs, 0))
    for pos in (7990, 4000):
        _attn_close(chunk_attention(*args, pos),
                    chunk_attention(*args, pos, impl="torch"))


# -- C.1: any k, and any Q, through the scans' merge passes --------------------

LARGE_K = [257, 300, 513, 1000, 1025, 4097, 20_000]     # 20,000 = N


def _scan(kind, qs, gal, k, impl="auto"):
    """K1 (bf16) or K4 / K5 (int8 / int4, `gal` a packed tuple)."""
    if kind == "bf16":
        return cosine_topk(qs.bfloat16(), gal, k, impl=impl)
    fn = cosine_topk_quantized if kind == "int8" else cosine_topk_int4
    return fn(qs, *gal, k, impl=impl)


def _gallery(kind, rows):
    return {"bf16": lambda r: r.bfloat16(), "int8": quantize_rows,
            "int4": quantize_rows_int4}[kind](rows)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("k", LARGE_K)
def test_topk_kernels_any_k_match_plain(dev, kind, q, k):
    """k > 256: bf16 ids equal plain where scores are separated (values
    within 1e-5); int8 / int4 ids and values equal."""
    rows = _unit_rows(20_000, 512, dev, seed=11).float()
    qs = rows[:q] + 0.05 * _unit_rows(q, 512, dev, seed=q).float()
    qs = qs / qs.norm(dim=1, keepdim=True)
    gal = _gallery(kind, rows)
    fn = {"bf16": cosine_topk, "int8": cosine_topk_quantized,
          "int4": cosine_topk_int4}[kind]
    before = fn.launches
    vals, ids = _scan(kind, qs, gal, k)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rv, ri = _scan(kind, qs, gal, k, impl="torch")
    assert vals.shape == (q, k) and ids.dtype == torch.int32
    _assert_probe_matches(vals, ids, rv, ri, exact=kind != "bf16")
    assert len(set(ids[0].tolist())) == k           # every row once at k = N


@lru_cache(maxsize=None)
def _large_k_index(quant):
    """An IVF index over 20,000 seeded rows at C = 16, every bucket probed:
    the virtual gallery holds each live row once."""
    return _probe_index(20_000, 512, 16, quant, torch.device("cuda"),
                        seed=12)


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
@pytest.mark.parametrize("q", [1, 8])
@pytest.mark.parametrize("k", LARGE_K)
def test_probe_kernels_any_k_match_plain(dev, quant, q, k):
    rows, ivf = _large_k_index(quant)
    qs = rows[:q] + 0.05 * _unit_rows(q, 512, dev, seed=q).float()
    qs = qs / qs.norm(dim=1, keepdim=True)
    probe = _probe_lists(q, 16, 16, dev, seed=q)
    fn = probe_buckets_q4 if quant == "int4" else probe_buckets
    before = fn.launches
    vals, ids = _probe(ivf, qs, probe, k)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    rv, ri = _probe(ivf, qs, probe, k, impl="torch")
    assert vals.shape == (q, k) and ids.dtype == torch.int32
    _assert_probe_matches(vals, ids, rv, ri, exact=quant == "int4")


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_topk_kernels_split_70000_queries(dev, kind):
    """Q = 70,000 > 65,535 (the merge grid's y extent): two launch
    sequences, the same answer as plain."""
    rows = _unit_rows(1000, 128, dev, seed=13).float()
    qs = _unit_rows(70_000, 128, dev, seed=14).float()
    gal = _gallery(kind, rows)
    vals, ids = _scan(kind, qs, gal, 5)
    rv, ri = _scan(kind, qs, gal, 5, impl="torch")
    assert vals.shape == (70_000, 5)
    _assert_probe_matches(vals, ids, rv, ri, exact=kind != "bf16")


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_probe_kernels_split_70000_queries(dev, quant):
    """The IVF probes over Q = 70,000: equal to the same kernel run on
    slices of the queries, and to plain on the first and last 50."""
    rows, ivf = _probe_index(3000, 128, 8, quant, dev, seed=15)
    qs = _unit_rows(70_000, 128, dev, seed=16).float()
    probe = _probe_lists(1, 8, 4, dev, seed=0).repeat(70_000, 1)
    vals, ids = _probe(ivf, qs, probe, 5)
    for a, b in ((0, 35_000), (35_000, 70_000)):
        sv, si = _probe(ivf, qs[a:b], probe[a:b], 5)
        assert torch.equal(vals[a:b], sv) and torch.equal(ids[a:b], si)
    for sl in (slice(0, 50), slice(-50, None)):
        rv, ri = _probe(ivf, qs[sl], probe[sl], 5, impl="torch")
        _assert_probe_matches(vals[sl], ids[sl], rv, ri,
                              exact=quant == "int4")


# -- K11 and K10 at any G (query heads over kv heads) ------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("g", [3, 5, 6, 7, 12, 16])
@pytest.mark.parametrize("s", [704, 8192])
def test_decode_attention_kernel_any_group_matches_plain(dev, quantized, g,
                                                         s):
    """G outside K11's instances (1, 2, 4, 8): the wrapper launches
    ceil(G / 8) pieces, the last padded with zero heads (G = 7 -> one
    launch at 8); each head's softmax is its own, so the answer is the
    plain version's."""
    k, ks, v, vs = _kv_cache(dev, 1, 2, 3, s, 128, quantized, seed=s + g)
    gen = torch.Generator(device=dev).manual_seed(g)
    q = torch.randn((2, 3, g, 128), device=dev, generator=gen).bfloat16()
    args = (q, k[0], _layer(ks, 0), v[0], _layer(vs, 0))
    for pos in (s - 1, s // 3, torch.tensor([s - 1, 100], device=dev)):
        before = decode_attention.launches
        out = decode_attention(*args, pos)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + len(group_pieces(g))
        _attn_close(out, decode_attention(*args, pos, impl="torch"))


@pytest.mark.parametrize("quantized", [False, True])
def test_chunk_attention_kernel_any_group_matches_plain(dev, quantized):
    """K10 has no G limit: its rows are G * C of a kv head."""
    for g in (3, 5, 6, 7, 12, 16):
        k, ks, v, vs = _kv_cache(dev, 1, 2, 3, 704, 128, quantized, seed=g)
        gen = torch.Generator(device=dev).manual_seed(g)
        q = torch.randn((2, 3, g, 5, 128), device=dev,
                        generator=gen).bfloat16()
        args = (q, k[0], _layer(ks, 0), v[0], _layer(vs, 0))
        before = chunk_attention.launches
        out = chunk_attention(*args, 600)
        torch.cuda.synchronize()
        assert chunk_attention.launches == before + 1
        _attn_close(out, chunk_attention(*args, 600, impl="torch"))


# -- K1, K4 and K5: spans of rows on tensor cores, the threshold select --------

SPAN_QS = [1, 7, 8, 9, 64]
SPAN_KS = [1, 10, 32, 33, 256, 257, 1000]
SPAN_NS = [topk_mod.SPAN_MAX - 1, topk_mod.SPAN_MAX, topk_mod.SPAN_MAX + 1,
           2 * topk_mod.SPAN_MAX + 17]


def _span_case(kind, q, n, d, seed):
    """(queries, gallery) with each query near a gallery row; bf16 rows,
    or int8 / int4 coded rows (queries stay f32: the wrapper codes them)."""
    rows = _unit_rows(n, d, dev=torch.device("cuda"), seed=seed).float()
    src = torch.arange(q, device=rows.device) * 7 % n
    qs = rows[src] + 0.05 * _unit_rows(q, d, rows.device, seed + 1).float()
    qs = qs / qs.norm(dim=1, keepdim=True)
    if kind == "bf16":
        return qs.bfloat16(), rows.bfloat16()
    return qs, (quantize_rows if kind == "int8" else quantize_rows_int4)(rows)


def _span_scan(kind, qs, gal, k, rows=None, impl="auto"):
    """K1 / K4 / K5 through the public wrapper, or (rows given) through the
    kernel path with that span forced."""
    if rows is None:
        if kind == "bf16":
            return cosine_topk(qs, gal, k, impl=impl)
        fn = cosine_topk_quantized if kind == "int8" else cosine_topk_int4
        return fn(qs, *gal, k, impl=impl)
    if kind == "bf16":
        return topk_mod._cosine_topk_cuda(qs, gal, k, rows)
    if kind == "int8":
        return _topk_quant_cuda(*quantize_rows(qs), *gal, k, rows)
    return _topk_int4_cuda(*prep_queries(qs), *gal, k, rows)


def _assert_scan_close(kind, vals, ids, rv, ri):
    """int8 / int4: equal to plain. bf16: values within 1e-5 of the f32
    plain version; ids equal wherever the plain scores (k + 1 of them) are
    more than 1e-5 from both neighbours."""
    k = vals.shape[1]
    if kind != "bf16":
        assert torch.equal(ids, ri[:, :k]) and torch.equal(vals, rv[:, :k])
        return
    finite = torch.isfinite(rv[:, :k])
    assert torch.equal(torch.isfinite(vals), finite)
    assert torch.equal(ids[~finite], ri[:, :k][~finite])
    assert float((vals[finite] - rv[:, :k][finite]).abs().max()) <= 1e-5
    rvd = rv.double()
    diff = (rvd[:, :-1] - rvd[:, 1:]).abs()
    left = torch.cat([torch.full_like(diff[:, :1], float("inf")),
                      diff[:, :k - 1]], 1)
    clear = finite & (left > 1e-5) & (diff[:, :k] > 1e-5)
    assert torch.equal(ids[clear], ri[:, :k][clear])


@pytest.mark.parametrize("kind,d", [(kind, d) for kind, first in
                                    (("bf16", 24), ("int8", 16), ("int4", 16))
                                    for d in (first, 48, 512, 768, 2048)])
@pytest.mark.parametrize("q", SPAN_QS)
@pytest.mark.parametrize("k", SPAN_KS)
def test_span_scans_match_plain_across_span_edges(dev, kind, d, q, k):
    """N = R - 1, R, R + 1 and 2R + 17 rows with the span forced to R =
    SPAN_MAX (k <= 32; 256-row chunks above), then the public wrapper
    (its own span) at the last N: K4 and K5 equal to plain, K1 within
    1e-5."""
    fn = {"bf16": cosine_topk, "int8": cosine_topk_quantized,
          "int4": cosine_topk_int4}[kind]
    for n in SPAN_NS:
        qs, gal = _span_case(kind, q, n, d, seed=n + d)
        rv, ri = _span_scan(kind, qs, gal, k + 1, impl="torch")
        rows = topk_mod.SPAN_MAX if k <= topk_mod.SELECT_MAX else 256
        vals, ids = _span_scan(kind, qs, gal, k, rows)
        assert vals.shape == (q, k) and ids.dtype == torch.int32
        _assert_scan_close(kind, vals, ids, rv, ri)
    before = fn.launches
    vals, ids = _span_scan(kind, qs, gal, k)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_scan_close(kind, vals, ids, rv, ri)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("k", [1, 10, 32, 33, 300])
def test_span_scans_identical_rows_give_the_first_ids(dev, kind, k):
    """Every row the same: every score ties, so the answer is rows
    0..k-1 (the threshold test is strict after the first compaction)."""
    row = _unit_rows(1, 512, dev, seed=3).float()
    rows = row.expand(5000, 512).contiguous()
    qs = (row + 0.1 * _unit_rows(2, 512, dev, seed=4).float())
    qs = qs / qs.norm(dim=1, keepdim=True)
    if kind == "bf16":
        qs, gal = qs.bfloat16(), rows.bfloat16()
    else:
        gal = (quantize_rows if kind == "int8" else quantize_rows_int4)(rows)
    for span in (None, topk_mod.SPAN_MAX if k <= topk_mod.SELECT_MAX
                 else None):
        vals, ids = _span_scan(kind, qs, gal, k, span)
        assert ids.tolist() == [list(range(k))] * 2
        rv, ri = _span_scan(kind, qs, gal, k, impl="torch")
        assert torch.equal(ids, ri)
        assert torch.equal(vals, rv) if kind != "bf16" else \
            float((vals - rv).abs().max()) <= 1e-5


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_span_scans_1m_rows_match_plain(dev, kind):
    """The main path's shape: 2^20 x 512, Q = 8, k = 10 (2048-row spans)."""
    qs, gal = _span_case(kind, 8, 1 << 20, 512, seed=21)
    vals, ids = _span_scan(kind, qs, gal, 10)
    rv, ri = _span_scan(kind, qs, gal, 11, impl="torch")
    _assert_scan_close(kind, vals, ids, rv, ri)
    assert ids[:, 0].tolist() == [i * 7 for i in range(8)]


# -- shapes the kernels once refused (C.3, C.4, K10 / K11 head dims, grids) ----

def test_mha_kernel_runs_batches_past_one_grid(dev):
    """B past 65,535 runs as several launches (one call counted)."""
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn((65_540, 5, 32), device=dev,
                               generator=g).to(dtype) for _ in range(3))
        before = mha_short_seq.launches
        out = mha_short_seq(q, k, v, 2)
        torch.cuda.synchronize()
        assert mha_short_seq.launches == before + 1
        ref = mha_short_seq(q, k, v, 2, impl="torch")
        assert float((out.float() - ref.float()).abs().max()) <= tol


def _clear_ids(vals, ids, rv, ri, tol):
    """Values within tol; ids equal where plain's neighbours are > tol
    apart."""
    finite = torch.isfinite(rv)
    assert torch.equal(torch.isfinite(vals), finite)
    assert float((vals[finite] - rv[finite]).abs().max()) <= tol
    gap = torch.full_like(rv, float("inf"))
    diff = (rv[:, :-1] - rv[:, 1:]).abs()
    gap[:, :-1] = diff
    gap[:, 1:] = torch.minimum(gap[:, 1:], diff)
    clear = finite & (gap > tol)
    assert torch.equal(ids[clear], ri[clear])


@pytest.mark.parametrize("d", [100, 520, 2304, 768])
def test_flat_scans_any_dim_match_plain(dev, d):
    """K1 (padded to D % 8) and K4 (codes padded to D % 16) at a D they
    once refused, and past 2048 (a 3- or 5-stage ring): K1 within 1e-5
    and ids where separated, K4 ids and values equal."""
    gal = _unit_rows(5000, d, dev, seed=d)
    qs = _unit_rows(8, d, dev, seed=d + 1)
    for k in (10, 100):
        before = cosine_topk.launches
        vals, ids = cosine_topk(qs, gal, k)
        torch.cuda.synchronize()
        assert cosine_topk.launches == before + 1
        _clear_ids(vals, ids, *cosine_topk(qs, gal, k, impl="torch"), 1e-5)
        packed = quantize_rows(gal.float())
        before = cosine_topk_quantized.launches
        vals, ids = cosine_topk_quantized(qs.float(), *packed, k)
        assert cosine_topk_quantized.launches == before + 1
        rv, ri = cosine_topk_quantized(qs.float(), *packed, k, impl="torch")
        assert torch.equal(ids, ri) and torch.equal(vals, rv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [100, 520, 2304])
def test_first_match_kernel_any_dim_matches_plain(dev, dtype, d):
    x, _ = _planted_rows(1500, d, dev, seed=d)
    got = _k9(x.to(dtype), x.to(dtype), intra=True)
    assert int((got >= 0).sum()) >= 1500 // 40
    _k9(x[:700].to(dtype), x[500:].to(dtype))


@pytest.mark.parametrize("mode", ["", "int8"])
@pytest.mark.parametrize("d", [100, 520])
def test_engine_pads_a_ragged_gallery_once(dev, mode, d):
    """The engine zero-pads a ragged D once, where it places (or
    quantizes) the gallery; its hits equal the CPU engine's."""
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.search.engine import SearchEngine
    rng = np.random.default_rng(d)
    emb = rng.standard_normal((3000, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = GalleryIndex(emb, [f"{i}.jpg" for i in range(3000)],
                       ["a"] * 3000)
    card = SearchEngine(idx, quantize=mode, device=dev)
    cpu = SearchEngine(idx, quantize=mode, device="cpu")
    assert card.gallery.shape[1] == d + -d % (16 if mode else 8)
    queries = emb[:8] + 0.1 * rng.standard_normal((8, d)).astype(np.float32)
    for got, want in zip(card.query_vectors(queries, 10),
                         cpu.query_vectors(queries, 10)):
        assert [h.path for h in got][:3] == [h.path for h in want][:3]
        assert abs(got[0].score - want[0].score) <= 1e-3


def _odd_cache(dev, b, kvh, s, hd, quantized, seed):
    k, ks, v, vs = _kv_cache(dev, 1, b, kvh, s, hd, quantized, seed)
    return k[0], _layer(ks, 0), v[0], _layer(vs, 0)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hd", [100, 288, 500, 576, 1024])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_kv_attention_kernels_ragged_and_wide_heads_match_plain(
        dev, quantized, hd, g):
    """hd % 8 != 0 (q and a copy of the cache zero-padded to 8) and hd past
    256 (K11's 512 instance, G in pieces of 4; past 512 its 1024 instance,
    G in pieces of 2; K10's rows as K11 calls)."""
    s = 704
    cache = _odd_cache(dev, 2, 2, s, hd, quantized, seed=hd + g)
    gen = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn((2, 2, g, hd), device=dev, generator=gen).bfloat16()
    for pos in (s - 1, 100, torch.tensor([s - 1, 37], device=dev)):
        before = decode_attention.launches
        out = decode_attention(q, *cache, pos)
        torch.cuda.synchronize()
        assert decode_attention.launches > before
        _attn_close(out, decode_attention(q, *cache, pos, impl="torch"))
    for c, pos, lim in ((5, s - 5, None), (64, 576, 640)):
        qc = torch.randn((2, 2, g, c, hd), device=dev,
                         generator=gen).bfloat16()
        before = (chunk_attention.launches, decode_attention.launches)
        out = chunk_attention(qc, *cache, pos, kv_limit=lim)
        torch.cuda.synchronize()
        assert (chunk_attention.launches, decode_attention.launches) > before
        _attn_close(out, chunk_attention(qc, *cache, pos, kv_limit=lim,
                                         impl="torch"))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b,kvh", [(65_600, 1), (1, 65_600), (300, 256)])
def test_kv_attention_kernels_grids_past_65535(dev, quantized, b, kvh):
    """B or KVH past 65,535 run as launches over views of the cache."""
    cache = _odd_cache(dev, b, kvh, 8, 64, quantized, seed=7)
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((b, kvh, 2, 64), device=dev, generator=gen).bfloat16()
    pos = torch.randint(0, 8, (b,), device=dev, generator=gen)
    _attn_close(decode_attention(q, *cache, pos),
                decode_attention(q, *cache, pos, impl="torch"))
    qc = torch.randn((b, kvh, 2, 3, 64), device=dev, generator=gen).bfloat16()
    _attn_close(chunk_attention(qc, *cache, 4),
                chunk_attention(qc, *cache, 4, impl="torch"))


def test_taiyi_pair_on_the_card_matches_its_plain_route(dev):
    """The bilingual CN pair end to end on the card (`text_tower:
    taiyi_roberta`, random weights from the seed): image embeddings
    through K3 and K2 at cosine >= 0.999 to the plain route, the text
    tower (plain attention, as the JAX package's) within bf16 of the CPU,
    and K1 over those embeddings = the plain top-k where separated."""
    from mmrs_tpu_torch.config import Config, ModelConfig
    from mmrs_tpu_torch.models import clip
    from mmrs_tpu_torch.pipeline import build_towers

    class Tok:
        def __call__(self, texts):
            ids = np.tile(np.arange(2, 14, dtype=np.int64), (len(texts), 1))
            mask = np.ones_like(ids)
            mask[0, 6:] = 0
            return ids, mask

    cfg = Config(model=ModelConfig(image_tower="vit_tiny",
                                   text_tower="taiyi_roberta"), seed=4)
    card = build_towers(cfg, tokenizer=Tok(), device=dev)
    cpu = build_towers(cfg, tokenizer=Tok(), device="cpu")
    assert isinstance(card.params, clip.TaiyiCLIP)
    px = torch.randint(0, 256, (16, 224, 224, 3), dtype=torch.uint8,
                       device=dev, generator=torch.Generator(
                           device=dev).manual_seed(5))
    before = (mha_short_seq.launches, normalize_images.launches)
    emb = card.encode_fn(px)
    assert mha_short_seq.launches > before[0]
    assert normalize_images.launches > before[1]
    ref = clip.encode_image(card.params, normalize_images(px, impl="torch"),
                            attn_impl="torch", mlp_impl="torch")
    assert float((emb * ref).sum(1).min()) >= 0.999
    texts = ["一张荔枝的图片", "狗"]
    np.testing.assert_allclose(card.text_encode(texts), cpu.text_encode(texts),
                               atol=3e-2)
    q = torch.from_numpy(card.text_encode(texts)).to(dev)
    vals, ids = cosine_topk(q.bfloat16(), emb.bfloat16(), 5)
    _clear_ids(vals, ids, *cosine_topk(q.bfloat16(), emb.bfloat16(), 5,
                                       impl="torch"), 1e-5)


# ---- adaptation and serving on the card --------------------------------------

def test_kernels_refuse_inputs_that_require_grad(dev):
    """K2 (and K6, K10, K11 through the same guard) would return a tensor
    cut from the graph: under grad they raise; under no_grad they run."""
    q = torch.randn((2, 50, 768), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        mha_short_seq(q, q, q, 12)
    with torch.no_grad():
        out = mha_short_seq(q, q, q, 12)
    assert out.grad_fn is None and torch.isfinite(out.float()).all()
    x = torch.randn((4, 64), device=dev, requires_grad=True)
    w = torch.zeros((256, 64), dtype=torch.int8, device=dev)
    s = torch.ones(256, device=dev)
    with pytest.raises(RuntimeError, match="autograd"):
        mlp_int8_fused(x, w, s, s, w.T.contiguous(), s[:64], s[:64])


def test_tip_adapter_f_on_the_card_equals_the_cpu(dev):
    from mmrs_tpu_torch.adapt import tip_adapter as tip

    rng = np.random.default_rng(0)

    def unit(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    protos = unit(8, 512)
    labels = np.repeat(np.arange(8), 4)
    aug = unit(5, 32, 512) + protos[labels][None]
    aug /= np.linalg.norm(aug, axis=-1, keepdims=True)
    test_y = np.repeat(np.arange(8), 8)
    test = protos[test_y] + 0.8 * unit(64, 512)
    test /= np.linalg.norm(test, axis=-1, keepdims=True)
    cw = unit(8, 512).T
    keys, values = tip.build_cache(aug, labels, 8)
    kw = dict(num_classes=8, epochs=20, batch_size=64, alpha=3.0, beta=5.0,
              search_step=(50, 10))
    card = tip.train_tip_adapter_f(aug, labels, test, test_y, keys, values,
                                   cw, device=dev, **kw)
    cpu = tip.train_tip_adapter_f(aug, labels, test, test_y, keys, values,
                                  cw, device="cpu", **kw)
    np.testing.assert_allclose(card.adapter_keys, cpu.adapter_keys,
                               atol=1e-4)
    assert card.history == cpu.history
    np.testing.assert_allclose(card.hp.grid, cpu.hp.grid, atol=1e-6)


def test_streaming_prefetch_equals_the_flat_scan(dev, tmp_path):
    """The upload ring (pinned buffers, a copy stream, events) over
    several chunks and a ragged tail gives K1's answer over the whole
    gallery at every prefetch."""
    from mmrs_tpu_torch.index.stream import streaming_topk

    g = torch.Generator().manual_seed(3)
    rows = torch.randn((70_000, 512), generator=g)
    rows = (rows / rows.norm(dim=1, keepdim=True)).half()
    path = tmp_path / "g.npy"
    np.save(path, rows.numpy())
    mm = np.load(path, mmap_mode="r")
    q = rows[[5, 40_000, 69_999]].float().numpy()
    fv, fi = cosine_topk(torch.from_numpy(q).to(dev).bfloat16(),
                         rows.to(dev).bfloat16(), 10)
    launches = cosine_topk.launches
    for prefetch in (0, 1, 2):
        v, i = streaming_topk(mm, q, k=10, chunk_rows=16_384, device=dev,
                              prefetch=prefetch)
        assert (i[:, 0] == [5, 40_000, 69_999]).all()
        _clear_ids(torch.from_numpy(v), torch.from_numpy(i), fv.cpu(),
                   fi.cpu().long(), 1e-5)
    assert cosine_topk.launches - launches >= 3 * 5   # 5 chunks each


def test_server_answers_over_a_bf16_engine(dev, tmp_path):
    import base64
    import io
    import json
    import threading
    import urllib.request

    from PIL import Image

    from mmrs_tpu_torch.config import Config, ModelConfig
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.search.engine import SearchEngine
    from mmrs_tpu_torch.serve import SearchService, make_server

    cfg = Config(model=ModelConfig(image_tower="vit_tiny"), seed=2)
    towers = build_towers(cfg, device=dev)
    rng = np.random.default_rng(1)
    px = rng.integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    emb = towers.image_encode(px)
    idx = GalleryIndex(emb, [f"p{i}" for i in range(64)], ["c"] * 64)
    engine = SearchEngine(idx, device=dev)
    svc = SearchService(engine, towers, batch_window=0.02)
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(px[7]).save(buf, format="PNG")
        body = json.dumps({"image_b64": base64.b64encode(
            buf.getvalue()).decode(), "k": 5}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/search", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            hits = json.loads(r.read())["hits"][0]
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    # the request was a batch of one: the direct query of the same pixels
    want = engine.query_image(towers.image_encode(px[7:8]), top_k=5)[0]
    assert [(h["path"], h["score"]) for h in hits] == \
        [(h.path, h.score) for h in want]


# -- the operations layer and the int4-weight LLaMA -----------------------------

def test_int4_pack_and_dispatch_on_the_card(dev):
    """quantize_weight_int4 / unpack_int4 on the card give the CPU's bytes
    and values (the scales true divisions, as the JAX package's: CUDA's
    tensor / scalar is a product with the reciprocal), and so does the
    int8 quantizer; the matmul dispatch equals the dequantized bf16
    layer's product exactly (the same weights, the same cuBLAS call)."""
    g = torch.Generator().manual_seed(4)
    w = torch.randn((1024, 768), generator=g) * 0.05
    p_cpu, s_cpu = layers.quantize_weight_int4(w, 128)
    p, s = layers.quantize_weight_int4(w.to(dev), 128)
    assert torch.equal(p.cpu(), p_cpu) and torch.equal(s.cpu(), s_cpu)
    q8, s8 = layers.int8_weight(w.to(dev), 0)
    q8_cpu, s8_cpu = layers.int8_weight(w, 0)
    assert torch.equal(q8.cpu(), q8_cpu) and torch.equal(s8.cpu(), s8_cpu)
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(layers.unpack_int4(p, s, dtype).cpu(),
                           layers.unpack_int4(p_cpu, s_cpu, dtype))
    lin = torch.nn.Linear(1024, 768, bias=False, device=dev)
    lin.weight.data = w.T.contiguous().to(dev)
    q4 = layers.QLinear4.from_linear(lin, 128)
    deq = torch.nn.Linear(1024, 768, bias=False, device=dev,
                          dtype=torch.bfloat16).requires_grad_(False)
    deq.weight.data = q4.dequantize(torch.bfloat16)
    x = torch.randn((8, 1024), device=dev)
    got = layers.matmul(x, q4, torch.bfloat16)
    assert torch.equal(got, layers.matmul(x, deq, torch.bfloat16))


def test_int4_llama_equals_its_dequantized_oracle_on_the_card(dev):
    """A 2-layer int4 LLaMA (head dim 128) decodes through K10 / K11 to
    the tokens of the same model with each QLinear4 as a bf16 layer."""
    import copy

    from mmrs_tpu_torch.models import llama
    from mmrs_tpu_torch.models.quantize import quantize_llama_int4

    cfg = llama.LlamaConfig(vocab_size=512, dim=512, layers=2, heads=4,
                            kv_heads=4, mlp_dim=1024, max_seq=256)
    base = llama.Llama(cfg, torch.Generator(device=dev).manual_seed(1),
                       device=dev).requires_grad_(False)
    lm4 = quantize_llama_int4(base, 128)
    ref = copy.deepcopy(lm4)
    for mod in list(ref.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, layers.QLinear4):
                lin = torch.nn.Linear(1, 1, bias=False, device=dev)
                lin.weight = torch.nn.Parameter(
                    child.dequantize(torch.bfloat16), requires_grad=False)
                setattr(mod, name, lin)
    tokens = torch.randint(3, 512, (4, 70), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    emb = llama.embed_tokens(lm4, tokens)
    c0, d0 = chunk_attention.launches, decode_attention.launches
    got = llama.greedy_generate(lm4, emb, 12, eos_token=-1, prefill_chunk=64)
    assert chunk_attention.launches > c0 and decode_attention.launches > d0
    want = llama.greedy_generate(ref, emb, 12, eos_token=-1,
                                 prefill_chunk=64)
    assert torch.equal(got, want)


def test_rank_gate_on_the_card(dev):
    """K1 over a bf16 gallery against the f32 oracle: no violation, the
    planted queries exact."""
    from mmrs_tpu_torch.eval import parity

    launches = cosine_topk.launches
    r = parity.rank_parity_report(n=50_000, queries=32, device=dev)
    assert cosine_topk.launches > launches
    assert r.violations == 0 and r.planted_exact and r.ok


def test_int8_tower_gate_on_the_card_matches_the_plain_route(dev):
    from mmrs_tpu_torch.eval import parity
    from mmrs_tpu_torch.models import configs
    from mmrs_tpu_torch.models.clip import CLIP, CLIPConfig

    ccfg = CLIPConfig(vision=configs.VIT_TINY, text=configs.CLIP_TEXT_TINY)
    model = CLIP(ccfg, generator=torch.Generator().manual_seed(0)).to(dev)
    model.requires_grad_(False)
    launches = mlp_int8_fused.launches
    got = parity.int8_geometry_gate(model, ccfg)
    assert mlp_int8_fused.launches > launches
    plain = parity.int8_geometry_gate(model, ccfg, impl="torch")
    assert abs(got["min_cosine_vs_f32"] - plain["min_cosine_vs_f32"]) <= 1e-3
    assert got["top1_agreement"] == plain["top1_agreement"]


def test_lifecycle_on_the_card(dev, tmp_path):
    """The seven stages on a small tree at vit_tiny bf16: both
    cross-checks hold, the planted copy is reported as a duplicate at tau
    0.9999 (a random 2-layer tower maps these flat colour fields to
    nearly one direction, so other pairs pass too), and K2, K3 and K9
    launched."""
    import json
    import os
    import shutil

    from PIL import Image

    from mmrs_tpu_torch.config import Config, ModelConfig
    from mmrs_tpu_torch.lifecycle import run_lifecycle

    rng = np.random.default_rng(0)
    root = tmp_path / "tree"
    for c, color in (("lychee", (220, 40, 60)), ("guitar", (150, 100, 40))):
        (root / c).mkdir(parents=True)
        for i in range(12):
            arr = np.clip(np.full((64, 64, 3), color, int)
                          + rng.integers(-60, 60, (64, 64, 3)), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(
                root / c / f"{c}{i:02d}.jpg")
    shutil.copyfile(root / "lychee" / "lychee00.jpg",
                    root / "lychee" / "lychee_dup.jpg")
    before = {fn: fn.launches for fn in (mha_short_seq, normalize_images,
                                         first_match)}
    cfg = Config(model=ModelConfig(image_tower="vit_tiny"), seed=3)
    m = run_lifecycle(str(root), str(tmp_path / "out"), "lychee", cfg=cfg,
                      shots=4, dedup_tau=0.9999, device=dev)
    assert all(fn.launches > n for fn, n in before.items())
    assert all(m["cross_checks"].values()), m["cross_checks"]
    dups = json.load(open(m["dedup"]["report"]))["duplicates"]
    assert "lychee_dup.jpg" in [os.path.basename(d) for d, _ in dups]


def test_engine_out_of_memory_names_the_planner(dev, monkeypatch):
    """A real device out-of-memory error while the gallery is placed is
    raised again pointing at `mmrs-torch plan`."""
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.search import engine as eng

    def too_big(embeddings, dtype, device, chunk=0, align=1):
        return torch.empty((1 << 45,), dtype=dtype, device=device)

    monkeypatch.setattr(eng, "_to_device_chunked", too_big)
    emb = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    idx = GalleryIndex(emb, [f"p{i}" for i in range(8)], ["c"] * 8)
    with pytest.raises(RuntimeError, match="mmrs-torch plan --rows 8"):
        eng.SearchEngine(idx, device=dev)


# -- the data axis (parallel/): shards on one card, and on distinct cards --------

@pytest.fixture
def cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards: a launch on one card while another "
                    "is the current device")
    return [torch.device("cuda", i) for i in range(n)]


def _mesh(devices):
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(data_size=len(devices)), devices)


def _sharded_paths_match(devices, n=70_001, d=512):
    """Flat bf16 / int8 / int4, the slot-sharded IVF and the dedup ring over
    `devices` against the one-device kernels on the first: K4 / K5 / K8
    ids and values equal, K1 / K7 values within 1e-5 and ids where
    separated, K9 every id; each kernel launched once a shard."""
    from mmrs_tpu_torch.parallel import dedup, ivf as pivf, quant4, topk

    mesh = _mesh(devices)
    s = len(devices)
    first = devices[0]
    g = _unit_rows(n, d, first, seed=7)
    q = g[[3, n // 2, n - 1]].float()
    fv, fi = cosine_topk(q.bfloat16(), g, 10)
    before = cosine_topk.launches
    v, i = topk.sharded_cosine_topk(q.bfloat16(), topk.place_gallery(g, mesh),
                                    10, mesh, n_valid=n)
    assert cosine_topk.launches - before == s
    _clear_ids(v.cpu(), i.cpu().long(), fv.cpu(), fi.cpu().long(), 1e-5)
    q8 = topk.place_gallery_quantized(g.float(), mesh)
    v, i = topk.sharded_cosine_topk_quantized(q, *q8, 10, mesh, n_valid=n)
    rv, ri = cosine_topk_quantized(q, *quantize_rows(g.float()), 10)
    assert torch.equal(v.cpu(), rv.cpu()) and torch.equal(i.cpu(), ri.cpu())
    q4 = quant4.place_gallery_int4(g.float(), mesh)
    v, i = quant4.sharded_cosine_topk_int4(q, *q4, 10, mesh, n_valid=n)
    rv, ri = cosine_topk_int4(q, *quantize_rows_int4(g.float()), 10)
    assert torch.equal(v.cpu(), rv.cpu()) and torch.equal(i.cpu(), ri.cpu())
    chunks = lambda: (g[a:a + 8192] for a in range(0, n, 8192))  # noqa: E731
    for mode in ("", "int4"):
        one = build_ivf_streaming(chunks, n, d, n_clusters=64, chunk=8192,
                                  quantize=mode, device=first, seed=1)
        placed = pivf.place_ivf(one, mesh)
        for nprobe in (8, 64):
            rv, ri = ivf_topk(q, one, k=10, nprobe=nprobe)
            v, i = pivf.sharded_ivf_topk(q, placed, k=10, nprobe=nprobe,
                                         mesh=mesh)
            if mode == "int4":
                assert torch.equal(v.cpu(), rv.cpu())
            else:
                assert float((v - rv.to(v.device)).abs().max()) <= 1e-5
    x = g[:9_001].float()
    x[9_000] = x[17]
    x[4_500] = x[8_999]
    want = first_match(x, x, 0.999, intra=True).cpu().long()
    got = dedup.sharded_first_match(x, 0.999, mesh)
    assert torch.equal(got, want) and got[9_000] == 17


def test_sharded_paths_on_one_card_match_one_device(dev):
    """A mesh that repeats one card four times (a one-card
    machine) runs every sharded path shard by shard."""
    _sharded_paths_match([torch.device("cuda", 0)] * 4)


def test_sharded_paths_on_distinct_cards_match_one_device(cards):
    _sharded_paths_match(cards)


def test_probes_on_another_card_than_the_current_one(cards):
    """Every raw launch runs under its tensors' device guard: the bucket
    probes (K7, K8, their ids pass), the scans and K9 on the last card
    while cuda:0 is the current device equal their plain versions."""
    last = cards[-1]
    g = _unit_rows(20_000, 256, last, seed=11)
    q = g[[1, 9_999]].float()
    chunks = lambda: (g[a:a + 4096] for a in range(0, 20_000, 4096))  # noqa
    with torch.cuda.device(cards[0]):
        assert torch.cuda.current_device() == 0
        for mode in ("", "int8", "int4"):
            ivf = build_ivf_streaming(chunks, 20_000, 256, n_clusters=32,
                                      chunk=4096, quantize=mode, device=last,
                                      seed=2)
            v, i = ivf_topk(q, ivf, k=10, nprobe=8)
            rv, ri = ivf_topk(q, ivf, k=10, nprobe=8, impl="torch")
            assert v.device == last
            assert float((v - rv).abs().max()) <= 1e-5
            if mode == "int4":
                assert torch.equal(v, rv) and torch.equal(i, ri)
        v, i = cosine_topk(q.bfloat16(), g, 10)
        rv, ri = cosine_topk(q.bfloat16(), g, 10, impl="torch")
        _clear_ids(v, i.long(), rv, ri.long(), 1e-5)
        x = g[:3000].float()
        x[2999] = x[5]
        assert torch.equal(first_match(x, x, 0.999, intra=True),
                           first_match(x, x, 0.999, intra=True,
                                       impl="torch"))
        torch.cuda.synchronize(last)


def test_gallery_shards_past_the_card_count_exits_2(dev, tmp_path, capsys,
                                                   monkeypatch):
    from mmrs_tpu_torch.cli.main import main
    from mmrs_tpu_torch.index.gallery import _write_manifest, _write_shard

    monkeypatch.delenv("MMRS_TORCH_DEVICE", raising=False)
    emb = np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32)
    entry = _write_shard(str(tmp_path), 0, emb, [(f"p{i}.jpg", "c")
                                                 for i in range(8)])
    _write_manifest(str(tmp_path), [entry], 16)
    n = torch.cuda.device_count()
    for argv in (["search", "--index", str(tmp_path), "--text", "x"],
                 ["dedup", "--mode", "embedding", "--index",
                  str(tmp_path)]):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--gallery-shards", str(n + 1)])
        assert e.value.code == 2
        assert (f"--gallery-shards {n + 1} needs {n + 1} local devices; "
                f"{n} available") in capsys.readouterr().err


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_on_a_repeated_card_equals_one_device(dev, tp):
    """The model axis on `cuda:0` repeated (parallel/vlm.py): int8 weights
    with the int8 KV cache decode through each shard's K10 / K11 to
    logits and tokens bit-equal to one device's (K11 planned for the
    whole model's pairs); bf16 TP tokens stay within the prefill's
    rounding of one device's logits."""
    import copy

    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.models import llama
    from mmrs_tpu_torch.models.quantize import quantize_llama
    from mmrs_tpu_torch.parallel import vlm
    from mmrs_tpu_torch.parallel.mesh import make_mesh

    cfg = llama.LlamaConfig(vocab_size=512, dim=512, layers=2, heads=4,
                            kv_heads=4, mlp_dim=1024, max_seq=256)
    base = llama.Llama(cfg, torch.Generator(device=dev).manual_seed(3),
                       device=dev, dtype=torch.bfloat16
                       ).requires_grad_(False)
    mesh = make_mesh(MeshConfig(data_size=1, model_size=tp),
                     [torch.device("cuda", 0)] * tp)
    tokens = torch.randint(3, 512, (8, 70), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))
    emb = llama.embed_tokens(base, tokens)
    sh = vlm.shard_llama_params(base, mesh).rows[0]
    one, _ = llama.prefill(base, emb, 128, prefill_chunk=64)
    got, _ = llama.prefill(sh, emb, 128, prefill_chunk=64)
    assert float((got - one).abs().max()) < 0.1
    q = quantize_llama(copy.deepcopy(base))
    qsh = vlm.shard_llama_params(q, mesh).rows[0]
    c0, d0 = chunk_attention.launches, decode_attention.launches
    one, _ = llama.prefill(q, emb, 128, torch.bfloat16, torch.int8, 64)
    got, _ = llama.prefill(qsh, emb, 128, torch.bfloat16, torch.int8, 64)
    assert torch.equal(got, one)
    want = llama.greedy_generate(q, emb, 12, -1, kv_dtype=torch.int8,
                                 prefill_chunk=64)
    out = llama.greedy_generate(qsh, emb, 12, -1, kv_dtype=torch.int8,
                                prefill_chunk=64)
    assert torch.equal(out, want)
    assert chunk_attention.launches > c0 and decode_attention.launches > d0


def test_tp_flag_past_the_card_count_exits_2(dev, capsys, monkeypatch):
    """`--tp` with more cards than the machine has exits 2 naming the
    count, before the (missing) checkpoint is read."""
    from mmrs_tpu_torch.cli.main import _make_verifier, build_parser

    monkeypatch.delenv("MMRS_TORCH_DEVICE", raising=False)
    n = torch.cuda.device_count()
    args = build_parser().parse_args([
        "cascade", "--root", "r", "--positive-class", "c", "--class-embed",
        "e.npy", "--threshold", "0", "--verifier", "llava",
        "--llava-checkpoint", "missing.npz", "--tokenizer-model",
        "missing.model", "--tp", f"2x{2 * n}"])
    assert _make_verifier(args) == 2
    assert (f"--tp 2x{2 * n} needs {4 * n} local devices; {n} available"
            in capsys.readouterr().err)


# ---- the float dense layer's epilogue -----------------------------------------

def _epilogue_sums(m, n, dev, seed):
    """f32 GEMM sums with the values the epilogue must round as PyTorch
    does: exact zeros, negative zeros, bf16 rounding ties, values past
    QuickGELU's exp overflow (|1.702 y| > 88) and subnormal sums."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((m, n), device=dev, generator=g) * 3.0
    flat = y.view(-1)
    flat[::101] = 0.0
    flat[7::103] = -0.0
    flat[3::107] = 1.0 + 2.0 ** -8          # halfway between two bf16
    flat[5::109] = -(1.0 + 3 * 2.0 ** -8)
    flat[11::113] = -60.0
    flat[13::127] = 60.0
    flat[17::131] = 1e-39
    return y


def _epilogue_bias(n, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(n, device=dev, generator=g)


@pytest.mark.parametrize("m,n", [
    (12800, 768), (12800, 3072),      # ViT-B/32: 256 images x 50 tokens
    (65792, 1024), (65792, 4096),     # ViT-L/14: 256 images x 257 tokens
    (1, 8), (4 * 257 + 3, 1024),      # one row; ragged rows
    (1000, 8 * 97),                   # a column count no stride divides
])
@pytest.mark.parametrize("act", [None, "quick_gelu", "gelu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_dense_epilogue_kernel_matches_plain(dev, m, n, act, with_bias):
    """The kernel equals the plain ops (torch.add(out=bf16), then
    quick_gelu's sigmoid chain or F.gelu in f32) bit for bit."""
    y = _epilogue_sums(m, n, dev, seed=m + n)
    b = _epilogue_bias(n, dev, seed=n) if with_bias else None
    before = bias_act.launches
    out = bias_act(y, b, act, torch.bfloat16)
    assert bias_act.launches == before + 1
    ref = bias_act(y, b, act, torch.bfloat16, impl="torch")
    diff = out.view(torch.int16) != ref.view(torch.int16)
    assert not bool(diff.any()), (
        f"{int(diff.sum())} of {diff.numel()} elements differ, first at "
        f"{diff.nonzero()[0].tolist()}")


def test_dense_epilogue_kernel_rejects_what_it_cannot_run(dev):
    y = torch.randn((4, 32), device=dev)
    b = torch.randn(32, device=dev)
    with pytest.raises(ValueError, match="N % 8"):
        bias_act(torch.randn((4, 12), device=dev), None, None,
                 torch.bfloat16)
    with pytest.raises(ValueError, match="f32 sums"):
        bias_act(y.bfloat16(), b, None, torch.bfloat16)
    with pytest.raises(ValueError, match="f32 sums"):
        bias_act(y, b, None, torch.float32)
    with pytest.raises(ValueError, match="f32 bias"):
        bias_act(y, b.bfloat16(), None, torch.bfloat16)
    with pytest.raises(ValueError, match="f32 bias"):
        bias_act(y, b[:16], None, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        bias_act(torch.randn((4, 64), device=dev)[:, :32], b, None,
                 torch.bfloat16)
    with pytest.raises(ValueError, match="inputs on"):
        bias_act(y, b.cpu(), None, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        _bias_act_cuda(y.cpu(), None, None, torch.bfloat16)
    with pytest.raises(ValueError, match="activation"):
        bias_act(y, b, "relu", torch.bfloat16)
    with pytest.raises(RuntimeError, match="autograd"):
        bias_act(y.requires_grad_(True), b, None, torch.bfloat16)
    assert bias_act(torch.empty((0, 32), device=dev), b, "gelu",
                    torch.bfloat16).shape == (0, 32)


def test_dense_on_the_card_takes_the_epilogue_kernel(dev):
    """A bf16 inference dense launches the kernel once (with its MLP's
    activation); `impl="torch"`, an f32 one and a training call keep the
    plain ops, with the kernel's bits; a ragged width raises."""
    from torch import nn

    lin = nn.Linear(64, 256).to(dev).requires_grad_(False)
    x = torch.randn((3, 50, 64), device=dev).bfloat16()
    before = bias_act.launches
    with torch.no_grad():
        got = layers.dense(x, lin, torch.bfloat16, act=layers.quick_gelu)
    assert bias_act.launches == before + 1
    y = torch.mm(x.reshape(-1, 64), lin.weight.bfloat16().T,
                 out_dtype=torch.float32)
    want = bias_act(y, lin.bias, "quick_gelu", torch.bfloat16, impl="torch")
    assert torch.equal(got.reshape(-1, 256).view(torch.int16),
                       want.view(torch.int16))
    with torch.no_grad():
        plain = layers.dense(x, lin, torch.bfloat16, act=layers.quick_gelu,
                             impl="torch")
    assert torch.equal(plain.view(torch.int16), got.view(torch.int16))
    layers.dense(x, lin, torch.float32)
    with pytest.raises(ValueError, match="N % 8"):
        layers.dense(x, nn.Linear(64, 36).to(dev).requires_grad_(False),
                     torch.bfloat16)
    lin.requires_grad_(True)
    layers.dense(x, lin, torch.bfloat16, act=layers.gelu).float().sum(
        ).backward()
    assert bias_act.launches == before + 1 and lin.bias.grad is not None


@pytest.mark.parametrize("name,layers_n", [("vit_b32", 12), ("vit_l14", 24)])
def test_image_tower_launches_the_epilogue_per_dense(dev, name, layers_n):
    """Six denses a block (wq, wk, wv, wo, w1 with its QuickGELU, w2) and
    the bias-free patch embedding: one launch each, no more; the plain
    tower (attn_impl = mlp_impl = "torch") launches none."""
    from mmrs_tpu_torch.models import vit
    from mmrs_tpu_torch.models.configs import IMAGE_TOWERS

    cfg = IMAGE_TOWERS[name]
    assert cfg.layers == layers_n
    model = vit.VisionTransformer(cfg, torch.Generator().manual_seed(0))
    model = model.to(dev).eval().requires_grad_(False)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.data = m.weight.data.bfloat16()
    images = torch.randn((2, 224, 224, 3), device=dev).bfloat16()
    before = bias_act.launches
    with torch.inference_mode():
        out = model(images)
    assert bias_act.launches - before == 6 * layers_n + 1
    assert torch.isfinite(out).all()
    before = bias_act.launches
    with torch.inference_mode():
        model(images, attn_impl="torch", mlp_impl="torch")
    assert bias_act.launches == before
