"""The port's GPU kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. On the GPU
machine (which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes include the edges the kernels handle in their own code: ragged
gallery chunks, N < k, multi-level top-k merges, k = 256, ties, query tiles
over T, ragged row tiles of the int8 MLP, f32 inputs, masked bucket slots
and equal scores across probed buckets. The int8 and int4 scans and the
int4 bucket probe must equal their plain versions exactly (ids and values),
and so must the fused int8 MLP (nonzero biases, rows of exact rounding
ties) and the all-pairs first match (every id, f32 and bf16 inputs).
"""

import pytest
import torch

from mmrs_tpu_torch.index.ivf import (build_ivf_streaming, ivf_topk,
                                      probe_buckets, probe_buckets_q4)
from mmrs_tpu_torch.models import layers
from mmrs_tpu_torch.ops.allpairs import first_match
from mmrs_tpu_torch.ops.attention import mha_short_seq
from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused
from mmrs_tpu_torch.ops.preprocess import normalize_images
from mmrs_tpu_torch.ops.quant import cosine_topk_quantized, quantize_rows
from mmrs_tpu_torch.ops.quant4 import (cosine_topk_int4, prep_queries,
                                       quantize_rows_int4)
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
    with pytest.raises(ValueError, match="k <= 256"):
        cosine_topk(gal[:1], gal, 257)
    with pytest.raises(ValueError, match="bf16"):
        cosine_topk(gal[:1].float(), gal.float(), 5)
    with pytest.raises(ValueError, match="D % 8"):
        cosine_topk(gal[:1, :60].contiguous(), gal[:, :60].contiguous(), 5)


@pytest.mark.parametrize("b,t,w,heads,dtype,tol", [
    (2, 50, 768, 12, torch.bfloat16, 2e-2),     # ViT-B/32
    (3, 257, 1024, 16, torch.bfloat16, 2e-2),   # ViT-L/14: 9 query tiles
    (1, 577, 1024, 16, torch.bfloat16, 2e-2),   # 336-px L/14
    (2, 7, 96, 3, torch.float32, 1e-5),         # odd T and heads
    (2, 65, 128, 2, torch.float32, 1e-5),       # T just over one tile
    (1, 257, 1024, 16, torch.float32, 1e-5),
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
        with pytest.raises(ValueError, match="k <= 256"):
            fn(gal[:1], *packed, 257)
    odd = _unit_rows(10, 24, dev, seed=1).float()       # D % 16 != 0
    with pytest.raises(ValueError, match="D % 16"):
        cosine_topk_quantized(odd[:1], *quantize_rows(odd), 3)
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


def test_probe_kernels_reject_what_they_cannot_run(dev):
    rows, ivf = _probe_index(1000, 64, 4, "", dev, seed=0)
    probe = _probe_lists(1, 4, 2, dev, seed=0)
    with pytest.raises(ValueError, match="k <= 256"):
        _probe(ivf, rows[:1], probe, 257)
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


def test_first_match_kernel_rejects_what_it_cannot_run(dev):
    x = torch.randn((10, 12), device=dev)
    with pytest.raises(ValueError, match="D % 8"):
        first_match(x, x, 0.5)
    with pytest.raises(ValueError, match="one dtype"):
        first_match(x[:, :8].contiguous(), x[:, :8].bfloat16(), 0.5)
    cpu = torch.randn((10, 16))
    with pytest.raises(ValueError, match="CUDA"):
        first_match(cpu, cpu, 0.5, impl="cuda")
