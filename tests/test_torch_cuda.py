"""The port's GPU kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. On the GPU
machine (which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes include the edges the kernels handle in their own code: ragged
gallery chunks, N < k, multi-level top-k merges, k = 256, ties, query tiles
over T, ragged row tiles of the int8 MLP, f32 inputs. The int8 and int4
scans must equal their plain versions exactly (ids and values), and so must
the fused int8 MLP (nonzero biases, rows of exact rounding ties).
"""

import pytest
import torch

from mmrs_tpu_torch.models import layers
from mmrs_tpu_torch.ops.attention import mha_short_seq
from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused
from mmrs_tpu_torch.ops.preprocess import normalize_images
from mmrs_tpu_torch.ops.quant import cosine_topk_quantized, quantize_rows
from mmrs_tpu_torch.ops.quant4 import cosine_topk_int4, quantize_rows_int4
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
