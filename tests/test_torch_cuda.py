"""The port's GPU kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. On the GPU
machine (which has no JAX, so the JAX conftest is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes include the edges the kernels handle in their own code: ragged
gallery chunks, N < k, multi-level top-k merges, k = 256, query tiles
over T, f32 inputs.
"""

import pytest
import torch

from mmrs_tpu_torch.ops.attention import mha_short_seq
from mmrs_tpu_torch.ops.preprocess import normalize_images
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
