"""The float dense layer's epilogue (ops/dense_epilogue.bias_act) on the CPU.

`bias_act`'s plain version must be the ops `layers.dense` and the
activations ran before the epilogue had a kernel, bit for bit; `dense(...,
act=)` must equal `act(dense(...))`; the routes that keep the plain ops
(`impl="torch"`, autograd recording, f32 results, `QLinear`, the
tensor-parallel row sums) must not reach the kernel's route; `MLP.inner`
and `Block.forward` must give the bits they gave with the old `dense`;
and the launch plan must give every 8-column group of every row to
exactly one thread, which keeps one column group. The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py).
"""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.models import layers
from mmrs_tpu_torch.ops import dense_epilogue
from mmrs_tpu_torch.ops.dense_epilogue import (THREADS, _bias_act_cuda,
                                               act_name, bias_act,
                                               bias_act_plan)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


# -- the ops the layers ran before the epilogue kernel ------------------------

def _old_quick_gelu(x):
    return x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


def _old_gelu(x):
    return F.gelu(x.float()).to(x.dtype)


def _old_dense(x, layer, compute_dtype, impl="auto"):
    # `impl` (added with the epilogue) is taken and unused
    if isinstance(layer, layers.QLinear):
        xq, sx = layers.quantize_act(x)
        return layers.int8_linear(xq, sx, layer.q, layer.s, layer.bias,
                                  compute_dtype)
    x = x.to(compute_dtype)
    y = layers._mm_f32(x.reshape(-1, x.shape[-1]),
                       layer.weight.to(compute_dtype))
    y = y.reshape(*x.shape[:-1], -1)
    if layer.bias is None:
        return y.to(compute_dtype)
    if torch.is_grad_enabled() and (y.requires_grad
                                    or layer.bias.requires_grad):
        return (y + layer.bias.float()).to(compute_dtype)
    return torch.add(y, layer.bias.float(),
                     out=torch.empty_like(y, dtype=compute_dtype))


def _old_inner(self, x, compute_dtype, impl="auto"):
    return self.act(_old_dense(x, self.w1, compute_dtype))


_OLD_ACTS = {None: lambda y: y, "quick_gelu": _old_quick_gelu,
             "gelu": _old_gelu}


def _sums(m, n, seed, scale=4.0):
    """f32 sums of the size a dense layer's GEMM gives, with exact zeros,
    negative zeros and rounding ties among them."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn((m, n), generator=g) * scale
    flat = y.view(-1)
    flat[::11] = 0.0
    flat[5::13] = -0.0
    # halfway between two bf16 values: the rounding's ties
    flat[3::17] = torch.tensor(1.0 + 2.0 ** -8).float()
    return y


def _linear(n_in, n_out, bias, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    lin = nn.Linear(n_in, n_out, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((n_out, n_in), generator=g) * 0.3)
        if bias:
            lin.bias.copy_(torch.randn(n_out, generator=g))
    lin.weight.data = lin.weight.data.to(dtype)
    return lin.requires_grad_(False)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# -- the plain version is the old ops --------------------------------------------

@pytest.mark.parametrize("m", [1, 17, 130])
@pytest.mark.parametrize("act", [None, "quick_gelu", "gelu"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_route_is_the_old_dense_and_activation(m, act, with_bias):
    y = _sums(m, 48, seed=m)
    b = torch.randn(48, generator=torch.Generator().manual_seed(7)) \
        if with_bias else None
    old = (torch.add(y, b, out=torch.empty_like(y, dtype=torch.bfloat16))
           if with_bias else y.to(torch.bfloat16))
    want = _OLD_ACTS[act](old)
    for impl in ("torch", "auto"):
        got = bias_act(y, b, act, torch.bfloat16, impl=impl)
        assert got.dtype == torch.bfloat16 and got.shape == y.shape
        assert torch.equal(_bits(got), _bits(want)), (impl, act)


@pytest.mark.parametrize("act", [None, "quick_gelu", "gelu"])
def test_plain_route_in_f32_is_the_old_ops(act):
    y = _sums(9, 24, seed=3)
    b = torch.randn(24, generator=torch.Generator().manual_seed(4))
    want = _OLD_ACTS[act](torch.add(y, b, out=torch.empty_like(y)))
    assert torch.equal(bias_act(y, b, act, torch.float32), want)


def test_plain_route_records_autograd_as_the_old_dense():
    y = _sums(5, 16, seed=2).requires_grad_(True)
    b = torch.randn(16, requires_grad=True)
    out = bias_act(y, b, "quick_gelu", torch.bfloat16)
    want = _old_quick_gelu((y + b).to(torch.bfloat16))
    assert torch.equal(_bits(out), _bits(want))
    out.float().sum().backward()
    assert y.grad is not None and b.grad is not None
    assert torch.isfinite(b.grad).all() and b.grad.abs().sum() > 0


# -- dense(..., act=) ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("act", [layers.quick_gelu, layers.gelu])
def test_dense_with_act_equals_act_of_dense(dtype, with_bias, act):
    lin = _linear(40, 64, with_bias, seed=1, dtype=dtype)
    x = torch.randn((3, 7, 40), generator=torch.Generator().manual_seed(2))
    got = layers.dense(x, lin, dtype, act=act)
    want = act(layers.dense(x, lin, dtype))
    assert got.shape == (3, 7, 64) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))
    old = _OLD_ACTS[act.__name__](_old_dense(x, lin, dtype))
    assert torch.equal(_bits(got), _bits(old))


# -- which route a call takes ------------------------------------------------------

@pytest.fixture
def routes(monkeypatch):
    """Every bias_act call `dense` makes, as (act, impl)."""
    seen = []

    def spy(y32, bias, act, out_dtype, impl="auto"):
        seen.append((act, impl))
        return bias_act(y32, bias, act, out_dtype, impl=impl)

    monkeypatch.setattr(layers, "bias_act", spy)
    return seen


def test_inference_bf16_takes_the_kernel_route(routes):
    lin = _linear(32, 64, True, seed=1)
    x = torch.randn((5, 32), generator=torch.Generator().manual_seed(1))
    layers.dense(x, lin, torch.bfloat16, act=layers.quick_gelu)
    layers.dense(x, _linear(32, 64, False, seed=2), torch.bfloat16)
    assert routes == [("quick_gelu", "auto"), (None, "auto")]


def test_a_training_step_keeps_the_differentiable_route(routes):
    lin = _linear(32, 64, True, seed=1).requires_grad_(True)
    x = torch.randn((5, 32), generator=torch.Generator().manual_seed(1))
    out = layers.dense(x, lin, torch.bfloat16, act=layers.gelu)
    assert routes == [("gelu", "torch")]
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert lin.bias.grad is not None and lin.weight.grad is not None
    with torch.no_grad():
        layers.dense(x, lin, torch.bfloat16, act=layers.gelu)
    assert routes[-1] == ("gelu", "auto")


@pytest.mark.parametrize("dtype,n_out,impl", [
    (torch.float32, 64, "torch"),
    # a ragged width takes the kernel's route too: the kernel refuses it
    # on the card (tests/test_torch_cuda.py), the CPU runs the plain ops
    (torch.bfloat16, 36, "auto"),
])
def test_f32_results_and_ragged_widths_route(routes, dtype, n_out, impl):
    lin = _linear(32, n_out, True, seed=3, dtype=dtype)
    x = torch.randn((5, 32), generator=torch.Generator().manual_seed(1))
    got = layers.dense(x, lin, dtype, act=layers.quick_gelu)
    assert routes == [("quick_gelu", impl)]
    want = _old_quick_gelu(_old_dense(x, lin, dtype))
    assert torch.equal(_bits(got), _bits(want))


def test_impl_torch_takes_the_plain_route(routes):
    lin = _linear(32, 64, True, seed=1)
    x = torch.randn((5, 32), generator=torch.Generator().manual_seed(1))
    got = layers.dense(x, lin, torch.bfloat16, act=layers.quick_gelu,
                       impl="torch")
    assert routes == [("quick_gelu", "torch")]
    want = _old_quick_gelu(_old_dense(x, lin, torch.bfloat16))
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_block_denses_follow_their_impl(routes, impl):
    """wq, wk, wv, wo, w1 (with its activation) and w2 all take the
    block's one `impl`."""
    blk = _block(layers.quick_gelu, torch.bfloat16, seed=5)
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16)
    blk(x, None, torch.bfloat16, impl=impl)
    assert routes == [(None, impl)] * 4 + [("quick_gelu", impl),
                                           (None, impl)]


def test_the_plain_image_tower_runs_no_epilogue_kernel(routes):
    """With impl="torch" every dense of the ViT, the patch embedding's
    too, takes the plain ops."""
    from mmrs_tpu_torch.models import vit
    from mmrs_tpu_torch.models.configs import VITConfig

    cfg = VITConfig(image_size=32, patch_size=16, width=64, layers=2,
                    heads=4, embed_dim=32)
    model = vit.VisionTransformer(cfg, torch.Generator().manual_seed(0))
    model = model.eval().requires_grad_(False)
    images = torch.randn((2, 32, 32, 3),
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        plain = model(images, impl="torch")
    assert len(routes) == 6 * cfg.layers + 1
    assert set(impl for _, impl in routes) == {"torch"}
    routes.clear()
    with torch.inference_mode():
        auto = model(images)
    assert set(impl for _, impl in routes) == {"auto"}
    assert torch.equal(plain, auto)


def test_act_name_is_the_one_map_of_activations():
    assert act_name(None) is None
    assert act_name(layers.quick_gelu) == "quick_gelu"
    assert act_name(layers.gelu) == "gelu"
    assert dense_epilogue.ACTIVATIONS["quick_gelu"] is layers.quick_gelu
    with pytest.raises(ValueError, match="activation"):
        act_name(F.gelu)
    mlp = layers.MLP(16, 32, torch.tanh)
    with pytest.raises(ValueError, match="activation"):
        mlp.inner(torch.randn((2, 16)), torch.bfloat16)


def test_a_qlinear_never_reaches_the_epilogue(routes):
    q = layers.QLinear.from_linear(_linear(32, 64, True, seed=4,
                                           dtype=torch.float32))
    x = torch.randn((5, 32), generator=torch.Generator().manual_seed(1))
    got = layers.dense(x, q, torch.bfloat16, act=layers.quick_gelu)
    assert routes == []
    want = _old_quick_gelu(_old_dense(x, q, torch.bfloat16))
    assert torch.equal(_bits(got), _bits(want))


def test_tensor_parallel_row_sums_keep_their_own_bias_add(routes):
    blk = _block(layers.quick_gelu, torch.bfloat16, seed=9)
    pieces = _pieces(blk, 2)
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(3)
                    ).to(torch.bfloat16)
    blk(x, None, torch.bfloat16, pieces=pieces, devices=["cpu", "cpu"])
    # the pieces' column products (wq, wk, wv, w1 with its activation)
    # take the epilogue; wo and w2 are row sums with the block's bias
    assert Counter(routes) == {(None, "auto"): 6, ("quick_gelu", "auto"): 2}


def test_the_kernel_wrapper_refuses_cpu_tensors():
    y = _sums(4, 16, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        _bias_act_cuda(y, None, None, torch.bfloat16)
    with pytest.raises(ValueError, match="impl"):
        bias_act(y, None, None, torch.bfloat16, impl="cuda")


# -- the modules that call dense ----------------------------------------------------

def _block(act, dtype, seed, width=64, heads=4):
    g = torch.Generator().manual_seed(seed)
    blk = layers.Block(width, heads, act)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    for m in blk.modules():
        if isinstance(m, nn.Linear):
            m.weight.data = m.weight.data.to(dtype)
    return blk.requires_grad_(False)


def _pieces(blk, tp):
    """The block's model-axis pieces, as the DP x TP contrastive step
    splits them."""
    from mmrs_tpu_torch.adapt.contrastive import _piece
    return [_piece(blk, tp, p, torch.device("cpu")).requires_grad_(False)
            for p in range(tp)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [layers.quick_gelu, layers.gelu])
def test_mlp_inner_and_block_forward_are_unchanged(monkeypatch, dtype, act):
    blk = _block(act, dtype, seed=11)
    x = torch.randn((2, 9, 64), generator=torch.Generator().manual_seed(12)
                    ).to(dtype)
    h = blk.ln2(x)
    inner = blk.mlp.inner(h, dtype)
    fwd = blk(x, None, dtype, impl="torch")
    mask = torch.triu(torch.full((9, 9), float("-inf")), 1)
    fwd_masked = blk(x, mask, dtype)
    monkeypatch.setattr(layers, "dense", _old_dense)
    monkeypatch.setattr(layers.MLP, "inner", _old_inner)
    assert torch.equal(_bits(inner), _bits(blk.mlp.inner(h, dtype)))
    assert torch.equal(_bits(fwd), _bits(blk(x, None, dtype,
                                             impl="torch")))
    assert torch.equal(_bits(fwd_masked), _bits(blk(x, mask, dtype)))


# -- the launch plan ---------------------------------------------------------------

@pytest.mark.parametrize("m,n", [
    (12800, 768), (12800, 3072),         # ViT-B/32: 256 images x 50 tokens
    (65792, 1024), (65792, 4096),        # ViT-L/14: 256 images x 257 tokens
    (1, 8), (3, 40), (77, 512), (5, 8 * 4097), (33, 8 * 96 * 7),
])
def test_plan_gives_each_thread_one_column_group(m, n):
    groups = n // 8
    for slots in (1, 132 * 8, 132 * 6):
        blocks = bias_act_plan(m, n, slots)
        threads = blocks * THREADS
        assert blocks >= 1 and threads % groups == 0
        # at most one wave, unless one stride of whole rows needs more
        unit = groups // np.gcd(groups, THREADS)
        assert blocks <= max(-(-min(slots, -(-m * groups // THREADS))
                                // unit) * unit, unit)


@pytest.mark.parametrize("m,n,slots", [(7, 24, 1), (300, 768, 5),
                                       (1, 8, 132), (40, 8 * 33, 3)])
def test_plan_covers_every_group_once(m, n, slots):
    """The kernel's indexing in numpy: thread g takes vectors g, g + T,
    ... below m * n / 8, and keeps the column group g % (n / 8)."""
    groups = n // 8
    threads = bias_act_plan(m, n, slots) * THREADS
    hits = np.zeros(m * groups, np.int64)
    for g in range(threads):
        v = np.arange(g, m * groups, threads)
        hits[v] += 1
        assert (v % groups == g % groups).all()
    assert (hits == 1).all()


def test_launch_counter_starts_at_zero_on_the_cpu():
    before = dense_epilogue.bias_act.launches
    bias_act(_sums(3, 16, seed=1), None, "gelu", torch.bfloat16)
    assert dense_epilogue.bias_act.launches == before
