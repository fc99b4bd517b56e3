"""The towers' LayerNorm (ops/layer_norm, kernel E2) on the CPU.

The plain version must agree with the JAX package's `layer_norm` (f32
statistics, one rounding) at every preset width and both eps, with outlier
gains and rows far from zero mean, and must be the ops the layer ran
before E2, bit for bit. The kernel's route is taken only by bf16 CUDA rows
outside autograd with `impl="auto"`: the CPU, f32 rows, a recording
autograd and `impl="torch"` keep the plain ops and leave the launch count
alone, and a tower built with `impl="torch"` never reaches the
kernel's branch. The launch plan and the kernel's indexing (one warp a
row, one lane a 16-byte vector) are modelled in numpy; the benchmark's
`e2_roofline.index` reader counts the launches one batch makes. The kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmrs_tpu.models.layers import layer_norm as jax_layer_norm
from mmrs_tpu_torch.models import layers, vit
from mmrs_tpu_torch.models.configs import (SIGLIP_TINY, VIT_TINY, TAIYI_TINY,
                                           CLIP_TEXT_TINY)
from mmrs_tpu_torch.ops import layer_norm as ln_mod
from mmrs_tpu_torch.ops.layer_norm import (MAX_WIDTH, THREADS, WARPS,
                                           _layer_norm_cuda, _rows_view,
                                           layer_norm, layer_norm_plan,
                                           takes_kernel)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from benchmark import devtrace, roofline  # noqa: E402
from benchmark import run as bench_run  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import layer_norm_cases as ln_cases  # noqa: E402

torch.set_num_threads(2)

# every LayerNorm width of models/configs.py's presets
WIDTHS = (128, 144, 512, 768, 1024, 1152)
EPS = (1e-5, 1e-6)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _jax(x, g, b, eps):
    y = jax_layer_norm(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                       jnp.asarray(g.numpy()), jnp.asarray(b.numpy()), eps)
    return torch.from_numpy(np.array(y.astype(jnp.float32))).to(BF16)


# -- the plain version ---------------------------------------------------------

@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_route_matches_the_jax_layer_norm(w, eps):
    x = ln_cases.rows(96, w, seed=w)
    g, b = ln_cases.params(w, seed=w + 1)
    got = layer_norm(x, g, b, eps)
    want = _jax(x, g, b, eps)
    assert got.dtype == BF16 and got.shape == x.shape
    assert ln_cases.ulps(got, want, g) <= 1.0
    # most elements round the same f32 value
    assert float((got != want).float().mean()) < 0.01


@pytest.mark.parametrize("params", [torch.float32, BF16])
@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("w", WIDTHS)
def test_plain_route_is_the_old_ops(w, eps, params):
    """The plain route and the module give the bits of the three ops the
    layer ran before E2, with f32 gains and offsets (the towers) or bf16
    ones (LLaVA's tower, cast whole)."""
    x = ln_cases.rows(40, w, seed=3 * w).reshape(4, 10, w)
    g, b = (p.to(params) for p in ln_cases.params(w, seed=w))
    old = F.layer_norm(x.float(), (w,), g.float(), b.float(), eps).to(BF16)
    mod = layers.LayerNorm(w, eps).to(params).requires_grad_(False)
    with torch.no_grad():
        mod.weight.copy_(g)
        mod.bias.copy_(b)
    for got in (layer_norm(x, g, b, eps, impl="torch"),
                layer_norm(x, g, b, eps), mod(x), mod(x, "torch")):
        assert torch.equal(got.view(torch.int16), old.view(torch.int16))


def test_f32_rows_stay_f32():
    x = ln_cases.rows(12, 144, seed=5).float()
    g, b = ln_cases.params(144, seed=6)
    got = layer_norm(x, g, b, 1e-6)
    assert got.dtype == torch.float32
    assert torch.equal(got, F.layer_norm(x, (144,), g, b, 1e-6))


@pytest.mark.parametrize("w", WIDTHS)
def test_strided_cls_rows(w):
    """CLIP's ln_post takes x[:, 0, :]: the kernel reads those rows in
    place at the row stride T * W; a view off the 16-byte grid is copied.
    The plain route gives the contiguous rows' bits."""
    x = ln_cases.rows(6 * 7, w, seed=w).reshape(6, 7, w)
    cls = x[:, 0, :]
    rows = _rows_view(cls)
    assert rows.data_ptr() == x.data_ptr() and rows.stride() == (7 * w, 1)
    g, b = ln_cases.params(w, seed=2)
    assert torch.equal(layer_norm(cls, g, b, 1e-5),
                       layer_norm(cls.contiguous(), g, b, 1e-5))
    off = x.reshape(-1)[4:4 + 5 * w].view(5, w)     # 8 bytes off the grid
    copy = _rows_view(off)
    assert copy.data_ptr() % 16 == 0 and copy.is_contiguous()
    assert torch.equal(copy, off)
    assert _rows_view(x).data_ptr() == x.data_ptr()


# -- which route a call takes --------------------------------------------------

def _like(device="cuda", dtype=BF16, requires_grad=False):
    """What the dispatch rule reads of a tensor (there is no CUDA tensor on
    the CPU)."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           requires_grad=requires_grad)


@pytest.mark.parametrize("x,params_grad,impl,grad_mode,want", [
    (_like(), False, "auto", True, True),
    (_like(), True, "auto", False, True),       # under no_grad
    (_like(), False, "torch", True, False),
    (_like("cpu"), False, "auto", True, False),
    (_like(dtype=torch.float32), False, "auto", True, False),
    (_like(dtype=torch.float16), False, "auto", True, False),
    (_like(), True, "auto", True, False),       # a training step
    (_like(requires_grad=True), False, "auto", True, False),
])
def test_the_dispatch_rule(x, params_grad, impl, grad_mode, want):
    p = _like(requires_grad=params_grad)
    with torch.set_grad_enabled(grad_mode):
        assert takes_kernel(x, p, p, impl) is want
    with pytest.raises(ValueError, match="impl"):
        takes_kernel(x, p, p, "cuda")


@pytest.fixture
def no_kernel(monkeypatch):
    """Fails any call that reaches the kernel's branch."""
    def refuse(*args):
        raise AssertionError("the kernel's branch was reached")
    monkeypatch.setattr(ln_mod, "_layer_norm_cuda", refuse)
    return ln_mod.layer_norm.launches


@pytest.mark.parametrize("route", ["cpu", "f32", "autograd", "torch"])
def test_plain_routes_leave_the_counter(no_kernel, route):
    x = ln_cases.rows(8, 128, seed=1)
    g, b = ln_cases.params(128, seed=2)
    impl = "torch" if route == "torch" else "auto"
    if route == "f32":
        x = x.float()
    if route == "autograd":
        g, b = g.requires_grad_(True), b.requires_grad_(True)
    got = layer_norm(x, g, b, 1e-5, impl=impl)
    want = F.layer_norm(x.float(), (128,), g, b, 1e-5).to(x.dtype)
    assert torch.equal(got, want)
    assert ln_mod.layer_norm.launches == no_kernel
    if route == "autograd":
        got.float().sum().backward()
        assert g.grad is not None and torch.isfinite(b.grad).all()


def test_the_kernel_wrapper_refuses_cpu_tensors():
    x = ln_cases.rows(4, 128, seed=1)
    g, b = ln_cases.params(128, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        _layer_norm_cuda(x, g, b, 1e-5)
    with pytest.raises(RuntimeError, match="autograd"):
        _layer_norm_cuda(x, g.requires_grad_(True), b, 1e-5)
    with pytest.raises(ValueError, match="impl"):
        layer_norm(x, g, b, 1e-5, impl="cuda")


@pytest.fixture
def norm_calls(monkeypatch):
    """Every layer_norm call the models make, as (rows, width, impl)."""
    seen = []

    def spy(x, weight, bias, eps, impl="auto"):
        seen.append((x.numel() // x.shape[-1], x.shape[-1], impl))
        return layer_norm(x, weight, bias, eps, impl=impl)

    monkeypatch.setattr(layers, "layer_norm", spy)
    return seen


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_block_norms_follow_impl(norm_calls, impl):
    blk = layers.Block(64, 4, layers.quick_gelu).requires_grad_(False)
    for m in blk.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.data = m.weight.data.to(BF16)
    x = ln_cases.rows(10, 64, seed=4).reshape(2, 5, 64)
    blk(x, None, BF16, impl=impl)
    assert norm_calls == [(10, 64, impl)] * 2


@pytest.mark.parametrize("cfg", [VIT_TINY, SIGLIP_TINY],
                         ids=["clip", "siglip"])
@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_image_tower_norms(norm_calls, cfg, impl):
    """One batch: CLIP's ln_pre, two a block and ln_post over the CLS rows;
    SigLIP's two a block, ln_post over every token and the MAP head's
    norm over one row an image. All follow `impl`: the plain tower
    (impl="torch") never reaches the kernel's branch."""
    model = vit.VisionTransformer(cfg, torch.Generator().manual_seed(0))
    model = model.eval().requires_grad_(False)
    for m in model.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.data = m.weight.data.to(BF16)
    b, s = 3, cfg.image_size
    images = torch.randn((b, s, s, 3),
                         generator=torch.Generator().manual_seed(1)).to(BF16)
    with torch.inference_mode():
        model(images, impl=impl)
    w, t = cfg.width, cfg.seq_len
    if cfg.pool == "cls":
        want = [(b * t, w)] * (1 + 2 * cfg.layers) + [(b, w)]
    else:
        want = [(b * t, w)] * (2 * cfg.layers + 1) + [(b, w)]
    assert [c[:2] for c in norm_calls] == want
    assert {c[2] for c in norm_calls} == {impl}


def test_text_towers_norm_on_the_default_route(norm_calls):
    """The text towers run their blocks' and final norms on "auto"."""
    from mmrs_tpu_torch.models import bert, text_transformer

    text = text_transformer.TextTransformer(
        CLIP_TEXT_TINY, torch.Generator().manual_seed(0)).eval()
    tokens = torch.randint(1, 100, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        text(tokens, torch.float32)
        assert len(norm_calls) == 2 * CLIP_TEXT_TINY.layers + 1
        norm_calls.clear()
        bert.Bert(TAIYI_TINY, torch.Generator().manual_seed(0)).eval()(
            tokens, None, torch.float32)
    assert len(norm_calls) == 1 + 2 * TAIYI_TINY.layers
    assert {c[2] for c in norm_calls} == {"auto"}


# -- the launch plan and the kernel's indexing --------------------------------

@pytest.mark.parametrize("rows,slots,blocks", [
    (65792, 132 * 6, 132 * 6),      # L/14's norms: one wave, warps stride
    (256, 132 * 6, 32),             # the CLS rows: one warp a row
    (1, 1000, 1), (9, 1, 1)])
def test_plan(rows, slots, blocks):
    assert layer_norm_plan(rows, slots) == blocks


@pytest.mark.parametrize("rows,w,slots", [(37, 144, 2), (300, 1152, 7),
                                          (8, 128, 132), (65, 768, 3),
                                          (9, MAX_WIDTH, 5)])
def test_the_kernel_takes_every_row_and_vector_once(rows, w, slots):
    """The kernel's indexing in numpy: warp g of the grid takes rows g, g
    + warps, ...; lane l of a warp the vectors l, l + 32, ... below W / 8,
    at most VPL = ceil(W / 256) of them (the instance W runs on, 8 at
    MAX_WIDTH)."""
    blocks = layer_norm_plan(rows, slots)
    warps = blocks * THREADS // 32
    assert warps == blocks * WARPS
    row_hits = np.zeros(rows, np.int64)
    for g in range(warps):
        row_hits[np.arange(g, rows, warps)] += 1
    assert (row_hits == 1).all()
    vecs, vpl = w // 8, -(-w // 256)
    assert vpl <= 8
    vec_hits = np.zeros(vecs, np.int64)
    for lane in range(32):
        mine = [lane + 32 * i for i in range(vpl) if lane + 32 * i < vecs]
        vec_hits[mine] += 1
    assert (vec_hits == 1).all()


# -- the benchmark's reader of E2 ---------------------------------------------

def _reader():
    return bench_run.load_module(os.path.join(
        REPO, "benchmark", "metrics", "e2_roofline.index.py"), "e2")


def _spec(name):
    import json
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json"),
              encoding="utf-8") as f:
        return json.load(f)["image_tower"]


@pytest.mark.parametrize("name,full,rows,w", [
    ("clip-vit-b32", 25, 256 * 50, 768),
    ("taiyi-clip-l14", 49, 256 * 257, 1024),
    ("siglip-so400m-384", 55, 256 * 729, 1152)])
def test_the_reader_counts_a_batch_of_norms(name, full, rows, w):
    e2 = _reader()
    norms = e2.batch_norms(_spec(name), 256)
    assert norms.count((rows, w)) == full
    assert norms.count((256, w)) == len(norms) - full == 1
    least = e2.least_of_launch(_spec(name), 256)
    total = full * (4 * rows * w + 8 * w) + (len(norms) - full) * (
        4 * 256 * w + 8 * w)
    assert least == pytest.approx(total / len(norms)
                                  / roofline.HBM_BYTES_PER_S)


def test_the_reader_takes_only_e2():
    e2 = _reader()
    run = SimpleNamespace(
        traffic={"generator": "index", "batch": 256},
        cfg={"image_tower": _spec("taiyi-clip-l14")},
        trace=devtrace.DeviceTrace(0.0, 1.0))
    run.trace.t0_ns, run.trace.t1_ns = 0, 10 ** 10
    ms = 10 ** 6
    run.trace.events = [
        ("void (anonymous namespace)::e2_layer_norm_kernel<4>(uint4 "
         "const*, long long, float const*)", 0, 2 * ms),
        ("void (anonymous namespace)::e2_layer_norm_kernel<4>(uint4 "
         "const*, long long, float const*)", 2 * ms, 3 * ms),
        ("void at::native::(anonymous namespace)::vectorized_layer_norm_"
         "kernel<float, float>(int, float)", 3 * ms, 9 * ms)]
    least = e2.least_of_launch(run.cfg["image_tower"], 256)
    assert e2.read(run) == pytest.approx(100 * 2 * least / 3e-3)
    run.trace.events = run.trace.events[2:]      # the parent's trace
    assert e2.read(run) is None
    run.traffic["generator"] = "open_loop"
    assert e2.read(run) is None
