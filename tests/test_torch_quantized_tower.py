"""The port's int8 serving tower (models/layers.QLinear, models/quantize,
ops/mlp_int8, the int8 checkpoint path, build_towers dtype "int8") against
mmrs_tpu's, and the f32 bias of the bf16 dense layers.

Seeded numpy inputs and one JAX parameter tree (with seeded NONZERO biases:
`clip.init` zeroes them, real CLIP checkpoints do not) feed both packages.
Weight codes and scales must be bit-identical; the fused int8 MLP's plain
version (the kernel's CPU stand-in, K6) must be within 0.02 of the JAX
kernel in interpret mode; the int8 tiny tower must reach a cosine of 0.9999
at f32 compute and 0.999 at bf16 to the JAX int8 tower.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from mmrs_tpu import config as j_config
from mmrs_tpu import pipeline as j_pipeline
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models import layers as j_layers
from mmrs_tpu.models import quantize as j_quantize
from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
from mmrs_tpu.ops import mlp_int8 as j_mlp_int8
from mmrs_tpu_torch import config as t_config
from mmrs_tpu_torch import pipeline as t_pipeline
from mmrs_tpu_torch.models import clip, convert_jax, layers, quantize
from mmrs_tpu_torch.models.configs import TextConfig, VITConfig
from mmrs_tpu_torch.ops import mlp_int8

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_towers import with_seeded_biases  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


# the vit_tiny pair: the JAX int8 MLP kernel needs widths that are
# multiples of 128 (a TPU tiling limit the port's kernel does not share)
J_CFG = j_clip.CLIPConfig(vision=VIT_TINY, text=CLIP_TEXT_TINY)
T_CFG = clip.CLIPConfig(vision=VITConfig(**VIT_TINY.__dict__),
                        text=TextConfig(**CLIP_TEXT_TINY.__dict__))


@pytest.fixture(scope="module")
def params():
    return with_seeded_biases(j_clip.init(jax.random.key(0), J_CFG), seed=1)


def _images(seed, b=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 224, 224, 3)).astype(np.float32)


# -- the bias of the bf16 dense layers ------------------------------------------

def test_dense_bf16_adds_the_f32_bias_before_rounding():
    """mmrs_tpu's dense adds the f32 bias to the f32 sums and rounds once;
    rounding the bias to bf16 first changes ~19% of the outputs by an ulp."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 512)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(512) * 0.3).astype(np.float32)
    want = np.asarray(j_layers.dense(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), jnp.bfloat16),
                      np.float32)
    lin = nn.Linear(256, 512)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    with torch.no_grad():
        got = layers.dense(torch.from_numpy(x), lin, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    differ = got != want
    # only the order of the f32 sums may differ: a handful of elements,
    # each by one bf16 ulp
    assert differ.sum() <= 8, int(differ.sum())
    ulp = np.ldexp(1.0, np.frexp(want[differ])[1] - 8)
    assert np.all(np.abs(got[differ] - want[differ]) <= ulp)


# -- weight quantization ----------------------------------------------------------

def test_quantize_weight_bit_identical_to_jax():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((96, 160)) * 0.05).astype(np.float32)
    w[:, 5] = 0.0                                  # an all-zero channel
    jq = j_layers.quantize_weight(jnp.asarray(w))
    lin = nn.Linear(96, 160)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
    tq = layers.QLinear.from_linear(lin)
    assert tq.q.dtype == torch.int8 and tq.q.shape == (160, 96)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q).T)
    np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
    np.testing.assert_array_equal(tq.bias.numpy(),
                                  lin.bias.detach().numpy())


def test_quantize_clip_visual_bit_identical_to_jax(params):
    jq = j_quantize.quantize_clip_visual(params)
    model = quantize.quantize_clip_visual(
        convert_jax.from_jax_params(params, T_CFG))
    vis = model.visual
    assert isinstance(vis.patch_embed, layers.QLinear)
    assert isinstance(vis.proj, nn.Linear)               # stays unquantized
    assert isinstance(model.text.blocks[0].mlp.w1, nn.Linear)
    np.testing.assert_array_equal(
        vis.patch_embed.q.numpy(), np.asarray(jq["visual"]["patch_kernel"].q).T)
    jb = jq["visual"]["blocks"]
    for i, blk in enumerate(vis.blocks):
        for mod, group, name in ((blk.attn, "attn", "wq"),
                                 (blk.attn, "attn", "wo"),
                                 (blk.mlp, "mlp", "w1"),
                                 (blk.mlp, "mlp", "w2")):
            got = getattr(mod, name)
            np.testing.assert_array_equal(got.q.numpy(),
                                          np.asarray(jb[group][name].q[i]).T)
            np.testing.assert_array_equal(got.s.numpy(),
                                          np.asarray(jb[group][name].s[i]))
    # already-quantized layers are left as they are
    before = vis.blocks[0].mlp.w1
    quantize.quantize_clip_visual(model)
    assert vis.blocks[0].mlp.w1 is before


# -- K6's plain version against the JAX kernel ----------------------------------

def _mlp_case(m, w=256, h=512, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, w)) * 0.5).astype(np.float32)
    w1 = j_layers.quantize_weight(jnp.asarray(
        rng.standard_normal((w, h)) * 0.02, jnp.float32))
    w2 = j_layers.quantize_weight(jnp.asarray(
        rng.standard_normal((h, w)) * 0.02, jnp.float32))
    b1 = (rng.standard_normal(h) * 0.01).astype(np.float32)
    b2 = (rng.standard_normal(w) * 0.01).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("m,dtype", [(100, "bfloat16"), (77, "bfloat16"),
                                     (64, "float32")])
def test_mlp_int8_plain_matches_jax_kernel(act, m, dtype):
    x, w1, b1, w2, b2 = _mlp_case(m, seed=m)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_mlp_int8.mlp_int8_fused(
        jx, w1.q, w1.s, jnp.asarray(b1), w2.q, w2.s, jnp.asarray(b2),
        act=act, tile_m=64, interpret=True), np.float32)
    t = torch.from_numpy
    got = mlp_int8.mlp_int8_fused(
        t(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype)),
        t(np.asarray(w1.q).T.copy()), t(np.asarray(w1.s)), t(b1),
        t(np.asarray(w2.q).T.copy()), t(np.asarray(w2.s)), t(b2), act=act)
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, 256)
    got = got.float().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 0.02


def test_mlp_tile_fits_hopper_shared_memory():
    """The kernels' GEMM block fits Hopper's shared memory twice an SM (one
    block's epilogue runs under the other's products)."""
    ring = mlp_int8.STAGES * (mlp_int8.TILE_M + mlp_int8.TILE_N) * 128
    assert mlp_int8.SMEM_BYTES == ring + 1024
    assert 2 * (mlp_int8.SMEM_BYTES + 1024) <= 233472   # + 1 KB reserved each
    for (w, h) in ((768, 3072), (1024, 4096), (64, 256), (512, 2048)):
        plan = mlp_int8.mlp_plan(300, w, h)
        assert (plan.tile_m, plan.tile_n, plan.stages) == (
            mlp_int8.TILE_M, mlp_int8.TILE_N, mlp_int8.STAGES)
    with pytest.raises(ValueError, match="W % 32"):
        mlp_int8.mlp_plan(300, 1024, 8200)


@pytest.mark.parametrize("m,w,h,grid1,grid2", [
    (224 * 50, 768, 3072, (88, 24), (88, 6)),     # ViT-B/32 serving batch
    (8 * 577, 1024, 4096, (37, 32), (37, 8)),     # L/14-336, verifier pack
    (11200 - 1, 512, 2048, (88, 16), (88, 4)),    # W/H = 512/2048
    (1, 768, 3072, (1, 24), (1, 6)),
    (129, 96, 384, (2, 3), (2, 1)),               # ragged column tiles
])
def test_mlp_plan_accepts_the_served_shapes(m, w, h, grid1, grid2):
    """grid1 / grid2: the GEMM blocks (row tiles, column tiles) of x.w1 and
    of h.w2 that the plan's tiles give."""
    plan = mlp_int8.mlp_plan(m, w, h)
    assert (plan.tile_m, plan.tile_n, plan.stages) == (128, 128, 3)
    for grid, cols in ((grid1, h), (grid2, w)):
        assert grid == (-(-m // plan.tile_m), -(-cols // plan.tile_n))
    assert grid1[0] * 128 >= m > (grid1[0] - 1) * 128  # ragged M: one tile more
    # f32 h [M, H] and each row's max |h| per column tile of x.w1
    assert plan.h_shape == (m, h) and plan.hmax_shape == (m, grid1[1])


@pytest.mark.parametrize("m,w,h,match", [
    (16, 80, 384, "W % 32"), (16, 768, 3000, "H % 32"), (16, 16, 64, "W % 32"),
    (0, 768, 3072, "1 <= M"), (2 ** 31, 768, 3072, "1 <= M"),
    (16, 768, 65536 * 256, "column tiles"),
])
def test_mlp_plan_refuses_what_the_kernel_cannot_run(m, w, h, match):
    with pytest.raises(ValueError, match=match):
        mlp_int8.mlp_plan(m, w, h)


# -- the int8 tower ------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_pair(params):
    jq = j_quantize.quantize_clip_visual(params)
    model = quantize.quantize_clip_visual(
        convert_jax.from_jax_params(params, T_CFG))
    return jq, model


def _cos(a, b):
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = b / np.linalg.norm(b, axis=1, keepdims=True)
    return (a * b).sum(1).min()


@pytest.mark.parametrize("dtype,jax_mlp,bound", [
    ("float32", "pallas_interpret", 0.9999),
    ("bfloat16", "pallas_interpret", 0.999),
    ("bfloat16", "xla", 0.999),       # JAX's default route rounds h to bf16
])
def test_int8_tower_matches_jax(int8_pair, dtype, jax_mlp, bound):
    jq, model = int8_pair
    x = _images(3)
    want = np.asarray(j_clip.encode_image(
        jq, jnp.asarray(x), J_CFG, compute_dtype=getattr(jnp, dtype),
        attn_impl="pallas_interpret", mlp_impl=jax_mlp))
    got = clip.encode_image(model, torch.from_numpy(x),
                            getattr(torch, dtype)).numpy()
    assert np.isfinite(got).all()
    assert _cos(got, want) >= bound


def test_int8_npz_loads_through_the_port(int8_pair, tmp_path):
    jq, model = int8_pair
    path = str(tmp_path / "q8.npz")
    j_checkpoint.save_npz(jq, path)
    loaded = convert_jax.load_npz(path, T_CFG)
    w1 = loaded.visual.blocks[1].mlp.w1
    assert isinstance(w1, layers.QLinear) and w1.q.dtype == torch.int8
    assert loaded.visual.patch_embed.bias is None
    x = torch.from_numpy(_images(4))
    for dtype in (torch.float32, torch.bfloat16):
        np.testing.assert_array_equal(
            clip.encode_image(loaded, x, dtype).numpy(),
            clip.encode_image(model, x, dtype).numpy())


def test_build_towers_int8(tmp_path):
    """dtype "int8": an int8 vision tower (biases f32), a bf16 text tower;
    image embeddings close to the JAX int8 pipeline's on the same pixels."""
    ckpt = str(tmp_path / "tiny.npz")
    j_checkpoint.save_npz(with_seeded_biases(j_clip.init(
        jax.random.key(3), j_clip.CLIPConfig(vision=VIT_TINY,
                                             text=CLIP_TEXT_TINY)), seed=4,
        std=0.05), ckpt)

    def cfg(mod):
        return mod.Config(model=mod.ModelConfig(
            image_tower="vit_tiny", dtype="int8", checkpoint_path=ckpt))

    towers = t_pipeline.build_towers(cfg(t_config), device="cpu")
    vis, txt = towers.params.visual, towers.params.text
    assert isinstance(vis.blocks[0].attn.wq, layers.QLinear)
    assert vis.blocks[0].attn.wq.bias.dtype == torch.float32
    assert vis.proj.weight.dtype == torch.bfloat16
    assert txt.blocks[0].mlp.w1.weight.dtype == torch.bfloat16
    assert txt.blocks[0].mlp.w1.bias.dtype == torch.float32
    px = np.random.default_rng(5).integers(0, 256, (2, 224, 224, 3),
                                           dtype=np.uint8)
    got = towers.image_encode(px)
    assert got.shape == (2, 64) and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    want = np.asarray(j_pipeline.build_towers(cfg(j_config)).image_encode(px),
                      np.float32)
    assert _cos(got, want) >= 0.999
