"""The port's DP x TP contrastive step (adapt/contrastive.make_train_step
with `mesh=`) against its one-device step and mmrs_tpu's mesh step.

A tiny CLIP (JAX `clip.init` from a key, carried over by
models/convert_jax) takes 2 AdamW steps at f32 on a 2x2 mesh of CPU
entries: the batch over the data axis, the blocks' heads and MLP units
over the model axis. The losses and every parameter must agree within
1e-5 with the one-device port and with JAX's `make_train_step(cfg,
mesh)` on its 2x2 CPU mesh; a key bias, whose exact gradient is zero
(it shifts a softmax row alike), keeps only Adam's bound of lr a step.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from mmrs_tpu.adapt import contrastive as j_contrastive
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models import configs as j_configs
from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mmrs_tpu_torch.adapt import contrastive
from mmrs_tpu_torch.config import MeshConfig
from mmrs_tpu_torch.models import clip as t_clip
from mmrs_tpu_torch.models import configs as t_configs
from mmrs_tpu_torch.models import convert_jax
from mmrs_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
LR = 1e-4
STEPS = 2

J_CFG = j_clip.CLIPConfig(
    vision=j_configs.VITConfig(image_size=32, patch_size=8, width=64,
                               layers=2, heads=4, embed_dim=32),
    text=j_configs.TextConfig(vocab_size=128, context_length=12, width=64,
                              layers=2, heads=4, embed_dim=32))
T_CFG = t_clip.CLIPConfig(
    vision=t_configs.VITConfig(image_size=32, patch_size=8, width=64,
                               layers=2, heads=4, embed_dim=32),
    text=t_configs.TextConfig(vocab_size=128, context_length=12, width=64,
                              layers=2, heads=4, embed_dim=32))


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(1, 127, (b, 12)).astype(np.int32))


def _mesh(dp=2, tp=2):
    return make_mesh(MeshConfig(data_size=dp, model_size=tp),
                     [CPU] * (dp * tp))


def _close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith("attn.wk.bias"):
            assert float((got[name] - w).abs().max()) <= 2 * STEPS * LR * (
                1 + 1e-5), name
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5,
                                   err_msg=name)


def test_clip_param_specs_follow_jax():
    """Column-parallel on the JAX kernel's N (and its bias) is the port's
    dim 0, row-parallel on K its dim 1; everything else replicated."""
    specs = contrastive.clip_param_specs(t_clip.CLIP(T_CFG))
    jblock = j_contrastive._block_specs()
    for name, dim in specs.items():
        parts = name.split(".")
        if ".blocks." not in name or parts[-3] not in ("attn", "mlp"):
            assert dim is None, name
            continue
        part, layer, kind = parts[-3:]
        jname = ("w" if kind == "weight" else "b") + layer[1:]
        spec = tuple(jblock[part][jname])
        want = {(None, None, MODEL_AXIS): 0, (None, MODEL_AXIS): 0,
                (None, MODEL_AXIS, None): 1}.get(spec)
        assert dim == want, name
    assert sum(d is not None for d in specs.values()) == 2 * 2 * 10


@pytest.mark.parametrize("remat", [False, True])
def test_mesh_steps_equal_one_device_and_jax(remat):
    jm = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
               (DATA_AXIS, MODEL_AXIS))
    j_step, init_state = j_contrastive.make_train_step(
        J_CFG, jm, learning_rate=LR, compute_dtype=jnp.float32, remat=remat)
    params, opt_state = init_state(jax.random.key(2))
    model = convert_jax.from_jax_params(jax.tree.map(np.asarray, params),
                                        T_CFG)
    one = copy.deepcopy(model)
    t_step, opt = contrastive.make_train_step(
        model, mesh=_mesh(), learning_rate=LR, compute_dtype=torch.float32,
        remat=remat)
    o_step, _ = contrastive.make_train_step(
        one, learning_rate=LR, compute_dtype=torch.float32)
    images, tokens = _batch(3)
    ti, tt = torch.from_numpy(images), torch.from_numpy(tokens)
    for _ in range(STEPS):
        params, opt_state, jl = j_step(params, opt_state,
                                       jnp.asarray(images),
                                       jnp.asarray(tokens))
        tl, ol = float(t_step(ti, tt)), float(o_step(ti, tt))
        assert tl == pytest.approx(float(jl), abs=1e-5)
        assert tl == pytest.approx(ol, abs=1e-5)
    got = model.state_dict()
    _close(got, one.state_dict())
    _close(got, convert_jax.state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    # the optimizer holds the split parameters' pieces, not `model`'s
    n_pieces = sum(len(g["params"]) for g in opt.param_groups)
    assert n_pieces == len(list(model.parameters())) + 2 * 2 * 10


def test_mesh_step_refusals():
    model = t_clip.CLIP(T_CFG, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="does not divide"):
        contrastive.make_train_step(model, mesh=_mesh(1, 3))
    step, _ = contrastive.make_train_step(model, mesh=_mesh(),
                                          compute_dtype=torch.float32)
    images, tokens = _batch(4, b=5)
    with pytest.raises(ValueError, match="data axis"):
        step(torch.from_numpy(images), torch.from_numpy(tokens))
