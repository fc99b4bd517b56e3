"""The port's adaptation path (adapt/tip_adapter.py, adapt/driver.py,
adapt/contrastive.py, io/augment.py) against mmrs_tpu's on the same seeded
inputs, and the kernels' refusal to cut an autograd graph.

Tolerances: cache, logits and classifier 1e-6 (f32, the same formulas);
the (beta, alpha) F1 grid 1e-6 and the same best cell where it is
separated from the next by 1e-6 or more; Tip-Adapter-F keys 1e-5 after 3
epochs (AdamW and optax's adamw apply decay and the Adam step in another
order: equal up to rounding) with an equal F1 history; the contrastive
step's parameters 1e-5 after 3 steps at f32; augmentation bit-equal.
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from mmrs_tpu.adapt import contrastive as j_contrastive
from mmrs_tpu.adapt import driver as j_driver
from mmrs_tpu.adapt import tip_adapter as j_tip
from mmrs_tpu.config import Config as JConfig
from mmrs_tpu.config import MeshConfig
from mmrs_tpu.io import augment as j_augment
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models import configs as j_configs
from mmrs_tpu.models.tokenizer import CLIPTokenizer as JTokenizer
from mmrs_tpu.parallel.mesh import make_mesh
from mmrs_tpu.pipeline import build_towers as j_build_towers
from mmrs_tpu_torch.adapt import contrastive, driver
from mmrs_tpu_torch.adapt import tip_adapter as tip
from mmrs_tpu_torch.config import Config as TConfig
from mmrs_tpu_torch.io import augment
from mmrs_tpu_torch.models import clip as t_clip
from mmrs_tpu_torch.models import configs as t_configs
from mmrs_tpu_torch.models import convert_jax
from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer as TTokenizer
from mmrs_tpu_torch.ops import _cuda
from mmrs_tpu_torch.pipeline import build_towers as t_build_towers

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _problem(seed=0, n_classes=4, d=32, shots=8, n_test=200):
    """tests/test_tip_adapter.py's synthetic problem: class-clustered unit
    features, a degraded text classifier."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, d))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)

    def sample(n_per, noise):
        feats, labels = [], []
        for c in range(n_classes):
            f = protos[c] + noise * rng.normal(size=(n_per, d))
            f /= np.linalg.norm(f, axis=1, keepdims=True)
            feats.append(f)
            labels += [c] * n_per
        return (np.concatenate(feats).astype(np.float32),
                np.asarray(labels, np.int32))

    train_f, train_y = sample(shots, 0.3)
    test_f, test_y = sample(n_test // n_classes, 0.3)
    w = protos + 0.8 * rng.normal(size=protos.shape)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return train_f, train_y, test_f, test_y, w.T.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_cache_equals_jax(seed):
    rng = np.random.default_rng(seed)
    aug = rng.normal(size=(3, 12, 16)).astype(np.float32)
    labels = rng.integers(0, 5, 12).astype(np.int32)
    jk, jv = j_tip.build_cache(jnp.asarray(aug), jnp.asarray(labels), 5)
    tk, tv = tip.build_cache(aug, labels, 5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1.7, 2.3), (30.0, 5.0)])
def test_tip_logits_equals_jax(alpha, beta):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(9, 8)).astype(np.float32) / 3
    keys = rng.normal(size=(12, 8)).astype(np.float32) / 3
    values = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    w = rng.normal(size=(8, 3)).astype(np.float32) / 3
    want = np.asarray(j_tip.tip_logits(*map(jnp.asarray, (feats, keys,
                                                           values, w)),
                                       alpha, beta))
    got = tip.tip_logits(*map(torch.from_numpy, (feats, keys, values, w)),
                         alpha, beta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * 100)


def test_clip_classifier_equals_jax():
    embeds = np.random.default_rng(4).normal(size=(3, 4, 16)).astype(
        np.float32)
    want = np.asarray(j_tip.clip_classifier(jnp.asarray(embeds)))
    got = tip.clip_classifier(embeds)
    assert tuple(got.shape) == (16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("seed,steps", [(3, (10, 5)), (5, (200, 20)),
                                        (7, (37, 11))])
def test_search_hp_equals_jax(seed, steps):
    _, _, test_f, test_y, w = _problem(seed=seed)
    train_f, train_y = _problem(seed=seed)[:2]
    keys, values = j_tip.build_cache(jnp.asarray(train_f)[None],
                                     jnp.asarray(train_y), 4)
    want = j_tip.search_hp(jnp.asarray(test_f), keys, values, jnp.asarray(w),
                           test_y, 4, search_step=steps)
    got = tip.search_hp(test_f, np.asarray(keys), np.asarray(values), w,
                        test_y, 4, search_step=steps)
    assert got.grid.shape == want.grid.shape == steps
    np.testing.assert_allclose(got.grid, want.grid, atol=1e-6)
    flat = np.sort(want.grid.ravel())
    if flat[-1] - flat[-2] >= 1e-6:
        assert (got.beta, got.alpha) == (want.beta, want.alpha)
    assert got.f1 == pytest.approx(want.f1, abs=1e-6)


def test_grid_chunks_keep_the_grid(monkeypatch):
    """A memory budget of one beta a chunk gives the same grid."""
    _, _, test_f, test_y, w = _problem(seed=3)
    train_f, train_y = _problem(seed=3)[:2]
    keys, values = tip.build_cache(train_f[None], train_y, 4)
    whole = tip.search_hp(test_f, keys, values, w, test_y, 4,
                          search_step=(12, 6))
    monkeypatch.setattr(tip, "GRID_BYTES", 1)
    assert tip.grid_chunk(200, 32, 4, 6) == 1
    chunked = tip.search_hp(test_f, keys, values, w, test_y, 4,
                            search_step=(12, 6))
    np.testing.assert_array_equal(chunked.grid, whole.grid)


@pytest.mark.parametrize("shards", [8, 3])
def test_search_hp_on_mesh_equals_jax(shards):
    """mesh=: the beta axis split over S CPU entries (50 betas: padded
    past a multiple of S) against JAX's sweep over S of its 8 CPU devices
    and the one-device sweep (tests/test_multihost.py:257: grid within
    rtol 1e-5, atol 1e-6; the same (beta, alpha))."""
    from mmrs_tpu.config import MeshConfig as JMeshConfig
    from mmrs_tpu_torch.config import MeshConfig as TMeshConfig
    from mmrs_tpu_torch.parallel.mesh import make_mesh as t_make_mesh

    rng = np.random.default_rng(3)
    n, d, c, nk = 64, 16, 4, 20
    feats = rng.normal(size=(n, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    keys = rng.normal(size=(nk, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    values = np.eye(c, dtype=np.float32)[rng.integers(0, c, nk)]
    cw = rng.normal(size=(d, c)).astype(np.float32)
    cw /= np.linalg.norm(cw, axis=0, keepdims=True)
    labels = rng.integers(0, c, n)
    jm = make_mesh(JMeshConfig(data_size=shards), jax.devices()[:shards])
    tm = t_make_mesh(TMeshConfig(data_size=shards),
                     [torch.device("cpu")] * shards)
    want = j_tip.search_hp(jnp.asarray(feats), jnp.asarray(keys),
                           jnp.asarray(values), jnp.asarray(cw), labels, c,
                           search_step=(50, 10), mesh=jm)
    got = tip.search_hp(feats, keys, values, cw, labels, c,
                        search_step=(50, 10), mesh=tm)
    one = tip.search_hp(feats, keys, values, cw, labels, c,
                        search_step=(50, 10))
    assert got.grid.shape == (50, 10)
    np.testing.assert_allclose(got.grid, want.grid, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.grid, one.grid)
    assert (got.beta, got.alpha) == (want.beta, want.alpha) == \
        (one.beta, one.alpha)


def test_cosine_decay_equals_optax():
    import optax

    sched = optax.cosine_decay_schedule(1.0, 30)
    for count in (0, 1, 7, 15, 29, 30, 31):
        assert tip.cosine_decay(count, 30) == pytest.approx(
            float(sched(count)), abs=1e-7)


@pytest.mark.parametrize("per_epoch,batch_size", [(False, 256), (True, 8),
                                                  (True, 5)])
def test_train_tip_adapter_f_equals_jax(per_epoch, batch_size):
    train_f, train_y, test_f, test_y, w = _problem(seed=2)
    keys, values = j_tip.build_cache(jnp.asarray(train_f)[None],
                                     jnp.asarray(train_y), 4)
    feats = train_f
    if per_epoch:   # two augmented view sets, cycled across epochs
        rng = np.random.default_rng(9)
        views = train_f[None] + 0.05 * rng.normal(size=(2, *train_f.shape))
        feats = (views / np.linalg.norm(views, axis=-1, keepdims=True)
                 ).astype(np.float32)
    kw = dict(num_classes=4, lr=1e-2, epochs=3, batch_size=batch_size,
              alpha=3.0, beta=5.0, run_search_hp=True,
              search_step=(20, 10), seed=4)
    want = j_tip.train_tip_adapter_f(
        jnp.asarray(feats), jnp.asarray(train_y), jnp.asarray(test_f),
        jnp.asarray(test_y), keys, values, jnp.asarray(w), **kw)
    got = tip.train_tip_adapter_f(feats, train_y, test_f, test_y,
                                  np.asarray(keys), np.asarray(values), w,
                                  **kw)
    assert not np.allclose(want.adapter_keys, np.asarray(keys), atol=1e-4)
    np.testing.assert_allclose(got.adapter_keys, want.adapter_keys,
                               atol=1e-5)
    assert got.history == want.history
    assert (got.best_f1, got.best_epoch) == (want.best_f1, want.best_epoch)
    np.testing.assert_allclose(got.hp.grid, want.hp.grid, atol=1e-6)


def test_training_improves_over_the_cache():
    """tests/test_tip_adapter.py's property on the port alone."""
    from mmrs_tpu_torch.search.metrics import macro_f1

    train_f, train_y, test_f, test_y, w = _problem()
    keys, values = tip.build_cache(train_f[None], train_y, 4)
    zs = macro_f1(np.argmax(100.0 * test_f @ w, axis=1), test_y, 4)
    tf = macro_f1(tip.tip_logits(torch.from_numpy(test_f), keys, values,
                                 torch.from_numpy(w), 3.0, 5.0).argmax(1),
                  test_y, 4)
    assert tf > zs
    res = tip.train_tip_adapter_f(train_f, train_y, test_f, test_y, keys,
                                  values, w, num_classes=4, epochs=10,
                                  alpha=3.0, beta=5.0, run_search_hp=False)
    assert res.best_f1 >= tf - 1e-6 and len(res.history) == 10


# ---- augmentation -----------------------------------------------------------

@pytest.mark.parametrize("size", [(64, 48), (48, 64), (300, 40), (40, 300)])
def test_crop_params_equal_jax(size):
    for seed in range(20):
        assert augment.random_resized_crop_params(
            *size, random.Random(seed)) == \
            j_augment.random_resized_crop_params(*size, random.Random(seed))


def test_augmented_pixels_bit_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate([(64, 48), (50, 90), (33, 33)]):
        p = tmp_path / f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(str(p))
    got = list(augment.augmented_epochs(paths, 3, size=32, seed=7))
    want = list(j_augment.augmented_epochs(paths, 3, size=32, seed=7))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (3, 32, 32, 3)
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


# ---- the few-shot driver on test_adapter_driver.py's tower and tree ---------

@pytest.fixture(scope="module")
def fewshot(tmp_path_factory):
    """tests/test_adapter_driver.py's tree (3 solid-color classes, 6 images
    each) and one f32 vit_tiny checkpoint both packages load."""
    root = tmp_path_factory.mktemp("fewshot")
    rng = np.random.default_rng(0)
    bases = {"red": (200, 30, 30), "green": (30, 200, 30),
             "blue": (30, 30, 200)}
    for cls, base in bases.items():
        (root / cls).mkdir()
        for i in range(6):
            img = np.clip(np.asarray(base, np.int16)[None, None]
                          + rng.integers(-25, 25, (64, 48, 3)), 0, 255
                          ).astype(np.uint8)
            Image.fromarray(img).save(root / cls / f"{cls}{i}.jpg")
    ckpt = str(root.parent / "fewshot.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(5), j_clip.CLIPConfig(
        vision=j_configs.VIT_TINY, text=j_configs.CLIP_TEXT_TINY)), ckpt)
    return str(root), ckpt


def _towers(mod, build, tok, ckpt, **kw):
    cfg = mod()
    cfg.model.image_tower = "vit_tiny"
    cfg.model.dtype = "float32"
    cfg.model.checkpoint_path = ckpt
    return build(cfg, tokenizer=tok.synthetic(["red", "green", "blue",
                                               "photo"]), **kw)


@pytest.mark.parametrize("search", [False, True])
def test_run_few_shot_equals_jax(fewshot, search):
    root, ckpt = fewshot
    kw = dict(shots=2, augment_epoch=2, epochs=3, alpha=30.0, beta=5.0,
              run_search_hp=search, batch_size=8, seed=0)
    want = j_driver.run_few_shot(
        _towers(JConfig, j_build_towers, JTokenizer, ckpt), root, **kw)
    got = driver.run_few_shot(
        _towers(TConfig, t_build_towers, TTokenizer, ckpt, device="cpu"),
        root, **kw)
    assert got.classes == want.classes == ["blue", "green", "red"]
    np.testing.assert_allclose(got.keys, want.keys, atol=1e-5)
    np.testing.assert_array_equal(got.values, want.values)
    assert (got.zero_shot_f1, got.tip_f1) == (want.zero_shot_f1,
                                              want.tip_f1)
    np.testing.assert_allclose(got.result.adapter_keys,
                               want.result.adapter_keys, atol=1e-5)
    assert got.result.history == want.result.history
    assert got.result.best_epoch == want.result.best_epoch
    assert got.result.best_f1 > got.tip_f1
    if search:
        np.testing.assert_allclose(got.result.hp.grid, want.result.hp.grid,
                                   atol=1e-6)
        assert set(got.seconds) == {"cache", "test_encode", "classifier",
                                    "tip_f", "search_hp"}
    else:
        assert got.result.hp is None and "search_hp" not in got.seconds


def test_cache_from_folder_equals_jax(fewshot):
    root, ckpt = fewshot
    from mmrs_tpu.io.dataset import FolderDataset, few_shot_sample

    ds = FolderDataset.from_root(root, image_size=224)
    shot = few_shot_sample(ds.samples, 2, seed=0)
    paths = [p for p, _ in shot]
    cls_idx = {c: i for i, c in enumerate(ds.classes)}
    labels = [cls_idx[c] for _, c in shot]
    jt = _towers(JConfig, j_build_towers, JTokenizer, ckpt)
    tt = _towers(TConfig, t_build_towers, TTokenizer, ckpt, device="cpu")
    jk, jv, ja = j_tip.build_cache_from_folder(
        jt.image_encode_raw, paths, labels, 3, augment_epoch=2,
        image_size=224, batch_size=4, seed=1)
    tk, tv, ta = tip.build_cache_from_folder(
        tt.image_encode_raw, paths, labels, 3, augment_epoch=2,
        image_size=224, batch_size=4, seed=1)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    assert not np.allclose(ta[0].numpy(), ta[1].numpy(), atol=1e-5)


# ---- contrastive training ---------------------------------------------------

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


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(1, 127, (b, 12)).astype(np.int32))


def _jax_params(seed):
    return jax.tree.map(np.asarray, j_clip.init(jax.random.key(seed), J_CFG))


def test_contrastive_loss_equals_jax():
    params = _jax_params(0)
    images, tokens = _batch(1)
    want = float(j_contrastive.contrastive_loss(
        params, jnp.asarray(images), jnp.asarray(tokens), J_CFG, jnp.float32))
    model = convert_jax.from_jax_params(params, T_CFG)
    got = contrastive.contrastive_loss(model, torch.from_numpy(images),
                                       torch.from_numpy(tokens),
                                       torch.float32)
    assert float(got.detach()) == pytest.approx(want, abs=1e-5)


LR = 1e-4


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_equal_jax(remat):
    """3 AdamW steps at lr 1e-4 on a 1x1 mesh (JAX) and on one device: the
    losses and every parameter agree."""
    mesh = make_mesh(MeshConfig(data_size=1, model_size=1),
                     jax.devices()[:1])
    j_step, init_state = j_contrastive.make_train_step(
        J_CFG, mesh, learning_rate=LR, compute_dtype=jnp.float32,
        remat=remat)
    params, opt_state = init_state(jax.random.key(2))
    model = convert_jax.from_jax_params(jax.tree.map(np.asarray, params),
                                        T_CFG)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    t_step, _ = contrastive.make_train_step(
        model, learning_rate=LR, compute_dtype=torch.float32, remat=remat)
    images, tokens = _batch(3)
    j_losses, t_losses = [], []
    for _ in range(3):
        params, opt_state, loss = j_step(params, opt_state,
                                         jnp.asarray(images),
                                         jnp.asarray(tokens))
        j_losses.append(float(loss))
        t_losses.append(float(t_step(torch.from_numpy(images),
                                     torch.from_numpy(tokens))))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    assert t_losses[-1] < t_losses[0]
    want = convert_jax.state_dict_from_jax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0.0
    for name, w in want.items():
        if name.endswith("attn.wk.bias"):
            # a key bias shifts every logit of a softmax row alike: its
            # exact gradient is zero, and both packages' Adam normalizes
            # their rounding noise into steps of up to lr; only the bound
            # is checked
            assert float(got[name].abs().max()) <= 3 * LR * (1 + 1e-5)
            continue
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-5,
                                   err_msg=name)
        moved = max(moved, float((got[name] - before[name]).abs().max()))
    assert moved > 2 * LR


def test_train_step_refuses_frozen_serving_towers():
    towers = t_build_towers(TConfig(), device="cpu")   # vit_b32, frozen
    with pytest.raises(ValueError, match="require grad"):
        contrastive.make_train_step(towers.params)


def test_bf16_step_learns():
    """The bf16 compute mix with f32 master parameters (the chip's
    setting) trains: the loss falls over 4 steps on a fixed batch."""
    model = t_clip.CLIP(T_CFG, generator=torch.Generator().manual_seed(0))
    step, _ = contrastive.make_train_step(model, learning_rate=LR)
    images, tokens = _batch(4)
    losses = [float(step(torch.from_numpy(images), torch.from_numpy(tokens)))
              for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---- the kernels refuse to cut an autograd graph ----------------------------

def test_refuse_grad_guard():
    x = torch.zeros(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        _cuda.refuse_grad("k", torch.zeros(2), x)
    with torch.no_grad():
        _cuda.refuse_grad("k", x)
    with torch.inference_mode():
        _cuda.refuse_grad("k", torch.zeros(2))
    _cuda.refuse_grad("k", x.detach(), None, torch.zeros(3, dtype=torch.int8))


def _kernel_call(name):
    """A call of each kernel's CUDA entry on CPU tensors that require
    grad (the refusal comes before the device check)."""
    from mmrs_tpu_torch.ops import attention, decode_attention, mlp_int8

    x = torch.zeros((1, 2, 4, 8), requires_grad=True)
    x2 = torch.zeros((4, 8), requires_grad=True)
    w1 = torch.zeros((16, 8), dtype=torch.int8)
    w2 = torch.zeros((8, 16), dtype=torch.int8)
    s = torch.ones(16)
    return {
        "K2": lambda: attention._mha_cuda(x[0], x[0], x[0], 2),
        "K6": lambda: mlp_int8._mlp_int8_cuda(x2, w1, s, s, w2, s[:8],
                                              s[:8], "gelu"),
        "K10": lambda: decode_attention._chunk_cuda(
            x[:, :, :, None], x, None, x, None, 0),
        "K11": lambda: decode_attention._decode_cuda(x, x, None, x, None, 0),
    }[name]


@pytest.mark.parametrize("name", ["K2", "K6", "K10", "K11"])
def test_kernel_entry_points_refuse_grad_first(name):
    """K2, K6, K10 and K11 check for grad before anything else: CPU
    tensors that require grad get the autograd refusal, not the device
    error that CPU tensors get otherwise."""
    with pytest.raises(RuntimeError, match="autograd"):
        _kernel_call(name)()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        _kernel_call(name)()


def test_plain_routes_keep_the_graph():
    """On the CPU the same entry points run their plain versions, which
    record the graph (the training route)."""
    from mmrs_tpu_torch.ops.attention import mha_short_seq

    q = torch.randn(2, 5, 16, requires_grad=True)
    mha_short_seq(q, q, q, 4).sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0
