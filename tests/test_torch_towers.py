"""The port's CLIP towers (mmrs_tpu_torch/models) against mmrs_tpu's.

One parameter tree from `mmrs_tpu.models.clip.init`, converted to numpy,
feeds both packages (the port through models/convert_jax.from_jax_params).
The JAX image tower runs its Pallas attention in interpret mode. f32 towers
agree to 1e-4; bf16 towers to a cosine of 0.999.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models import vit as j_vit
from mmrs_tpu.models.configs import TextConfig as JTextConfig
from mmrs_tpu.models.configs import VITConfig as JVITConfig
from mmrs_tpu_torch.models import checkpoint, clip, convert_jax, vit
from mmrs_tpu_torch.models.configs import TextConfig, VITConfig

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


# the sizes of tests/test_composed_parity.py
VCFG = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4,
            embed_dim=32)
TCFG = dict(vocab_size=128, context_length=16, width=64, layers=2, heads=4,
            embed_dim=32)
J_CFG = j_clip.CLIPConfig(vision=JVITConfig(**VCFG), text=JTextConfig(**TCFG))
T_CFG = clip.CLIPConfig(vision=VITConfig(**VCFG), text=TextConfig(**TCFG))


@pytest.fixture(scope="module")
def pair():
    params = j_clip.init(jax.random.key(0), J_CFG)
    tree = jax.tree.map(np.asarray, params)
    return params, convert_jax.from_jax_params(tree, T_CFG)


def _images(seed, b=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 32, 32, 3)).astype(np.float32)


def _tokens(seed, b=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 120, (b, 16)).astype(np.int32)
    for r, n in enumerate(rng.integers(3, 14, b)):
        toks[r, n] = 127              # EOT: the highest id
        toks[r, n + 1:] = 0
    return toks


@pytest.mark.parametrize("jax_attn", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("normalize", [True, False])
def test_image_tower_f32_matches_jax(pair, jax_attn, normalize):
    params, model = pair
    x = _images(1)
    want = np.asarray(j_clip.encode_image(
        params, jnp.asarray(x), J_CFG, compute_dtype=jnp.float32,
        normalize=normalize, attn_impl=jax_attn))
    got = clip.encode_image(model, torch.from_numpy(x), torch.float32,
                            normalize=normalize).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_text_tower_f32_matches_jax(pair):
    params, model = pair
    toks = _tokens(2)
    want = np.asarray(j_clip.encode_text(params, jnp.asarray(toks), J_CFG,
                                         compute_dtype=jnp.float32))
    got = clip.encode_text(model, torch.from_numpy(toks),
                           torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


_BIASES = ("bq", "bk", "bv", "bo", "b1", "b2")


def with_seeded_biases(params, seed: int, std: float = 0.3):
    """A numpy copy of a CLIP tree whose attention and MLP biases are
    N(0, std) from numpy (`clip.init` zeroes them; real CLIP checkpoints
    do not)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, params)
    for tower in ("visual", "text"):
        blocks = out[tower]["blocks"]
        for group in ("attn", "mlp"):
            for name, leaf in blocks[group].items():
                if name in _BIASES:
                    blocks[group][name] = (rng.standard_normal(leaf.shape)
                                           * std).astype(leaf.dtype)
    return out


def test_towers_bf16_cosine_to_jax(pair):
    _bf16_cosine_to_jax(*pair)


def test_towers_bf16_cosine_to_jax_with_nonzero_biases(pair):
    params = with_seeded_biases(pair[0], seed=8)
    _bf16_cosine_to_jax(params, convert_jax.from_jax_params(params, T_CFG))


def _bf16_cosine_to_jax(params, model):
    x, toks = _images(3), _tokens(4)
    ji = np.asarray(j_clip.encode_image(params, jnp.asarray(x), J_CFG,
                                        attn_impl="pallas_interpret"))
    ti = clip.encode_image(model, torch.from_numpy(x)).numpy()
    jt = np.asarray(j_clip.encode_text(params, jnp.asarray(toks), J_CFG))
    tt = clip.encode_text(model, torch.from_numpy(toks)).numpy()
    assert (ji * ti).sum(1).min() >= 0.999
    assert (jt * tt).sum(1).min() >= 0.999


def test_patchify_order_matches_jax():
    x = _images(5, b=2)
    want = np.asarray(j_vit.patchify(jnp.asarray(x), 8))
    np.testing.assert_array_equal(vit.patchify(torch.from_numpy(x), 8)
                                  .numpy(), want)


def test_similarity_and_zeroshot_match_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal((3, 32)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    np.testing.assert_allclose(
        clip.zeroshot_probs(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_clip.zeroshot_probs(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)
    ls = np.float32(np.log(1 / 0.07))
    np.testing.assert_allclose(
        clip.similarity_logits(torch.from_numpy(a), torch.from_numpy(b),
                               torch.tensor(ls)).numpy(),
        np.asarray(j_clip.similarity_logits(jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(ls))), atol=1e-4)


def test_npz_with_bf16_leaves_loads_identically(pair, tmp_path):
    params, _ = pair
    # the vision tower stored as bf16 (the `@bf16` marker), the rest f32
    mixed = dict(params, visual=jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), params["visual"]))
    path = str(tmp_path / "w.npz")
    j_checkpoint.save_npz(mixed, path)
    want = j_checkpoint.load_npz(path, to_device=False)
    got = checkpoint.load_npz(path)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(jax.tree.leaves(got))
    for keypath, w in flat_w:
        g = got
        for kp in keypath:
            g = g[kp.key]
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    model = convert_jax.load_npz(path, T_CFG)
    np.testing.assert_array_equal(
        model.visual.patch_embed.weight.detach().numpy(),
        np.asarray(mixed["visual"]["patch_kernel"], np.float32).T)
    np.testing.assert_array_equal(
        model.text.blocks[1].mlp.w2.weight.detach().numpy(),
        np.asarray(params["text"]["blocks"]["mlp"]["w2"][1]).T)


def test_int8_checkpoints_are_refused(tmp_path):
    """An int8 weight is a pair of arrays (codes and scales; the int8
    towers load them, tests/test_torch_quantized_tower.py): a checkpoint
    that holds only one half of a pair is refused, as mmrs_tpu refuses it."""
    path = str(tmp_path / "q.npz")
    np.savez(path, **{"visual/blocks/mlp/w1@int8q": np.zeros((2, 2), np.int8),
                      "visual/proj": np.ones((2, 2), np.float32)})
    with pytest.raises(ValueError, match="missing half"):
        checkpoint.load_npz(path)
