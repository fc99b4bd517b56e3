"""The port's LLaVA (models/llava.py, the ViT's hidden states, the
projector, quantize_llava), its converter and npz checkpoints both ways,
and its SentencePiece copy, against mmrs_tpu's.

One JAX `llava.init` tree (a 32-px, 8-px-patch ViT and the tiny LLaMA)
feeds both packages; images and prompts are seeded numpy arrays.
Tolerances: vision tokens and image embeddings 1e-5 in f32 (the same f32
products in other orders); greedy tokens equal; checkpoints bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import llava as j_llava
from mmrs_tpu.models import quantize as j_quantize
from mmrs_tpu.models import sentencepiece as j_sp
from mmrs_tpu.models.configs import VITConfig as JVITConfig
from mmrs_tpu.models.llama import LlamaConfig as JLlamaConfig
from mmrs_tpu.ops import decode_attention as j_da
from mmrs_tpu_torch.models import checkpoint, convert_jax
from mmrs_tpu_torch.models import llava as t_llava
from mmrs_tpu_torch.models import quantize as t_quantize
from mmrs_tpu_torch.models import sentencepiece as t_sp
from mmrs_tpu_torch.models.configs import VITConfig
from mmrs_tpu_torch.models.layers import QLinear
from mmrs_tpu_torch.models.llama import LlamaConfig

torch.set_num_threads(2)

J_V = JVITConfig(image_size=32, patch_size=8, width=48, layers=3, heads=4,
                 embed_dim=32)
J_L = JLlamaConfig(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2,
                   mlp_dim=128, max_seq=128)
J_CFG = j_llava.LLaVAConfig(vision=J_V, lm=J_L)
T_CFG = t_llava.LLaVAConfig(vision=VITConfig(**J_V.__dict__),
                            lm=LlamaConfig(**J_L.__dict__))
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def pair():
    params = j_llava.init(jax.random.key(0), J_CFG)
    model = convert_jax.from_jax_llava(jax.tree.map(np.asarray, params),
                                       T_CFG)
    return params, model


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    pre = np.tile(rng.integers(3, 120, (1, 5)), (b, 1))
    post = np.tile(rng.integers(3, 120, (1, 4)), (b, 1))
    return images, pre, post


def test_vision_tokens_and_image_embeds(pair):
    params, model = pair
    images, _, _ = _inputs(0)
    want = np.asarray(j_llava.vision_tokens(
        params["visual"], jnp.asarray(images), J_CFG, jnp.float32))
    got = t_llava.vision_tokens(model, torch.from_numpy(images), F32)
    assert got.shape == (2, 16, 48)          # 16 patches, CLS dropped
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    want = np.asarray(j_llava.encode_images(params, jnp.asarray(images),
                                            J_CFG, jnp.float32))
    got = t_llava.encode_images(model, torch.from_numpy(images), F32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("opts", [
    {},
    {"kv_dtype": "int8", "prefill_chunk": 8, "early_stop": True},
])
def test_generate_equals_jax(pair, monkeypatch, opts):
    """Greedy VQA tokens: the einsum route against JAX's XLA form and the
    kernel route (K10/K11 plain versions) against JAX's Pallas kernels in
    interpret mode."""
    params, model = pair
    images, pre, post = _inputs(1)
    for name in ("decode_attention", "chunk_attention"):
        orig = getattr(j_da, name)
        monkeypatch.setattr(j_da, name, lambda *a, _f=orig, **kw: _f(
            *a, interpret=True, **kw))
    kv = opts.get("kv_dtype")
    j_opts = dict(opts, kv_dtype=jnp.int8 if kv else None)
    t_opts = dict(opts, kv_dtype=torch.int8 if kv else None)
    for route, j_route in (("einsum", {}), ("auto", dict(
            decode_attn="pallas", prefill_attn="pallas", layers="fori"))):
        want = np.asarray(j_llava.generate(
            params, jnp.asarray(images), jnp.asarray(pre, jnp.int32),
            jnp.asarray(post, jnp.int32), J_CFG, max_new_tokens=6,
            eos_token=-1, compute_dtype=jnp.float32, **j_opts, **j_route))
        got = t_llava.generate(
            model, torch.from_numpy(images), torch.from_numpy(pre),
            torch.from_numpy(post), 6, -1, F32, attn=route, **t_opts)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=route)


def test_quantize_llava_equals_jax(pair):
    """The same int8 codes in the tower and the decoder; the projector
    stays float; the same greedy tokens through the int8 MLP's plain
    version (K6) and the int8 decoder."""
    params, _ = pair
    jq = j_quantize.quantize_llava(params)
    model = t_quantize.quantize_llava(convert_jax.from_jax_llava(
        jax.tree.map(np.asarray, params), T_CFG))
    assert isinstance(model.visual.blocks[0].mlp.w1, QLinear)
    assert isinstance(model.lm.lm_head, QLinear)
    assert isinstance(model.proj1, torch.nn.Linear)
    np.testing.assert_array_equal(
        model.visual.blocks[2].mlp.w2.q.numpy().T,
        np.asarray(jq["visual"]["blocks"]["mlp"]["w2"].q[2]))
    images, pre, post = _inputs(2)
    want = np.asarray(j_llava.generate(
        jq, jnp.asarray(images), jnp.asarray(pre, jnp.int32),
        jnp.asarray(post, jnp.int32), J_CFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8))
    got = t_llava.generate(model, torch.from_numpy(images),
                           torch.from_numpy(pre), torch.from_numpy(post), 6,
                           -1, F32, kv_dtype=torch.int8, attn="einsum")
    np.testing.assert_array_equal(got.numpy(), want)


def _np(x):
    """A leaf as numpy; bf16 widened to f32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _leaves(tree, prefix=""):
    """flat key -> numpy array; int8 weights as two entries."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_leaves(v, key))
        elif hasattr(v, "_fields"):
            out[key + "@q"], out[key + "@s"] = _np(v.q), _np(v.s)
        else:
            out[key] = _np(v)
    return out


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_checkpoints_both_ways(kind, tmp_path):
    """llava_tree inverts from_jax_llava; an npz written by either
    package's save_npz loads in the other with every value equal."""
    params = j_llava.init(jax.random.key(3), J_CFG, jnp.bfloat16)
    if kind == "int8":
        params = j_quantize.quantize_llava(params)
    want = _leaves(params)

    j_path = str(tmp_path / "jax.npz")
    j_checkpoint.save_npz(params, j_path)
    model = convert_jax.from_jax_llava(checkpoint.load_npz(j_path), T_CFG)
    assert model.lm.embed.dtype == torch.bfloat16
    tree = convert_jax.llava_tree(model)
    got = _leaves(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    t_path = str(tmp_path / "torch.npz")
    checkpoint.save_npz(tree, t_path)
    with np.load(t_path) as z, np.load(j_path) as zj:
        assert sorted(z.files) == sorted(zj.files)
    back = _leaves(j_checkpoint.load_npz(t_path, to_device=False))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _sp_model():
    P = j_sp.Piece
    pieces = [P("<unk>", 0.0, 2), P("<s>", 0.0, 3), P("</s>", 0.0, 3)]
    pieces += [P(f"<0x{b:02X}>", -100.0, 6) for b in range(256)]
    pieces += [P(ch, -10.0, 1) for ch in "acto" + j_sp.SPACE]
    pieces += [P("ca", -1.0, 1), P("cat", -0.5, 1),
               P(j_sp.SPACE + "cat", -0.2, 1), P(j_sp.SPACE + "a", -1.5, 1)]
    return pieces


def test_sentencepiece_copy_same_ids(tmp_path):
    p = tmp_path / "tok.model"
    p.write_bytes(j_sp.serialize_model(_sp_model()))
    jt = j_sp.SentencePieceBPE.from_file(str(p))
    tt = t_sp.SentencePieceBPE.from_file(str(p))
    for text in ("a cat", "cat", "caté", "Does this image contain a cat?",
                 "\n" + "a cat ASSISTANT:"):
        for bos in (True, False):
            assert tt.encode(text, add_bos=bos) == jt.encode(text,
                                                             add_bos=bos)
        ids = jt.encode(text)
        assert tt.decode(ids + [400, 2]) == jt.decode(ids + [400, 2])
    assert t_sp.serialize_model(t_sp.parse_model(p.read_bytes())) == \
        p.read_bytes()
