"""The port's int4-weight LLaMA (layers.QLinear4, quantize_weight_int4,
unpack_int4, the `matmul` dispatch, quantize.quantize_llama_int4 and
convert_jax's int4 leaves) against mmrs_tpu's (tests/test_int4.py).

Packed bytes and scales must equal JAX's bit for bit (the port keeps the
bytes transposed for `nn.Linear`); unpacked kernels are equal in bf16 and
f32 (one rounding of code * scale in the compute dtype, as JAX). The
matmul dispatch agrees with JAX's within 1e-5 at f32 (the same products,
summed in other orders); greedy tokens of one int4 tree are equal in
both packages; and, as in JAX's own test, the int4 model's tokens and
logits equal those of the same model with every `QLinear4` dequantized
to a bf16 linear layer (the dispatch is the only difference).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.models import layers as j_layers
from mmrs_tpu.models import llama as j_llama
from mmrs_tpu.models import quantize as j_quantize
from mmrs_tpu_torch.models import convert_jax, layers
from mmrs_tpu_torch.models import llama as t_llama
from mmrs_tpu_torch.models import quantize as t_quantize

torch.set_num_threads(2)

J_CFG = j_llama.LlamaConfig(dim=256, heads=4, kv_heads=4, mlp_dim=512,
                            layers=2, vocab_size=128, max_seq=64)
T_CFG = t_llama.LlamaConfig(**J_CFG.__dict__)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.mark.parametrize("k,n,g", [(256, 128, 128), (512, 384, 128),
                                   (128, 64, 128), (256, 40, 64)])
def test_pack_and_unpack_equal_jax(k, n, g):
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                      # an all-zero channel: the 1e-12 floor
    want = j_layers.quantize_weight_int4(jnp.asarray(w), group=g)
    packed, s = layers.quantize_weight_int4(torch.from_numpy(w), g)
    assert packed.dtype == torch.int8 and packed.shape == (k // 2, n)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want.s))
    for jd, td in ((jnp.bfloat16, torch.bfloat16),
                   (jnp.float32, torch.float32)):
        ref = np.asarray(j_layers.unpack_int4(want, jd).astype(jnp.float32))
        got = layers.unpack_int4(packed, s, td)
        assert got.dtype == td
        np.testing.assert_array_equal(got.float().numpy(), ref)


def test_pack_unpack_exact_roundtrip():
    """Every representable int4 value survives pack -> unpack exactly,
    both nibbles, every sign."""
    rng = np.random.default_rng(0)
    w = rng.integers(-7, 8, (256, 128)).astype(np.float32)
    w[0, 0], w[1, 0] = 7.0, -7.0       # the scale of group 0, column 0
    packed, s = layers.quantize_weight_int4(torch.from_numpy(w) / 7.0, 128)
    got = layers.unpack_int4(packed, s, torch.float32).numpy()
    np.testing.assert_allclose(got, w / 7.0, rtol=1e-6, atol=1e-7)
    assert s.shape == (2, 128)


def test_quantize_rejects_bad_group():
    with pytest.raises(ValueError, match="multiple"):
        layers.quantize_weight_int4(torch.ones((96, 64)), group=64)
    lin = torch.nn.Linear(96, 64, bias=False)
    with pytest.raises(ValueError, match="multiple"):
        layers.QLinear4.from_linear(lin, group=64)


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32),
                                    (jnp.bfloat16, torch.bfloat16)])
def test_matmul_dispatch_matches_jax(dtypes):
    jd, td = dtypes
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((512, 384)) * 0.05).astype(np.float32)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    qt = j_layers.quantize_weight_int4(jnp.asarray(w), group=128)
    lin = torch.nn.Linear(512, 384, bias=False).requires_grad_(False)
    lin.weight.copy_(torch.from_numpy(w.T))
    q4 = layers.QLinear4.from_linear(lin, 128)
    np.testing.assert_array_equal(q4.packed.numpy().T, np.asarray(qt.packed))
    want = np.asarray(j_layers.matmul(jnp.asarray(x), qt, jd)
                      .astype(jnp.float32))
    got = layers.matmul(torch.from_numpy(x), q4, td)
    assert got.dtype == td
    tol = 1e-5 if td == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # and the dequantized oracle, exactly: the same weights, the same route
    deq = torch.nn.Linear(512, 384, bias=False).requires_grad_(False)
    deq.weight.copy_(layers.unpack_int4(q4.packed.T, q4.s, td).T)
    torch.testing.assert_close(q4.dequantize(td), deq.weight.to(td),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        got, layers.matmul(torch.from_numpy(x), deq, td), rtol=0, atol=0)


@pytest.fixture(scope="module")
def trees():
    params = j_llama.init(jax.random.key(0), J_CFG)
    return params, j_quantize.quantize_llama_int4(params, group=128)


def test_quantize_llama_int4_equals_jax(trees):
    """The port's module pass over JAX's key set gives JAX's tree: packed
    bytes and scales of every layer and the lm_head; the embedding stays
    float; convert_jax carries JAX's int4 leaves in, and llama_tree out."""
    params, p4 = trees
    model = t_quantize.quantize_llama_int4(convert_jax.from_jax_llama(
        jax.tree.map(np.asarray, params), T_CFG), group=128)
    assert isinstance(model.lm_head, layers.QLinear4)
    assert isinstance(model.embed, torch.nn.Parameter)
    loaded = convert_jax.from_jax_llama(p4, T_CFG)
    for m in (model, loaded):
        tree = convert_jax.llama_tree(m)
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            got, want = tree["blocks"][name], p4["blocks"][name]
            assert isinstance(got, convert_jax.QWeight4)
            np.testing.assert_array_equal(got.packed.numpy(),
                                          np.asarray(want.packed))
            np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
        np.testing.assert_array_equal(tree["lm_head"].packed.numpy(),
                                      np.asarray(p4["lm_head"].packed))


def _tokens():
    return np.array(jax.random.randint(jax.random.key(1), (2, 9), 3, 100,
                                         jnp.int32))


def test_greedy_tokens_equal_jax(trees):
    """One int4 tree through both packages' greedy decode (f32 compute:
    bf16 roundings in other orders flip near-tied tokens of a random tiny
    model)."""
    _, p4 = trees
    model = convert_jax.from_jax_llama(p4, T_CFG)
    toks = _tokens()
    je = j_llama.embed_tokens(p4, jnp.asarray(toks))
    te = t_llama.embed_tokens(model, torch.from_numpy(toks))
    want = np.asarray(j_llama.greedy_generate(
        p4, je, J_CFG, max_new_tokens=6, eos_token=-1,
        compute_dtype=jnp.float32))
    for attn in ("einsum", "auto"):
        got = t_llama.greedy_generate(model, te, 6, eos_token=-1,
                                      compute_dtype=torch.float32, attn=attn)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=attn)


def dequantized(model):
    """The same model with every QLinear4 replaced by the bf16 linear layer
    of its unpacked weights (JAX's oracle, tests/test_int4.py)."""
    import copy

    out = copy.deepcopy(model)
    for mod in list(out.modules()):
        for name, child in list(mod.named_children()):
            if isinstance(child, layers.QLinear4):
                w = layers.unpack_int4(child.packed.T, child.s,
                                       torch.bfloat16).T
                lin = torch.nn.Linear(w.shape[1], w.shape[0], bias=False,
                                      dtype=torch.bfloat16)
                lin.weight.data = w.contiguous()
                setattr(mod, name, lin.requires_grad_(False))
    return out


def test_int4_model_equals_its_dequantized_oracle(trees):
    """bf16 compute: the int4 dispatch's tokens and logits equal those of
    the explicitly dequantized bf16 model exactly."""
    params, _ = trees
    model = t_quantize.quantize_llama_int4(convert_jax.from_jax_llama(
        jax.tree.map(np.asarray, params), T_CFG))
    ref = dequantized(model)
    te = t_llama.embed_tokens(model, torch.from_numpy(_tokens()))
    got = t_llama.greedy_generate(model, te, 6, eos_token=-1)
    want = t_llama.greedy_generate(ref, te, 6, eos_token=-1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    cache = t_llama.init_cache(T_CFG, 2, torch.bfloat16, 64)
    a, _ = t_llama.forward(model, te, cache, 0)
    cache = t_llama.init_cache(T_CFG, 2, torch.bfloat16, 64)
    b, _ = t_llama.forward(ref, te, cache, 0)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_int4_halves_int8_bytes(trees):
    params, _ = trees

    def int8_bytes(model):
        return sum(b.numel() for b in model.buffers()
                   if b.dtype == torch.int8)

    def fresh():
        return convert_jax.from_jax_llama(jax.tree.map(np.asarray, params),
                                          T_CFG)

    b8 = int8_bytes(t_quantize.quantize_llama(fresh()))
    b4 = int8_bytes(t_quantize.quantize_llama_int4(fresh()))
    assert b4 * 2 == b8
    j8 = sum(x.size for x in jax.tree.leaves(j_quantize.quantize_llama(
        params)) if x.dtype == jnp.int8)
    assert b8 == j8
