"""The port's LLaMA decoder (models/llama.py, layers.matmul,
quantize.quantize_llama) against mmrs_tpu's, on the JAX tests' tiny config.

One JAX `llama.init` tree feeds both packages (convert_jax.from_jax_llama).
The port's "einsum" route is JAX's XLA form (decode_attn="xla"), its
"auto" route the K10 / K11 plain versions against JAX's Pallas kernels in
interpret mode. Tolerances: logits 2e-5 in f32 on the einsum route (the
same f32 products, summed in other orders) and 2e-4 on the kernel route
(there the probabilities are rounded to bf16, and a last-bit difference
of exp() flips a rounding now and then); 3e-2 in bf16 (a bf16 ulp at
|logit| ~ 4, from activations rounded in other orders); KV caches
likewise; greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.models import llama as j_llama
from mmrs_tpu.models import quantize as j_quantize
from mmrs_tpu.ops import decode_attention as j_da
from mmrs_tpu_torch.models import convert_jax, layers
from mmrs_tpu_torch.models import llama as t_llama
from mmrs_tpu_torch.models import quantize as t_quantize

torch.set_num_threads(2)

J_CFG = j_llama.LlamaConfig(vocab_size=128, dim=64, layers=2, heads=4,
                            kv_heads=2, mlp_dim=128, max_seq=256)
T_CFG = t_llama.LlamaConfig(**J_CFG.__dict__)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {("f32", "einsum"): 2e-5, ("f32", "auto"): 2e-4,
       ("bf16", "einsum"): 3e-2, ("bf16", "auto"): 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture
def pallas_interpret(monkeypatch):
    """JAX's Pallas kernels run in interpret mode (the CPU has no other)."""
    for name in ("decode_attention", "chunk_attention"):
        orig = getattr(j_da, name)
        monkeypatch.setattr(j_da, name, lambda *a, _f=orig, **kw: _f(
            *a, interpret=True, **kw))


@pytest.fixture(scope="module")
def pair():
    params = j_llama.init(jax.random.key(0), J_CFG)
    model = convert_jax.from_jax_llama(jax.tree.map(np.asarray, params),
                                       T_CFG)
    return params, model


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(3, J_CFG.vocab_size, (b, t))


def _embeds(params, model, toks):
    return (j_llama.embed_tokens(params, jnp.asarray(toks, jnp.int32)),
            t_llama.embed_tokens(model, torch.from_numpy(toks)))


def _jax_routes(route):
    if route == "einsum":
        return {}
    return dict(decode_attn="pallas", prefill_attn="pallas", layers="fori")


def test_matmul_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    lin = torch.nn.Linear(64, 48, bias=False).requires_grad_(False)
    lin.weight.copy_(torch.from_numpy(w.T))
    for jd, td in DTYPES.values():
        for out in (None, (jnp.float32, torch.float32)):
            want = np.asarray(j_llama.matmul(
                jnp.asarray(x), jnp.asarray(w), jd,
                out_dtype=out and out[0]), np.float32)
            got = layers.matmul(torch.from_numpy(x), lin, td,
                                out_dtype=out and out[1])
            assert got.dtype == (out[1] if out else td)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                                       atol=1e-6)
    # int8: the same codes, scales and acc * sx * s epilogue
    q = j_quantize.quantize_tree({"wq": jnp.asarray(w)})["wq"]
    qlin = layers.QLinear.from_linear(lin)
    np.testing.assert_array_equal(qlin.q.numpy().T, np.asarray(q.q))
    np.testing.assert_array_equal(qlin.s.numpy(), np.asarray(q.s))
    want = np.asarray(j_llama.matmul(jnp.asarray(x), q, jnp.float32))
    got = layers.matmul(torch.from_numpy(x), qlin, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("route", ["einsum", "auto"])
def test_forward_logits_and_cache(pair, pallas_interpret, dt, kv, route):
    """One 70-token forward into a 128-slot cache, then a T=1 step."""
    params, model = pair
    jd, td = DTYPES[dt]
    tol = TOL[dt, route]
    je, te = _embeds(params, model, _tokens(1, 2, 71))
    jcache = j_llama.init_cache(J_CFG, 2, jnp.int8 if kv else jd, 128)
    tcache = t_llama.init_cache(T_CFG, 2, torch.int8 if kv else td, 128)
    jl, jcache = j_llama.forward(params, je[:, :70], jcache, 0, J_CFG, jd,
                                 **_jax_routes(route))
    tl, tcache = t_llama.forward(model, te[:, :70], tcache, 0, td,
                                 attn=route)
    assert tl.dtype == torch.float32 and tl.shape == (2, 70, 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                               rtol=tol)
    if kv:   # dequantized entries; a code may move where its input moved
        for jc, tc in zip(jcache, tcache):
            np.testing.assert_allclose(tc.s.numpy(), np.asarray(jc.s),
                                       rtol=tol, atol=1e-6)
            got = tc.q.numpy() * tc.s.numpy()[..., None]
            want = np.asarray(jc.q, np.float32) * np.asarray(jc.s)[..., None]
            step = np.asarray(jc.s)[..., None]
            assert (np.abs(got - want) <= 2 * step + tol).all()
    else:
        for jc, tc in zip(jcache, tcache):
            np.testing.assert_allclose(tc.float().numpy(),
                                       np.asarray(jc, np.float32),
                                       atol=tol, rtol=tol)
    jl, _ = j_llama.forward(params, je[:, 70:], jcache, 70, J_CFG, jd,
                            **_jax_routes(route))
    tl, _ = t_llama.forward(model, te[:, 70:], tcache, 70, td, attn=route)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                               rtol=tol)


def test_chunked_prefill_and_kv_limit_view(pair):
    """A 64-slot kv_limit reads cache[:, :, :64] of the layer view: the
    same logits as the whole 128-slot cache (the mask hides the rest)."""
    _, model = pair
    te = t_llama.embed_tokens(model, torch.from_numpy(_tokens(2, 2, 40)))
    for attn in ("auto", "einsum"):
        a, _ = t_llama.forward(model, te, t_llama.init_cache(
            T_CFG, 2, torch.float32, 128), 0, torch.float32, attn=attn)
        b, _ = t_llama.forward(model, te, t_llama.init_cache(
            T_CFG, 2, torch.float32, 128), 0, torch.float32, kv_limit=64,
            attn=attn)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("opts", [
    {},
    {"prefill_chunk": 16},
    {"prefill_chunk": 32, "decode_window": 4, "early_stop": True},
])
def test_greedy_tokens_equal_jax(pair, pallas_interpret, kv, opts):
    params, model = pair
    je, te = _embeds(params, model, _tokens(3, 2, 70))
    jkv, tkv = (jnp.int8, torch.int8) if kv else (None, None)
    for route in ("einsum", "auto"):
        want = np.asarray(j_llama.greedy_generate(
            params, je, J_CFG, max_new_tokens=8, eos_token=-1,
            compute_dtype=jnp.float32, kv_dtype=jkv, **opts,
            **_jax_routes(route)))
        got = t_llama.greedy_generate(model, te, 8, eos_token=-1,
                                      compute_dtype=torch.float32,
                                      kv_dtype=tkv, attn=route, **opts)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=route)


def test_early_stop_and_eos_padding(pair):
    """EOS mid-generation: early_stop gives the same EOS-padded tokens."""
    params, model = pair
    je, te = _embeds(params, model, _tokens(4, 2, 6))
    ref = t_llama.greedy_generate(model, te, 10, eos_token=-1,
                                  compute_dtype=torch.float32)
    eos = int(ref[0, 3])
    want = np.asarray(j_llama.greedy_generate(
        params, je, J_CFG, max_new_tokens=10, eos_token=eos,
        compute_dtype=jnp.float32))
    for es in (False, True):
        for dw in (None, 4):
            got = t_llama.greedy_generate(
                model, te, 10, eos_token=eos, compute_dtype=torch.float32,
                decode_window=dw, early_stop=es)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def int8_pair(pair):
    params, _ = pair
    jq = j_quantize.quantize_llama(params)
    model = t_quantize.quantize_llama(convert_jax.from_jax_llama(
        jax.tree.map(np.asarray, params), T_CFG))
    return jq, model


def test_int8_weights_greedy_equal_jax(int8_pair):
    """quantize_llama: the same int8 codes and scales (lm_head too), and
    the same tokens through the int8 matmuls and the int8 KV cache (f32
    compute: bf16 roundings in other orders flip near-tied tokens of a
    random tiny model, which the bf16 test below bounds instead)."""
    jq, model = int8_pair
    assert isinstance(model.lm_head, layers.QLinear)
    np.testing.assert_array_equal(model.blocks[1].w_up.q.numpy().T,
                                  np.asarray(jq["blocks"]["w_up"].q[1]))
    np.testing.assert_array_equal(model.lm_head.s.numpy(),
                                  np.asarray(jq["lm_head"].s))
    je, te = _embeds(jq, model, _tokens(5, 2, 20))
    want = np.asarray(j_llama.greedy_generate(
        jq, je, J_CFG, max_new_tokens=8, eos_token=-1,
        compute_dtype=jnp.float32, kv_dtype=jnp.int8, prefill_chunk=8))
    got = t_llama.greedy_generate(model, te, 8, eos_token=-1,
                                  compute_dtype=torch.float32,
                                  kv_dtype=torch.int8, prefill_chunk=8,
                                  attn="einsum")
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_weights_bf16_logits(int8_pair):
    """bf16 compute on int8 weights: prefill logits within 3e-2 (one bf16
    ulp of an activation can move one of its row's int8 codes by one)."""
    jq, model = int8_pair
    je, te = _embeds(jq, model, _tokens(5, 2, 20))
    jl, _ = j_llama.prefill(jq, je, J_CFG, 64, jnp.bfloat16, jnp.int8)
    tl, _ = t_llama.prefill(model, te, 64, torch.bfloat16, torch.int8,
                            attn="einsum")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=3e-2,
                               rtol=3e-2)


def test_kv_quantizer_and_per_row_write():
    """_quantize_kv's codes and scales equal JAX's jitted ones; a [B]
    position write equals per-row scalar writes."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 2, 5, 16)).astype(np.float32)
    jq, js = jax.jit(j_llama._quantize_kv)(jnp.asarray(x))
    tq, ts = t_llama._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    cache = torch.zeros((3, 2, 2, 12, 16))
    new = torch.from_numpy(rng.standard_normal((2, 2, 3, 16)).astype(
        np.float32))
    t_llama._write(cache, 1, new, torch.tensor([4, 7]))
    want = torch.zeros_like(cache)
    want[1, 0, :, 4:7] = new[0]
    want[1, 1, :, 7:10] = new[1]
    torch.testing.assert_close(cache, want, rtol=0, atol=0)


def test_guards_and_routes(pair):
    _, model = pair
    te = torch.zeros((1, 250, 64))
    with pytest.raises(ValueError, match="max_seq"):
        t_llama.greedy_generate(model, te, 10)
    with pytest.raises(ValueError, match="unknown attn"):
        t_llama.forward(model, te[:, :2], t_llama.init_cache(
            T_CFG, 1, torch.float32, 64), 0, attn="xla")


def test_init_distributions():
    """Random init from a torch generator, with the JAX init's spreads."""
    cfg = t_llama.LlamaConfig(vocab_size=512, dim=128, layers=2, heads=4,
                              kv_heads=2, mlp_dim=256)
    m = t_llama.Llama(cfg, generator=torch.Generator().manual_seed(0))
    for w in (m.embed, m.blocks[0].wq.weight, m.lm_head.weight):
        assert abs(float(w.detach().std()) - 0.02) < 0.002
    assert bool((m.blocks[1].attn_norm == 1).all())
