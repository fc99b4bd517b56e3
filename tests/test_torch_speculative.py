"""The port's speculative decode (models/speculative.py) against mmrs_tpu's
and against its own greedy decode, on the JAX tests' tiny target and draft
(f32, where an argmax comparison is deterministic).

The same JAX `llama.init` trees feed both packages. Tokens and stats must
be equal: to JAX's speculative output, and to plain greedy decode (the
exactness contract), on both attention routes the port has on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.models import llama as j_llama
from mmrs_tpu.models.speculative import speculative_generate as j_spec
from mmrs_tpu_torch.models import convert_jax
from mmrs_tpu_torch.models import llama as t_llama
from mmrs_tpu_torch.models.speculative import speculative_generate

torch.set_num_threads(2)

J_T = j_llama.LlamaConfig(vocab_size=101, dim=64, layers=2, heads=4,
                          kv_heads=2, mlp_dim=128, max_seq=96)
J_D = j_llama.LlamaConfig(vocab_size=101, dim=32, layers=1, heads=2,
                          kv_heads=1, mlp_dim=64, max_seq=96)
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def models():
    jt = j_llama.init(jax.random.key(0), J_T, jnp.float32)
    jd = j_llama.init(jax.random.key(7), J_D, jnp.float32)
    tt = convert_jax.from_jax_llama(jax.tree.map(np.asarray, jt),
                                    t_llama.LlamaConfig(**J_T.__dict__))
    td = convert_jax.from_jax_llama(jax.tree.map(np.asarray, jd),
                                    t_llama.LlamaConfig(**J_D.__dict__))
    return jt, jd, tt, td


def _prompt(seed, b, t):
    return np.random.default_rng(seed).integers(3, 100, (b, t))


def _run(models, prompt, max_new, k, eos=-1, attn="einsum", **kw):
    jt, jd, tt, td = models
    te = t_llama.embed_tokens(tt, torch.from_numpy(prompt))
    de = t_llama.embed_tokens(td, torch.from_numpy(prompt))
    out, stats = speculative_generate(
        tt, td, te, de, max_new, k, eos, F32, return_stats=True, attn=attn,
        **kw)
    want = t_llama.greedy_generate(tt, te, max_new, eos, F32, attn=attn,
                                   kv_dtype=kw.get("kv_dtype"))
    return out, stats, want


def _jax(models, prompt, max_new, k, eos=-1, **kw):
    jt, jd, _, _ = models
    p = jnp.asarray(prompt, jnp.int32)
    out, stats = j_spec(jt, jd, j_llama.embed_tokens(jt, p),
                        j_llama.embed_tokens(jd, p), J_T, J_D,
                        max_new_tokens=max_new, draft_tokens=k,
                        eos_token=eos, compute_dtype=jnp.float32,
                        return_stats=True, **kw)
    return np.asarray(out), int(stats["rounds"]), np.asarray(stats["emitted"])


@pytest.mark.parametrize("k", [1, 3, 5])
def test_tokens_and_stats_equal_jax(models, k):
    prompt = _prompt(2, 3, 9)
    out, stats, want = _run(models, prompt, 14, k)
    j_out, j_rounds, j_emitted = _jax(models, prompt, 14, k)
    np.testing.assert_array_equal(out.numpy(), j_out)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert stats["rounds"] == j_rounds
    np.testing.assert_array_equal(stats["emitted"].numpy(), j_emitted)


@pytest.mark.parametrize("attn", ["einsum", "auto"])
def test_eos_desync_rows_int8kv_chunked(models, attn):
    """Rows finishing at different rounds, with the serving options (int8
    KV cache, chunked prefill), on both routes: greedy's tokens."""
    prompt = _prompt(3, 3, 10)
    _, _, free = _run(models, prompt, 16, 4, attn=attn)
    eos = int(free[0, 3])
    out, _, want = _run(models, prompt, 16, 4, eos=eos, attn=attn,
                        kv_dtype=torch.int8, prefill_chunk=4)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    j_out, _, _ = _jax(models, prompt, 16, 4, eos=eos, kv_dtype=jnp.int8,
                       prefill_chunk=4)
    if attn == "einsum":
        np.testing.assert_array_equal(out.numpy(), j_out)
    assert (want[0, 4:] == eos).all()


def test_identical_draft_accepts_everything(models):
    """draft == target: every round emits k+1 tokens; the round count is
    ceil((max_new - 1) / (k + 1)) (the frontier repair at work)."""
    _, _, tt, _ = models
    prompt = torch.from_numpy(_prompt(11, 2, 7))
    emb = t_llama.embed_tokens(tt, prompt)
    for attn in ("einsum", "auto"):
        out, stats = speculative_generate(tt, tt, emb, emb, 24, 3, -1, F32,
                                          return_stats=True, attn=attn)
        want = t_llama.greedy_generate(tt, emb, 24, -1, F32, attn=attn)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        assert stats["rounds"] == -(-(24 - 1) // 4)
        assert (stats["emitted"] == 24).all()


def test_per_row_forward_equals_row_by_row(models):
    """A [B] position forward (T=2, as the draft's step 0) writes and
    reads each row at its own slots: equal to each row alone."""
    _, _, tt, _ = models
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((3, 12, 64)).astype(
        np.float32))
    pos = torch.tensor([3, 7, 10])
    for kv in (F32, torch.int8):
        cache = t_llama.init_cache(tt.cfg, 3, kv, 16)
        t_llama.forward(tt, emb[:, :10], cache, 0, F32)
        lg, cache = t_llama.forward(tt, emb[:, 10:], cache, pos, F32)
        for i in range(3):
            one = t_llama.init_cache(tt.cfg, 1, kv, 16)
            t_llama.forward(tt, emb[i:i + 1, :10], one, 0, F32)
            want, one = t_llama.forward(tt, emb[i:i + 1, 10:], one,
                                        int(pos[i]), F32)
            torch.testing.assert_close(lg[i:i + 1], want, rtol=1e-5,
                                       atol=1e-5)
            got_k = cache[0].q[:, i] if kv == torch.int8 else cache[0][:, i]
            one_k = one[0].q[:, 0] if kv == torch.int8 else one[0][:, 0]
            torch.testing.assert_close(got_k[:, :, int(pos[i]):],
                                       one_k[:, :, int(pos[i]):],
                                       rtol=1e-5, atol=1e-5)


def test_guards(models):
    _, _, tt, td = models
    te = torch.zeros((1, 4, 64))
    de = torch.zeros((1, 4, 32))
    with pytest.raises(ValueError, match="max_seq"):
        speculative_generate(tt, td, te, de, max_new_tokens=1000)
    with pytest.raises(ValueError, match="aligned"):
        speculative_generate(tt, td, te, de[:, :3], max_new_tokens=4)
