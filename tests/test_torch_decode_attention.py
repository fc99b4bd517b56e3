"""K10 (`chunk_attention`) and K11 (`decode_attention`): the port's plain
versions against mmrs_tpu's Pallas kernels in interpret mode.

Seeded numpy caches (bf16, or int8 codes with f32 scales made once and fed
to both packages) and queries go through both. Tolerance: 2e-5 absolute
and relative on the f32 outputs (both sum the same exact bf16 products in
f32, in different orders; the probabilities are rounded to bf16 in both,
and a last-bit difference of exp() may flip one such rounding, which the
outputs' scale keeps under 2e-3: the bound checked is max(2e-5 abs+rel,
that flip on at most 1% of the elements)).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrs_tpu.ops import decode_attention as j_da
from mmrs_tpu_torch.models.llama import _quantize_kv
from mmrs_tpu_torch.ops import decode_attention as t_da

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _cache(rng, shape, quantized):
    """(k, ks, v, vs) as torch tensors: bf16, or int8 + f32 scales."""
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if not quantized:
        return k.to(torch.bfloat16), None, v.to(torch.bfloat16), None
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    return kq, ks, vq, vs


def _j(x):
    """torch -> jnp (bf16 through f32, which is exact)."""
    if x is None:
        return None
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return jnp.asarray(x.numpy())


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.shape == want.shape
    bad = np.abs(got - want) > 2e-5 + 2e-5 * np.abs(want)
    # a flipped bf16 rounding of one probability moves an output by at
    # most 2^-8 of that probability times |v| (|v| < 5 here)
    assert bad.mean() <= 0.01, bad.mean()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("pos", [0, 5, 63])
@pytest.mark.parametrize("g", [1, 2])
def test_decode_plain_matches_pallas(quantized, pos, g):
    rng = np.random.default_rng(pos + 10 * g)
    b, kvh, hd, s = 2, 2, 64, 64
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, ks, v, vs = _cache(rng, (b, kvh, s, hd), quantized)
    want = j_da.decode_attention(_j(q), _j(k), _j(ks), _j(v), _j(vs), pos,
                                 interpret=True)
    got = t_da.decode_attention(q, k, ks, v, vs, pos)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("quantized", [True, False])
def test_decode_per_row_positions_and_stacked_layer(quantized):
    """[B] positions over layer 1 of a stacked [L, ...] cache: the port's
    cache[1] view against JAX's scalar-prefetched layer index."""
    rng = np.random.default_rng(5)
    L, b, kvh, g, hd, s = 3, 3, 2, 4, 64, 64
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, ks, v, vs = _cache(rng, (L, b, kvh, s, hd), quantized)
    pos = torch.tensor([2, 31, 63], dtype=torch.int32)
    want = j_da.decode_attention(_j(q), _j(k), _j(ks), _j(v), _j(vs),
                                 jnp.asarray(pos.numpy()), layer=1,
                                 interpret=True)
    sl = (lambda x: None if x is None else x[1])
    got = t_da.decode_attention(q, k[1], sl(ks), v[1], sl(vs), pos)
    _close(got, want)
    for i in range(b):     # each row alone, at its own scalar position
        one = t_da.decode_attention(
            q[i:i + 1], k[1, i:i + 1], None if ks is None else ks[1, i:i + 1],
            v[1, i:i + 1], None if vs is None else vs[1, i:i + 1],
            int(pos[i]))
        torch.testing.assert_close(one, got[i:i + 1], rtol=0, atol=0)


@pytest.mark.parametrize("fn", ["decode", "chunk"])
def test_dead_tail_is_masked(fn):
    """Slots past the last query position contribute exactly nothing."""
    rng = np.random.default_rng(1)
    b, kvh, g, hd, s, pos = 1, 2, 2, 64, 64, 7
    shape = (b, kvh, g, hd) if fn == "decode" else (b, kvh, g, 3, hd)
    q = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
    k, ks, v, vs = _cache(rng, (b, kvh, s, hd), True)
    call = t_da.decode_attention if fn == "decode" else t_da.chunk_attention
    last = pos if fn == "decode" else pos + 2
    out1 = call(q, k, ks, v, vs, pos)
    k2, v2, ks2, vs2 = k.clone(), v.clone(), ks.clone(), vs.clone()
    k2[:, :, last + 1:] = 127
    v2[:, :, last + 1:] = -127
    ks2[:, :, last + 1:] = 1e6
    vs2[:, :, last + 1:] = 1e6
    torch.testing.assert_close(call(q, k2, ks2, v2, vs2, pos), out1,
                               rtol=0, atol=0)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("pos,c,g,kv_limit", [
    (0, 8, 1, None),        # first chunk, no window
    (5, 8, 2, None),        # chunk inside the cache, G > 1
    (56, 8, 1, 64),         # the chunk ending at a 64-slot window
    (0, 16, 2, 64),         # a window cutting a 128-slot cache
    (63, 1, 4, None),       # one row (the kernel's T=1 edge)
])
def test_chunk_plain_matches_pallas(quantized, pos, c, g, kv_limit):
    rng = np.random.default_rng(pos + c + g)
    b, kvh, hd, s = 2, 2, 64, 128
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, c, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, ks, v, vs = _cache(rng, (b, kvh, s, hd), quantized)
    want = j_da.chunk_attention(_j(q), _j(k), _j(ks), _j(v), _j(vs), pos,
                                kv_limit=kv_limit, interpret=True)
    got = t_da.chunk_attention(q, k, ks, v, vs, pos, kv_limit=kv_limit)
    _close(got, want)


@pytest.mark.parametrize("quantized", [True, False])
def test_chunk_per_row_positions_stacked(quantized):
    """Speculative decode's T=k+1 verify pass: [B] chunk starts over a
    stacked cache's layer view."""
    rng = np.random.default_rng(9)
    L, b, kvh, g, c, hd, s = 2, 3, 2, 2, 5, 64, 64
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, c, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, ks, v, vs = _cache(rng, (L, b, kvh, s, hd), quantized)
    pos = torch.tensor([0, 17, 59], dtype=torch.int32)
    want = j_da.chunk_attention(_j(q), _j(k), _j(ks), _j(v), _j(vs),
                                jnp.asarray(pos.numpy()), layer=0,
                                interpret=True)
    sl = (lambda x: None if x is None else x[0])
    got = t_da.chunk_attention(q, k[0], sl(ks), v[0], sl(vs), pos)
    _close(got, want)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("hd", [80, 96, 256, 100, 288, 576])
def test_decode_and_chunk_plain_match_pallas_at_any_head_dim(quantized, hd):
    """Head dims between and past the 64 / 128 instances (LLaMA-family
    80, 96 and 256; the kernels run them on the smallest instance that
    holds them, zero past hd; 100 and 288 on a copy padded to 8 and on
    the 512 instance): K11's and K10's plain versions against the Pallas
    bodies at that hd."""
    rng = np.random.default_rng(hd + quantized)
    b, kvh, g, c, s = 2, 2, 2, 5, 64
    k, ks, v, vs = _cache(rng, (b, kvh, s, hd), quantized)
    q1 = torch.from_numpy(rng.standard_normal((b, kvh, g, hd)).astype(
        np.float32)).to(torch.bfloat16)
    for pos in (0, 40):
        want = j_da.decode_attention(_j(q1), _j(k), _j(ks), _j(v), _j(vs),
                                     pos, interpret=True)
        _close(t_da.decode_attention(q1, k, ks, v, vs, pos), want)
    qc = torch.from_numpy(rng.standard_normal((b, kvh, g, c, hd)).astype(
        np.float32)).to(torch.bfloat16)
    want = j_da.chunk_attention(_j(qc), _j(k), _j(ks), _j(v), _j(vs), 30,
                                interpret=True)
    _close(t_da.chunk_attention(qc, k, ks, v, vs, 30), want)


@pytest.mark.parametrize("hd", [8, 32, 72, 80, 96, 136, 200, 264, 288, 504,
                                576, 1000])
def test_lane_logits_below_an_instance_equal_the_zero_padded_sum(hd):
    """K11's plain logits at hd < HDP follow the HDP instance's lane tree:
    bit for bit the sum over q and k zero-padded to HDP, whose lanes
    (HDP / 8 of 8 elements; 32 of 16 at 512) pair up as the kernel's
    shuffles do."""
    rng = np.random.default_rng(hd)
    hdp = t_da.padded_head_dim(hd)
    assert hdp in t_da.HEAD_DIMS and hdp >= hd
    q = torch.from_numpy(rng.standard_normal((2, 1, 3, 1, hd)).astype(
        np.float32)).bfloat16().float()
    k = torch.from_numpy(rng.standard_normal((2, 1, 50, hd)).astype(
        np.float32)).bfloat16().float()
    pad = torch.nn.functional.pad
    got = t_da._lane_logits(q, k)
    want = t_da._lane_logits(pad(q, (0, hdp - hd)), pad(k, (0, hdp - hd)))
    assert torch.equal(got, want)
    assert float((got - q @ k[:, :, None].transpose(-1, -2)).abs().max()
                 ) < 1e-4


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hd", [512, 576, 1024])
def test_wide_head_dims_plan(hd, quant):
    """Past 512 K11 runs its 1024 instance at G <= 2 (pieces of two heads),
    a lane 32 elements of a key row (one warp a key); every plan fits a
    block's shared memory, and the ring holds the warps' [G, HDP] f32
    partials (csrc: the ring's static_assert)."""
    hdp = t_da.padded_head_dim(hd)
    top = 4 if hdp == 512 else 2
    assert hdp == (512 if hd <= 512 else 1024)
    assert t_da.lane_elems(hdp) == hdp // 32
    assert t_da.group_pieces(8, hd) == tuple(
        (s, top, top) for s in range(0, 8, top))
    assert t_da.group_pieces(3, hd)[-1][2] <= top
    keys = t_da.dec_keys(hdp, quant)
    stage = keys * (hdp * (1 if quant else 2) + 4)
    for g in (w for w in (1, 2, 4) if w <= top):
        assert 4 * stage >= 8 * g * hdp * 4
        for s, heads in ((704, 256), (704, 16), (8192, 2), (1, 1)):
            assert t_da.decode_plan(s, g, hd, quant, heads, 132).smem <= \
                t_da.SMEM_LIMIT


def test_chunk_rows_equal_decode_steps():
    """Row c of a chunk at pos is the decode step at pos + c."""
    rng = np.random.default_rng(3)
    b, kvh, g, c, hd, s = 2, 2, 2, 4, 64, 32
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, c, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, ks, v, vs = _cache(rng, (b, kvh, s, hd), True)
    out = t_da.chunk_attention(q, k, ks, v, vs, 10)
    for i in range(c):
        step = t_da.decode_attention(q[:, :, :, i], k, ks, v, vs, 10 + i)
        torch.testing.assert_close(out[:, :, :, i], step, rtol=1e-6,
                                   atol=1e-6)


def test_impl_switch_and_cpu_refusal():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 1, 1, 64)).astype(
        np.float32)).to(torch.bfloat16)
    k, _, v, _ = _cache(rng, (1, 1, 8, 64), False)
    a = t_da.decode_attention(q, k, None, v, None, 3, impl="torch")
    torch.testing.assert_close(t_da.decode_attention(q, k, None, v, None, 3),
                               a, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown impl"):
        t_da.decode_attention(q, k, None, v, None, 3, impl="pallas")
    # the kernel wrappers refuse a CPU tensor instead of running plain
    with pytest.raises(ValueError, match="CUDA"):
        t_da._decode_cuda(q, k, None, v, None, 3)
    with pytest.raises(ValueError, match="CUDA"):
        t_da._chunk_cuda(q[:, :, :, None], k, None, v, None, 3)


def test_kernel_sizing():
    """Shared memory the wrappers ask for, at the 7B and draft shapes."""
    # one 7B step (B * KVH = 256 heads) on a card holding 396 such blocks
    plan = t_da.decode_plan(704, 1, 128, False, 256, 396)
    assert plan == (1, 704, True, 4 * 64 * (128 * 2 + 4) + 4 * 704 + 76)
    assert t_da.decode_plan(704, 8, 64, True, 32, 132).smem <= \
        t_da.SMEM_LIMIT
    warps, smem = t_da.chunk_plan(64, 128, quant=False)   # one 7B chunk
    assert warps == 4 and smem == 5 * 2 * 64 * 136 <= t_da.SMEM_LIMIT
    assert t_da.chunk_plan(16, 64, quant=True)[0] == 1   # draft: G=8, C=2
    assert max(t_da.chunk_plan(5, hd, quant)[1] for hd in (64, 128)
               for quant in (False, True)) <= t_da.SMEM_LIMIT
    assert t_da.hd_scale(128) == float(np.float32(1 / 128 ** 0.5))


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_plan_from_shapes(g, hd, quant):
    """K11's launch comes from the shapes alone (S, G, HD, B * KVH and what
    the card holds): as many blocks a head as fill the card, at most 8,
    none with fewer than two 16 KB tiles unless S is one tile; the spans
    cover S with no empty block; the logits are kept while they fit
    their budget; any S up to DEC_MAX_SLOTS runs within one block's
    shared memory, and only past it does the plan refuse."""
    keys = t_da.dec_keys(hd, quant)
    assert keys * hd * (1 if quant else 2) <= 16384 and keys <= 128
    for heads, slots in ((256, 396), (32, 132), (2, 264), (1, 1)):
        for s in (1, 63, 64, 129, 704, 1000, 5000, 8192, 32768, 65536,
                  t_da.DEC_MAX_SLOTS):
            plan = t_da.decode_plan(s, g, hd, quant, heads, slots)
            tiles = -(-s // keys)
            assert 1 <= plan.cluster <= min(t_da.DEC_MAX_CLUSTER,
                                            max(1, slots // heads))
            assert plan.span % keys == 0
            assert plan.span >= min(2, tiles) * keys
            assert (plan.cluster - 1) * plan.span < s <= \
                plan.cluster * plan.span
            assert plan.cached == (4 * g * plan.span
                                   <= t_da.DEC_LOGIT_BUDGET)
            assert plan.smem <= t_da.SMEM_LIMIT
    # the 7B step fills the card with one block a head, the draft's 32
    # heads with clusters of 3 or 4, a lone head with 8
    assert t_da.decode_plan(704, g, hd, quant, 256, 396)[:2] == (
        1, -(-704 // keys) * keys)
    assert t_da.decode_plan(704, g, hd, quant, 32, 132)[:2] == (
        (4, 192) if keys == 64 else (3, 256))
    assert t_da.decode_plan(65536, g, hd, quant, 2, 264)[:2] == (8, 8192)
    assert t_da.decode_plan(32768, 8, hd, quant, 2, 264).cached is False
    for bad in (0, t_da.DEC_MAX_SLOTS + 1):
        with pytest.raises(ValueError, match="plans 1 <= S"):
            t_da.decode_plan(bad, g, hd, quant, 2, 264)
