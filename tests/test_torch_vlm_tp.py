"""The port's model axis (parallel/vlm.py, the TP paths of models/llama.py
and layers.row_parallel) against mmrs_tpu/parallel/vlm.py on the CPU.

The same weights (JAX `llama.init` / `llava.init` from a key, carried
over by models/convert_jax) and numpy-seeded prompts go through JAX's
`make_tp_*` on its 8-device CPU mesh (tests/conftest.py) and the port's
on `[cpu] * n` meshes (1x2, 2x2, 1x4), at f32 compute. Tokens must equal
JAX's and the port's one-device decode; prefill logits are within 1e-4 of
JAX's; int8-weight logits are bit-equal to the port's one-device int8
route; a checkpoint loaded straight into its placement is bit-equal to
the sharded one-device load.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from mmrs_tpu.models import llama as j_llama
from mmrs_tpu.models import llava as j_llava
from mmrs_tpu.models.configs import VITConfig as JVITConfig
from mmrs_tpu.models.llama import LlamaConfig as JLlamaConfig
from mmrs_tpu.models.quantize import quantize_llama as j_quantize_llama
from mmrs_tpu.parallel import vlm as j_vlm
from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from mmrs_tpu_torch.config import MeshConfig
from mmrs_tpu_torch.models import checkpoint, convert_jax, llama
from mmrs_tpu_torch.models import llava as t_llava
from mmrs_tpu_torch.models.configs import VITConfig
from mmrs_tpu_torch.models.llama import LlamaConfig
from mmrs_tpu_torch.models.quantize import (quantize_llama,
                                            quantize_llama_int4,
                                            quantize_llava)
from mmrs_tpu_torch.parallel import vlm
from mmrs_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
F32 = torch.float32

# tests/test_vlm_tp.py's LCFG; kv_heads 4 where the model axis is 4
LCFG = dict(vocab_size=96, dim=64, layers=2, heads=4, kv_heads=2,
            mlp_dim=128, max_seq=64)
LCFG4 = dict(LCFG, kv_heads=4)
SHAPES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _meshes(dp, tp):
    jm = JMesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
               (DATA_AXIS, MODEL_AXIS))
    tm = make_mesh(MeshConfig(data_size=dp, model_size=tp), [CPU] * (dp * tp))
    return jm, tm


def _llama(seed, cfg):
    """(JAX params, the port's Llama of them, its config)."""
    params = j_llama.init(jax.random.key(seed), JLlamaConfig(**cfg))
    tcfg = LlamaConfig(**cfg)
    return params, convert_jax.from_jax_llama(
        jax.tree.map(np.asarray, params), tcfg), tcfg


def _prompt(seed, b=4, t=5):
    return np.random.default_rng(seed).integers(3, 90, (b, t))


def test_specs_and_divisibility_follow_jax():
    specs = vlm.llama_param_specs()
    jspecs = j_vlm.llama_param_specs()
    assert set(specs) == set(jspecs)
    assert set(specs["blocks"]) == set(jspecs["blocks"])
    # column-parallel on the JAX kernel's N is the port's dim 0 (out),
    # row-parallel on K its dim 1 (in); replicated stays replicated
    for name, spec in jspecs["blocks"].items():
        want = {(None, None, MODEL_AXIS): 0, (None, MODEL_AXIS, None): 1}
        assert specs["blocks"][name] == want.get(tuple(spec)), name
    assert specs["lm_head"] == 0 and specs["embed"] is None
    for cfg in (LCFG, LCFG4, dict(LCFG, kv_heads=1),
                dict(LCFG, mlp_dim=96), dict(LCFG, vocab_size=98)):
        for dp, tp in SHAPES:
            jm, tm = _meshes(dp, tp)
            assert vlm.draft_tp_divisible(LlamaConfig(**cfg), tm) == \
                j_vlm.draft_tp_divisible(JLlamaConfig(**cfg), jm), (cfg, tp)
    _, model, _ = _llama(0, dict(LCFG, kv_heads=1))
    with pytest.raises(ValueError, match="does not divide"):
        vlm.shard_llama_params(model, _meshes(1, 2)[1])


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("dp,tp", SHAPES)
def test_tp_generate_equals_jax_and_one_device(dp, tp, kv):
    cfg = LCFG4 if tp == 4 else LCFG
    params, model, tcfg = _llama(3 * tp + dp, cfg)
    prompt = _prompt(dp + tp)
    jm, tm = _meshes(dp, tp)
    jkv, tkv = (jnp.int8, torch.int8) if kv else (None, None)
    jgen = j_vlm.make_tp_generate(JLlamaConfig(**cfg), jm, max_new_tokens=6,
                                  eos_token=-1, compute_dtype=jnp.float32,
                                  kv_dtype=jkv)
    want = np.asarray(jgen(j_vlm.shard_llama_params(params, jm),
                           j_llama.embed_tokens(params, jnp.asarray(prompt))))
    emb = llama.embed_tokens(model, torch.from_numpy(prompt))
    one = llama.greedy_generate(model, emb, 6, -1, F32, kv_dtype=tkv)
    gen = vlm.make_tp_generate(tcfg, tm, 6, -1, F32, kv_dtype=tkv)
    got = gen(vlm.shard_llama_params(model, tm), emb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, one)


def test_tp_prefill_logits_and_cache_shards():
    """TP = 2 prefill logits within 1e-4 of JAX's (1e-5 of one device's);
    each shard holds its kv heads' cache [L, B, KVH / tp, S, HD]; the
    decode options compose (chunked prefill, decode window, early stop)."""
    params, model, tcfg = _llama(11, LCFG)
    prompt = _prompt(11, t=9)
    jemb = j_llama.embed_tokens(params, jnp.asarray(prompt))
    want, _ = j_llama.prefill(params, jemb, JLlamaConfig(**LCFG), 64,
                              jnp.float32)
    sh = vlm.shard_llama_params(model, _meshes(1, 2)[1])
    emb = llama.embed_tokens(model, torch.from_numpy(prompt))
    # the einsum route is JAX's XLA attention; "auto" (K10's plain
    # version, bf16 queries) against the one-device "auto" route
    got, _ = llama.prefill(sh.rows[0], emb, 64, F32, attn="einsum")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    got, cache = llama.prefill(sh.rows[0], emb, 64, F32)
    one, _ = llama.prefill(model, emb, 64, F32)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-5)
    assert len(cache) == 2
    for k, v in cache:
        assert k.shape == v.shape == (2, 4, 1, 64, 16)
    ref = llama.greedy_generate(model, emb, 6, -1, F32, kv_dtype=torch.int8)
    out = llama.greedy_generate(sh.rows[0], emb, 6, -1, F32,
                                kv_dtype=torch.int8, prefill_chunk=4,
                                decode_window=4, early_stop=True)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_int8_weights_tp_bit_equal_one_device(dp, tp):
    """int8 serving weights TP-sharded (QLinear scales split with column
    pieces, replicated beside row pieces; the row-parallel rule's global
    activation scale and int32 sums): logits bit-equal to the one-device
    int8 route, tokens equal to JAX's int8 TP decode."""
    params, model, tcfg = _llama(7, LCFG)
    quantize_llama(model)
    prompt = _prompt(7)
    jm, tm = _meshes(dp, tp)
    sh = vlm.shard_llama_params(model, tm)
    wq = sh.rows[0].shards[1].blocks[0].wq
    assert wq.q.shape == (32, 64) and wq.s.shape == (32,)
    assert sh.rows[0].shards[1].blocks[0].wo.s.shape == (64,)
    emb = llama.embed_tokens(model, torch.from_numpy(prompt))
    for kv in (None, torch.int8):
        one, _ = llama.prefill(model, emb, 64, F32, kv)
        got, _ = llama.prefill(sh.rows[0], emb, 64, F32, kv)
        assert torch.equal(got, one)
    qparams = j_quantize_llama(params)
    jgen = j_vlm.make_tp_generate(JLlamaConfig(**LCFG), jm, max_new_tokens=6,
                                  eos_token=-1, compute_dtype=jnp.float32,
                                  kv_dtype=jnp.int8)
    want = np.asarray(jgen(j_vlm.shard_llama_params(qparams, jm),
                           j_llama.embed_tokens(qparams,
                                                jnp.asarray(prompt))))
    gen = vlm.make_tp_generate(tcfg, tm, 6, -1, F32, kv_dtype=torch.int8)
    got = gen(sh, emb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, llama.greedy_generate(model, emb, 6, -1, F32,
                                                  kv_dtype=torch.int8))


def test_int4_weights_tp_and_group_refusal():
    """QLinear4 pieces (row pieces on whole K-groups) take matmul's float
    path: TP = 2 tokens equal the one-device int4 decode; a model axis
    that does not divide a row layer's K-groups is refused."""
    _, model, tcfg = _llama(9, LCFG)
    quantize_llama_int4(model, group=32)
    emb = llama.embed_tokens(model, torch.from_numpy(_prompt(9)))
    sh = vlm.shard_llama_params(model, _meshes(1, 2)[1])
    want = llama.greedy_generate(model, emb, 6, -1, F32)
    assert torch.equal(llama.greedy_generate(sh.rows[0], emb, 6, -1, F32),
                       want)
    _, model, _ = _llama(9, LCFG)
    quantize_llama_int4(model, group=64)      # wo: 64 inputs, one group
    with pytest.raises(ValueError, match="K-groups"):
        vlm.shard_llama_params(model, _meshes(1, 2)[1])


def test_speculative_replicated_draft_equals_greedy_and_jax():
    """TP target + a draft whose kv_heads=1 cannot split the axis (so it
    is replicated): the target's greedy tokens, as JAX's."""
    tparams, target, tcfg = _llama(4, LCFG)
    dcfg = dict(vocab_size=96, dim=32, layers=1, heads=2, kv_heads=1,
                mlp_dim=64, max_seq=64)
    dparams, draft, dtcfg = _llama(5, dcfg)
    prompt = _prompt(4)
    jm, tm = _meshes(2, 2)
    assert not vlm.draft_tp_divisible(dtcfg, tm)
    te = llama.embed_tokens(target, torch.from_numpy(prompt))
    de = llama.embed_tokens(draft, torch.from_numpy(prompt))
    gen = vlm.make_tp_speculative_generate(tcfg, dtcfg, tm, 8, 3, -1, F32,
                                           kv_dtype=torch.int8)
    got = gen(vlm.shard_llama_params(target, tm),
              vlm.replicate_llama_params(draft, tm), te, de)
    want = llama.greedy_generate(target, te, 8, -1, F32,
                                 kv_dtype=torch.int8)
    assert torch.equal(got, want)
    jgen = j_vlm.make_tp_speculative_generate(
        JLlamaConfig(**LCFG), JLlamaConfig(**dcfg), jm, max_new_tokens=8,
        draft_tokens=3, eos_token=-1, compute_dtype=jnp.float32,
        kv_dtype=jnp.int8)
    jwant = np.asarray(jgen(
        j_vlm.shard_llama_params(tparams, jm),
        j_vlm.replicate_llama_params(dparams, jm),
        j_llama.embed_tokens(tparams, jnp.asarray(prompt)),
        j_llama.embed_tokens(dparams, jnp.asarray(prompt))))
    np.testing.assert_array_equal(got.numpy(), jwant)


def test_speculative_sharded_draft_ideal_rounds():
    """Target and draft both sharded (draft == target, every proposal
    accepted): greedy tokens and the full-acceptance round count, merged
    over the data rows as one batch's."""
    _, model, tcfg = _llama(6, LCFG)
    emb = llama.embed_tokens(model, torch.from_numpy(_prompt(6)))
    k, max_new = 3, 12
    tm = _meshes(2, 2)[1]
    sh = vlm.shard_llama_params(model, tm)
    gen = vlm.make_tp_speculative_generate(tcfg, tcfg, tm, max_new, k, -1,
                                           F32, return_stats=True)
    out, stats = gen(sh, sh, emb, emb)
    assert torch.equal(out, llama.greedy_generate(model, emb, max_new, -1,
                                                  F32))
    assert stats["rounds"] == -(-(max_new - 1) // (k + 1))
    assert stats["emitted"].tolist() == [max_new] * 4


def test_batch_must_divide_the_data_axis():
    _, model, tcfg = _llama(1, LCFG)
    tm = _meshes(2, 2)[1]
    gen = vlm.make_tp_generate(tcfg, tm, 4, -1, F32)
    emb = llama.embed_tokens(model, torch.from_numpy(_prompt(1, b=3)))
    with pytest.raises(ValueError, match="data axis"):
        gen(vlm.shard_llama_params(model, tm), emb)


JV = JVITConfig(image_size=32, patch_size=8, width=48, layers=2, heads=4,
                embed_dim=32)


def _llava(seed, lm=LCFG):
    jcfg = j_llava.LLaVAConfig(vision=JV, lm=JLlamaConfig(**lm))
    params = j_llava.init(jax.random.key(seed), jcfg)
    tcfg = t_llava.LLaVAConfig(vision=VITConfig(**JV.__dict__),
                               lm=LlamaConfig(**lm))
    return params, jcfg, convert_jax.from_jax_llava(
        jax.tree.map(np.asarray, params), tcfg), tcfg


def _vqa_inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(3, 90, (b, 3)), rng.integers(3, 90, (b, 4)))


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_llava_tp_generate_equals_jax_and_one_device(dp, tp):
    """The tower once a data row on its first device, the decoder TP: the
    tokens of JAX's make_tp_llava_generate and of llava.generate."""
    params, jcfg, model, tcfg = _llava(2)
    images, pre, post = _vqa_inputs(2)
    jm, tm = _meshes(dp, tp)
    jgen = j_vlm.make_tp_llava_generate(jcfg, jm, max_new_tokens=5,
                                        eos_token=-1,
                                        compute_dtype=jnp.float32)
    want = np.asarray(jgen(j_vlm.shard_llava_params(params, jm),
                           jnp.asarray(images), jnp.asarray(pre),
                           jnp.asarray(post)))
    ti, tpre, tpost = (torch.from_numpy(x) for x in (images, pre, post))
    gen = vlm.make_tp_llava_generate(tcfg, tm, 5, -1, F32)
    sh = vlm.shard_llava_params(model, tm)
    got = gen(sh, ti, tpre, tpost)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, t_llava.generate(model, ti, tpre, tpost, 5, -1,
                                             F32))
    # the tower and projector are the one-device modules (same device)
    assert sh.rows[0].visual is model.visual


@pytest.mark.parametrize("int8", [False, True])
def test_checkpoint_placement_equals_sharded_load(tmp_path, int8):
    """load_npz(placement=llava_checkpoint_placement(mesh)) on a 2x2 mesh
    builds the same pieces as shard_llava_params of the one-device load,
    bit for bit (int8 checkpoints: codes and scales per _scale_spec)."""
    _, _, model, tcfg = _llava(3)
    if int8:
        quantize_llava(model)
    path = str(tmp_path / "llava.npz")
    checkpoint.save_npz(convert_jax.llava_tree(model), path)
    tm = _meshes(2, 2)[1]
    place = vlm.llava_checkpoint_placement(tm)
    placed = checkpoint.load_npz(path, placement=place)
    got = vlm.llava_from_placed(placed, tcfg, tm)
    ref = vlm.shard_llava_params(
        convert_jax.from_jax_llava(checkpoint.load_npz(path), tcfg), tm)
    for g_row, w_row in zip(got.rows, ref.rows):
        gs, ws = g_row.state_dict(), w_row.state_dict()
        assert list(gs) == list(ws)
        for k in ws:
            assert torch.equal(gs[k], ws[k]), k
    # the decoder's kernels: column pieces on N, row pieces on K
    wq = placed["lm"]["blocks"]["wq"]
    wo = placed["lm"]["blocks"]["wo"]
    if int8:
        assert wq.q.pieces[0][1].shape == (2, 64, 32)
        assert wq.s.pieces[0][1].shape == (2, 32)
        assert wo.s.pieces[0][1].shape == (2, 64)
    else:
        assert wq.pieces[0][1].shape == (2, 64, 32)
        assert wo.pieces[0][1].shape == (2, 32, 64)
    assert placed["visual"]["class_embedding"].pieces[1][1] is None


def test_quantize_mesh_llava_equals_quantize_then_shard():
    """The CLI's --verifier-int8 --tp path (a placed float checkpoint,
    then quantized piece by piece) gives quantize_llava's codes and
    scales: row pieces take the whole layer's per-channel scale."""
    _, _, model, tcfg = _llava(4)
    tm = _meshes(1, 2)[1]
    got = vlm.quantize_mesh_llava(vlm.shard_llava_params(model, tm))
    ref = vlm.shard_llava_params(quantize_llava(model), tm)
    gs, ws = got.rows[0].state_dict(), ref.rows[0].state_dict()
    assert list(gs) == list(ws)
    for k in ws:
        assert torch.equal(gs[k], ws[k]), k
