"""chip_smoke.py's token checks and per-call checks, on the CPU.

Phase 4e and 4j hold a route's greedy tokens by feeding them to the model
they are compared with (`greedy_trace(forced=)`) and asking
`token_check` for two limits over every step: the largest gap below that
model's best logit, and the least share of steps at which it picks the
fed token. Here a tiny 2-layer LLaMA on random weights shows that the
plain route's own tokens pass and that a route taking the runner-up
token, at every step or at a quarter of them, fails; and that
`held_calls`, which holds single kernel calls against their plain
versions on the model's own tensors, counts calls per op, picks the
ones asked for and puts the ops back, also when a check fails.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mmrs_tpu_torch.models import llama  # noqa: E402
from mmrs_tpu_torch.ops import decode_attention  # noqa: E402

CFG = llama.LlamaConfig(vocab_size=128, dim=64, layers=2, heads=4,
                        kv_heads=2, mlp_dim=128, max_seq=256)
B, T, STEPS = 4, 70, 12        # a prompt of two prefill chunks of 64


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


@pytest.fixture(scope="module")
def lm_and_prompt():
    torch.manual_seed(0)
    lm = llama.Llama(CFG, torch.Generator().manual_seed(1),
                     dtype=torch.bfloat16).requires_grad_(False)
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.standard_normal((B, T, CFG.dim)).astype(
        np.float32) * 0.5).to(torch.bfloat16)
    return lm, emb


def _decode(lm, emb, runner_up_steps):
    """Greedy tokens [B, STEPS] of lm, taking the runner-up token instead
    at the steps in `runner_up_steps` (a route that picks wrongly)."""
    cache_len = -(-(T + STEPS) // 64) * 64
    with torch.inference_mode():
        logits, cache = llama.prefill(lm, emb, cache_len, torch.bfloat16,
                                      None, 64, "torch")
        toks = []
        for i in range(STEPS):
            top2 = logits[:, -1].topk(2, dim=-1).indices
            toks.append(top2[:, 1 if i in runner_up_steps else 0].to(
                torch.int32))
            if i == STEPS - 1:
                break
            logits, cache = llama.forward(
                lm, llama.embed_tokens(lm, toks[-1][:, None]), cache, T + i,
                torch.bfloat16, attn="torch")
    return torch.stack(toks, 1)


def _fed(lm, emb, tokens):
    with torch.inference_mode():
        _, picked, _, gaps = chip_smoke.greedy_trace(lm, emb, None, "torch",
                                                     STEPS, forced=tokens)
    return gaps, picked == tokens


def test_plain_routes_own_tokens_pass(lm_and_prompt):
    lm, emb = lm_and_prompt
    with torch.inference_mode():
        _, tokens, margins, _ = chip_smoke.greedy_trace(lm, emb, None,
                                                        "torch", STEPS)
    assert torch.equal(tokens, _decode(lm, emb, ()))
    gaps, same = _fed(lm, emb, tokens)
    for name, (limit, floor) in chip_smoke.TOKEN_LIMITS.items():
        gap, picked = chip_smoke.token_check(gaps, same, limit, floor, name)
        assert gap == 0.0 and picked == tokens.numel()
    assert float(margins.min()) >= 0.0


@pytest.mark.parametrize("name", sorted(chip_smoke.TOKEN_LIMITS))
def test_runner_up_at_every_step_fails(lm_and_prompt, name):
    lm, emb = lm_and_prompt
    tokens = _decode(lm, emb, range(STEPS))
    gaps, same = _fed(lm, emb, tokens)
    assert int(same.sum()) == 0 and float(gaps.min()) >= 0.0
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.token_check(gaps, same, *chip_smoke.TOKEN_LIMITS[name],
                               name)


@pytest.mark.parametrize("name", ["bf16", "speculative"])
def test_runner_up_at_a_quarter_of_the_steps_fails(lm_and_prompt, name):
    """The route picks as the model does after each wrong step (both see
    the same tokens), so the model fed its tokens picks them at three
    quarters of the steps: below the bf16 floor, whatever the gaps (the
    check fails on whichever limit it meets first)."""
    lm, emb = lm_and_prompt
    tokens = _decode(lm, emb, range(0, STEPS, 4))
    gaps, same = _fed(lm, emb, tokens)
    assert int(same.sum()) == tokens.numel() * 3 // 4
    assert chip_smoke.TOKEN_LIMITS[name][1] > 0.75
    with pytest.raises(RuntimeError, match="picks the same at 36 of 48"):
        chip_smoke.token_check(gaps, same, *chip_smoke.TOKEN_LIMITS[name],
                               name)


def test_int8_check_holds_a_quarter_wrong_route_by_its_gap():
    """The int8 floor (0.6) lies below a route wrong at a quarter of the
    steps (the int8 route's own rounding leaves 169 of 256 picked on the
    random 7B), so such a route fails exactly where one of its wrong steps
    had a top-2 margin past INT8_TOKEN_GAP; a route wrong at every other
    step fails on the floor. lm_head is scaled by 8 so that the tiny
    model's margins reach past that gap, as the 7B's do (to 1.72)."""
    lm = llama.Llama(CFG, torch.Generator().manual_seed(1),
                     dtype=torch.bfloat16).requires_grad_(False)
    with torch.no_grad():
        lm.lm_head.weight.mul_(8)
    emb = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, T, CFG.dim)).astype(np.float32) * 0.5).to(torch.bfloat16)
    limit, floor = chip_smoke.TOKEN_LIMITS["int8"]
    quarter = _decode(lm, emb, range(0, STEPS, 4))
    gaps, same = _fed(lm, emb, quarter)
    assert int(same.sum()) / same.numel() == 0.75 > floor
    wrong = ~same
    assert bool((gaps[same] == 0).all()) and bool((gaps[wrong] > 0).all())
    if float(gaps.max()) > limit:
        with pytest.raises(RuntimeError, match="check failed"):
            chip_smoke.token_check(gaps, same, limit, floor, "int8")
    else:
        assert chip_smoke.token_check(gaps, same, limit, floor, "int8")[1] \
            == int(same.sum())
    half = _decode(lm, emb, range(0, STEPS, 2))
    gaps, same = _fed(lm, emb, half)
    assert int(same.sum()) / same.numel() == 0.5 < floor
    with pytest.raises(RuntimeError, match="check failed"):
        chip_smoke.token_check(gaps, same, limit, floor, "int8")


def test_a_runner_up_gap_fails_the_gap_limit():
    gaps = torch.zeros((2, 8))
    gaps[1, 3] = chip_smoke.TP_TOKEN_GAP * 1.5
    same = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(RuntimeError, match=f"lies {gaps[1, 3]:.4f} below "
                       f"the best .* \\(limit {chip_smoke.TP_TOKEN_GAP}\\)"):
        chip_smoke.token_check(gaps, same, chip_smoke.TP_TOKEN_GAP,
                               chip_smoke.TOKEN_FLOOR, "bf16")
    assert chip_smoke.token_check(gaps / 2, same, chip_smoke.TP_TOKEN_GAP,
                                  chip_smoke.TOKEN_FLOOR, "bf16") == (
        float(gaps[1, 3] / 2), 16)


def _originals():
    return (llama.chunk_attention, llama.decode_attention)


def test_held_calls_pick_layers_and_steps_and_restore(lm_and_prompt):
    """Phase 4e's picks: K10 at every prefill chunk and K11 at chosen
    decode steps, at chosen layers (call i of an op is layer i % L)."""
    lm, emb = lm_and_prompt
    before = _originals()
    seen = []

    def pick(op, i):
        return i % CFG.layers == 1 and (op == "chunk_attention"
                                        or i // CFG.layers + 1 in (1, 5))

    def judge(op, i, out, ref):
        assert torch.equal(out, ref)   # the CPU runs the plain version
        seen.append((op, i))

    with chip_smoke.held_calls(((llama, "chunk_attention"),
                                (llama, "decode_attention")), pick,
                               judge) as held:
        assert _originals() != before
        with torch.inference_mode():
            chip_smoke.greedy_trace(lm, emb, None, "auto", STEPS)
    assert _originals() == before
    assert held.calls == {"chunk_attention": 2 * CFG.layers,
                          "decode_attention": (STEPS - 1) * CFG.layers}
    assert seen == [("chunk_attention", 1), ("chunk_attention", 3),
                    ("decode_attention", 1), ("decode_attention", 9)]


def test_held_calls_restore_the_ops_when_a_check_fails(lm_and_prompt):
    lm, emb = lm_and_prompt
    before = _originals()

    def judge(op, i, out, ref):
        chip_smoke.check(False, f"{op} call {i} held against plain")

    with pytest.raises(RuntimeError, match="chunk_attention call 0"):
        with chip_smoke.held_calls(((llama, "chunk_attention"),
                                    (llama, "decode_attention")),
                                   lambda op, i: True, judge):
            with torch.inference_mode():
                chip_smoke.greedy_trace(lm, emb, None, "auto", STEPS)
    assert _originals() == before
    assert llama.chunk_attention is decode_attention.chunk_attention
    assert llama.decode_attention is decode_attention.decode_attention


def test_held_calls_pass_the_plain_impl_to_the_op():
    """The plain call gets impl="torch" and the caller's other arguments."""
    calls = []

    class Ops:
        @staticmethod
        def op(x, scale=1.0, impl="auto"):
            calls.append(impl)
            return x * scale + (0.0 if impl == "torch" else 1.0)

    got = []
    with chip_smoke.held_calls(((Ops, "op"),), lambda op, i: i == 1,
                               lambda op, i, out, ref: got.append(
                                   (i, out, ref))):
        Ops.op(2.0, scale=3.0)
        assert Ops.op(2.0, scale=3.0) == 7.0
    assert calls == ["auto", "auto", "torch"]
    assert got == [(1, 7.0, 6.0)]


def test_probe_imports_no_jax_and_refuses_without_a_gpu():
    """probe_verifier_gap.py imports the port only, and without a card it
    exits nonzero before building anything."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, probe_verifier_gap as p\n"
         "print('jax' in sys.modules, 'mmrs_tpu' in sys.modules)\n"
         "sys.exit(p.main(['probe_verifier_gap.py']))\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.stdout.splitlines()[0] == "False False"
    assert r.returncode != 0


def test_gap_probe_imports_no_jax_and_refuses_without_a_gpu():
    """probe_tp_token_gap.py, which read the spread that TP_TOKEN_GAP is
    set from, imports the port only and without a card exits nonzero
    before building anything."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, probe_tp_token_gap as p\n"
         "print('jax' in sys.modules, 'mmrs_tpu' in sys.modules)\n"
         "sys.exit(p.main(['probe_tp_token_gap.py', '--packs', '1']))\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.stdout.splitlines()[0] == "False False"
    assert r.returncode != 0


def test_gap_probe_nudge_moves_one_ulp_in_the_image_rows():
    """The probe's rounding witness: one bf16 step of the raw bits at
    about half the elements of the rows asked for, up or down; zeros and
    the text rows stay, and the same seed gives the same tensor."""
    import probe_tp_token_gap as probe

    emb = torch.randn(2, 9, 16).bfloat16()
    emb[0, 3, :4] = 0.0
    got = probe.nudge(emb, 2, 5, seed=7)
    assert torch.equal(got, probe.nudge(emb, 2, 5, seed=7))
    assert torch.equal(got[:, :2], emb[:, :2])
    assert torch.equal(got[:, 7:], emb[:, 7:])
    assert torch.equal(got[0, 3, :4], emb[0, 3, :4])
    steps = (got[:, 2:7].view(torch.int16).int()
             - emb[:, 2:7].view(torch.int16).int())
    assert set(steps.unique().tolist()) <= {-1, 0, 1}
    moved = float((steps != 0).float().mean())
    assert 0.35 < moved < 0.65
    assert float((got[:, 2:7].float() - emb[:, 2:7].float()).abs().max()) > 0
