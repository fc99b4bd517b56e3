"""Speculative greedy decoding: draft-model proposals, target verification.

Counterpart of mmrs_tpu/models/speculative.py. Each round the draft
proposes k tokens (its step 0 at T=2 starting one slot back, re-deriving
the frontier slot a fully accepted round leaves unwritten — K10 with
per-row positions; its steps 1..k-1 at T=1 — K11), then the target scores
the k+1 tokens [last, d_1..d_k] in one T=k+1 pass (K10). Each row accepts
its own longest agreeing prefix plus the target's next token, so rows
desynchronize: positions, cache writes, RoPE phases and masks are per row
([B] positions through models/llama.forward). Slots past a row's frontier
hold stale drafts; every round rewrites [pos - 1, pos + k] before any
query attends to them, and the masks hide the rest.

Greedy acceptance is an exact argmax comparison, so the output is the
target's own greedy output (llama.greedy_generate) for any draft; the
draft sets only the speed. The round loop reads one flag per round on the
host (every row finished?).
"""

from __future__ import annotations

from typing import Optional

import torch

from mmrs_tpu_torch.models.llama import Llama, embed_tokens, forward, prefill


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(-1).to(torch.int32)


@torch.inference_mode()
def speculative_generate(
    target: Llama,
    draft: Llama,
    target_embeds: torch.Tensor,     # [B, T, D_target]
    draft_embeds: torch.Tensor,      # [B, T, D_draft], position-aligned
    max_new_tokens: int = 32,
    draft_tokens: int = 4,
    eos_token: int = 2,
    compute_dtype: torch.dtype = torch.bfloat16,
    kv_dtype=None,
    prefill_chunk: Optional[int] = None,
    attn: str = "auto",
    return_stats: bool = False,
):
    """Greedy decode of the TARGET, accelerated by the draft. Returns
    [B, max_new_tokens] int32, EOS-padded after finish; with
    `return_stats`, also {"rounds": int, "emitted": [B] int32} (rounds run
    and tokens emitted per row; emitted / (rounds * (k+1)) is the slot
    utilization)."""
    tcfg, dcfg = target.cfg, draft.cfg
    if tcfg.vocab_size != dcfg.vocab_size:
        raise ValueError("target and draft must share a vocabulary")
    if target_embeds.shape[1] != draft_embeds.shape[1]:
        raise ValueError("target and draft prompts must be position-aligned")
    b, t, _ = target_embeds.shape
    k = int(draft_tokens)
    need = t + max_new_tokens + k
    for name, cfg in (("target", tcfg), ("draft", dcfg)):
        if need > cfg.max_seq:
            raise ValueError(
                f"prompt ({t}) + max_new_tokens ({max_new_tokens}) + "
                f"draft_tokens ({k}) exceeds {name} max_seq ({cfg.max_seq})")
    cache_len = -(-need // 64) * 64
    cd = compute_dtype
    dev = target_embeds.device

    tl, tcache = prefill(target, target_embeds, min(tcfg.max_seq, cache_len),
                         cd, kv_dtype, prefill_chunk, attn)
    _, dcache = prefill(draft, draft_embeds, min(dcfg.max_seq, cache_len),
                        cd, kv_dtype, prefill_chunk, attn)
    g0 = _argmax(tl[:, -1])

    buf_len = max_new_tokens + k + 1
    out_buf = torch.full((b, buf_len), eos_token, dtype=torch.int32,
                         device=dev)
    out_buf[:, 0] = g0
    steps = torch.arange(k + 1, device=dev)
    # the draft embedding of the token at slot pos - 1: round 0 recomputes
    # the prompt tail's KV from its own input (an identical rewrite)
    prev_emb = draft_embeds[:, -1, :]
    last_tok = g0
    pos = torch.full((b,), t, dtype=torch.int32, device=dev)
    n_emitted = torch.ones((b,), dtype=torch.int32, device=dev)
    finished = g0 == eos_token
    rounds = 0

    while not bool(finished.all()):
        # draft: step 0 at T=2 one slot back, then k-1 steps at T=1
        e_last = embed_tokens(draft, last_tok[:, None])
        emb = torch.cat([prev_emb[:, None, :].to(e_last.dtype), e_last], 1)
        lg, dcache = forward(draft, emb, dcache, pos - 1, cd, attn=attn)
        drafts = [_argmax(lg[:, -1])]
        for j in range(1, k):
            emb = embed_tokens(draft, drafts[-1][:, None])
            lg, dcache = forward(draft, emb, dcache, pos + j, cd, attn=attn)
            drafts.append(_argmax(lg[:, -1]))
        d = torch.stack(drafts, 1)                            # [B, k]

        # target: one pass over [last_tok, d_1..d_k]
        seq = torch.cat([last_tok[:, None], d], 1)            # [B, k+1]
        lg, tcache = forward(target, embed_tokens(target, seq), tcache, pos,
                             cd, attn=attn)
        g = _argmax(lg)                                       # [B, k+1]

        # the longest accepted draft prefix, then the emitted run g[:a+1]
        # cut at its first EOS
        a = torch.cumprod((d == g[:, :k]).to(torch.int32), 1).sum(1)
        eos_in = (g == eos_token) & (steps[None, :] <= a[:, None])
        has_eos = eos_in.any(1)
        last_idx = torch.where(has_eos, eos_in.to(torch.int32).argmax(1), a)
        n_new = torch.where(finished, 0, last_idx + 1).to(torch.int32)

        # per-row append at n_emitted; finished rows write back what they hold
        cols = (n_emitted[:, None] + steps).clamp(max=buf_len - 1).long()
        vals = torch.where(finished[:, None], out_buf.gather(1, cols), g)
        out_buf.scatter_(1, cols, vals)

        new_last = g.gather(1, last_idx[:, None].long())[:, 0]
        # the token now at the new frontier - 1: last_tok itself when
        # nothing was accepted, else the last accepted draft
        at_frontier = torch.where(
            last_idx == 0, last_tok,
            d.gather(1, (last_idx - 1).clamp(0, k - 1)[:, None].long())[:, 0])
        new_prev = embed_tokens(draft, at_frontier)
        prev_emb = torch.where(finished[:, None], prev_emb,
                               new_prev.to(prev_emb.dtype))
        last_tok = torch.where(finished, last_tok, new_last)
        pos = pos + n_new
        n_emitted = n_emitted + n_new
        finished = finished | has_eos | (n_emitted >= max_new_tokens)
        rounds += 1

    idx = torch.arange(buf_len, device=dev)[None, :]
    out = torch.where(idx < n_emitted[:, None], out_buf,
                      eos_token)[:, :max_new_tokens]
    if return_stats:
        return out, {"rounds": rounds,
                     "emitted": torch.clamp(n_emitted, max=max_new_tokens)}
    return out
