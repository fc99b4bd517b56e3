"""LLaMA-family decoder with a KV cache — the VLM verifier's language model.

Counterpart of mmrs_tpu/models/llama.py (LLaMA-2-7B in llava-v1.5, and the
1.1B draft). The JAX package's three layer-loop forms (`layers="scan" |
"unroll" | "fori"`) are compile workarounds; the port has one Python loop
over an `nn.ModuleList`. The KV cache is stacked [L, B, KVH, S, HD]
(head-major, as JAX's): layer li writes its new rows of `cache[li]` in
place and hands the attention kernels that layer's view (cut to
`kv_limit`), so nothing is sliced out or copied.

Numerics follow the JAX package: matmuls take the compute dtype with f32
sums (int8 `QLinear` weights: one per-row activation quantization shared
by wq/wk/wv and by w_gate/w_up); RMSNorm, RoPE and the softmax in f32; the
gated MLP's gate and up come out in f32 and silu(gate) * up is rounded
once; the int8 KV cache stores per-(row, head, position) f32 scales.

A `TPLlama` is the same decoder tensor-parallel over one data row's model
axis (parallel/vlm.py builds it): `forward` below is one path for both,
and with one shard it is the one-device arithmetic.

`attn` chooses the attention over the cache: "auto" is K10 / K11
(ops/decode_attention.py: the CUDA kernels on a CUDA tensor, their plain
versions on the CPU); "torch" their plain versions anywhere;
"einsum" the JAX package's XLA form in the compute dtype
(`decode_attn="xla"`), for the CPU tests. Nothing on the main path picks
"einsum".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.models.layers import QLinear, matmul, row_parallel
from mmrs_tpu_torch.ops.decode_attention import (Pos, chunk_attention,
                                                 decode_attention,
                                                 query_positions)
from mmrs_tpu_torch.ops.int8 import INV_127, int8_linear, quantize_act

ATTN_ROUTES = ("auto", "torch", "einsum")


class QKVCache(NamedTuple):
    """int8 KV cache: values + per-(layer, batch, kv-head, position) f32
    scales (mmrs_tpu llama.QKVCache). Half the bytes of the bf16 cache;
    the scales are applied to the logits and probabilities, never to a
    dequantized copy of the cache."""

    q: torch.Tensor                # int8 [L, B, KVH, S, HD]
    s: torch.Tensor                # f32  [L, B, KVH, S]


Cache = Tuple[Union[torch.Tensor, QKVCache], Union[torch.Tensor, QKVCache]]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    mlp_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq: int = 2048

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


# the 7B decoder of llava-v1.5 (LLaMA-2-7B)
LLAMA2_7B = LlamaConfig()

# the 1.1B draft (TinyLlama-1.1B layout: the same 32k tokenizer, GQA 32
# query heads over 4 kv heads)
LLAMA_1B = LlamaConfig(vocab_size=32000, dim=2048, layers=22, heads=32,
                       kv_heads=4, mlp_dim=5632)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * scale * w.float()).to(x.dtype)


def _rope_tables(q_pos: torch.Tensor, hd: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [B, T, 1, HD] for HF rotate_half over contiguous halves;
    the inverse frequencies and the angles in f32 (mmrs_tpu llama._rope)."""
    steps = torch.arange(0, hd, 2, dtype=torch.float32, device=q_pos.device)
    inv = 1.0 / (theta ** (steps / hd))
    freqs = q_pos.float()[:, :, None] * inv[None, None, :]   # [B, T, HD/2]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    return (torch.cat([cos, cos], -1)[:, :, None],
            torch.cat([sin, sin], -1)[:, :, None])


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
          ) -> torch.Tensor:
    """x [B, T, H, HD], rotated in f32 and returned in x's dtype."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], -1)
    return (x32 * cos + rotated * sin).to(x.dtype)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim. x [B, KVH, T, HD] -> (int8 codes,
    f32 scales [B, KVH, T]). The / 127 is the product JAX's jit makes of
    it (ops/int8.INV_127)."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(-1, keepdim=True), min=1e-12) * INV_127
    return torch.round(x32 / s).to(torch.int8), s.squeeze(-1)


def _put(dst: torch.Tensor, src: torch.Tensor, pos: Pos) -> None:
    """dst [B, KVH, S, ...] <- src [B, KVH, T, ...] at slot pos (every row)
    or pos[b] (row b), in place."""
    t = src.shape[2]
    if not isinstance(pos, torch.Tensor):
        dst[:, :, pos:pos + t] = src
        return
    slots = pos.long()[:, None] + torch.arange(t, device=pos.device)
    rows = torch.arange(src.shape[0], device=pos.device)[:, None]
    dst[rows.expand_as(slots), :, slots] = src.transpose(1, 2)


def _write(cache, li: int, new: torch.Tensor, pos: Pos) -> None:
    """Layer li's new entries [B, KVH, T, HD] into the stacked cache."""
    if isinstance(cache, QKVCache):
        q, s = _quantize_kv(new)
        _put(cache.q[li], q, pos)
        _put(cache.s[li], s, pos)
    else:
        _put(cache[li], new.to(cache.dtype), pos)


def _view(cache, li: int, kv_limit: Optional[int]):
    """(values [B, KVH, S, HD], scales [B, KVH, S] or None) of layer li,
    cut to kv_limit: views of the stacked cache."""
    lim = slice(None, kv_limit)
    if isinstance(cache, QKVCache):
        return cache.q[li][:, :, lim], cache.s[li][:, :, lim]
    return cache[li][:, :, lim], None


def _einsum_attention(qg, k, ks, v, vs, q_pos, cd) -> torch.Tensor:
    """The JAX package's XLA form (llama.py:318-343): logits in f32 from
    compute-dtype operands, divided by sqrt(hd), masked, f32 softmax,
    probabilities rounded to the compute dtype. [B, KVH, G, T, HD] in cd."""
    hd = qg.shape[-1]
    logits = qg.to(cd).float() @ k.to(cd).float()[:, :, None].transpose(-1, -2)
    if ks is not None:
        logits = logits * ks[:, :, None, None, :]
    logits = logits / torch.sqrt(torch.tensor(float(hd)))
    key_pos = torch.arange(k.shape[2], device=qg.device)
    mask = key_pos <= q_pos[:, :, None]                          # [B, T, S]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if vs is not None:
        probs = probs * vs[:, :, None, None, :]
    out = probs.to(cd).float() @ v.to(cd).float()[:, :, None]
    return out.to(cd)


def _project(x: torch.Tensor, layers, cd: torch.dtype,
             out_dtype: torch.dtype) -> List[torch.Tensor]:
    """Projections of one input; int8 layers share one quantization of x."""
    if isinstance(layers[0], QLinear):
        xq, sx = quantize_act(x)
        return [int8_linear(xq, sx, lyr.q, lyr.s, None, out_dtype)
                for lyr in layers]
    return [matmul(x, lyr, cd, out_dtype) for lyr in layers]


class LlamaBlock(nn.Module):
    """Pre-RMSNorm attention + gated-MLP block. Linear weights [out, in]
    (bias-free), or `QLinear` after models/quantize.quantize_llama.

    With `tp` > 1 it is one model position's piece of the block
    (parallel/vlm.py): heads / tp query heads and kv_heads / tp kv heads
    (column pieces of wq / wk / wv), mlp_dim / tp gated units (column
    pieces of w_gate / w_up), and the matching row pieces of wo and
    w_down. `forward` below drives the pieces: `attend` and `gate_up` give
    the inputs of the two row-parallel products, which the model axis
    sums (layers.row_parallel)."""

    def __init__(self, cfg: LlamaConfig, tp: int = 1, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        d, hd = cfg.dim, cfg.head_dim
        self.heads, self.kv_heads = cfg.heads // tp, cfg.kv_heads // tp
        qd, kvd, m = self.heads * hd, self.kv_heads * hd, cfg.mlp_dim // tp
        self.attn_norm = nn.Parameter(torch.ones(d, **fk))
        self.wq = nn.Linear(d, qd, bias=False, **fk)
        self.wk = nn.Linear(d, kvd, bias=False, **fk)
        self.wv = nn.Linear(d, kvd, bias=False, **fk)
        self.wo = nn.Linear(qd, d, bias=False, **fk)
        self.mlp_norm = nn.Parameter(torch.ones(d, **fk))
        self.w_gate = nn.Linear(d, m, bias=False, **fk)
        self.w_up = nn.Linear(d, m, bias=False, **fk)
        self.w_down = nn.Linear(m, d, bias=False, **fk)

    def attend(self, x: torch.Tensor, cache: Cache, li: int, pos: Pos,
               rope, q_pos: torch.Tensor, cfg: LlamaConfig, cd: torch.dtype,
               kv_limit: Optional[int], attn: str,
               pairs: Optional[int] = None) -> torch.Tensor:
        """The attention of the block's heads over its cache, [B, T,
        heads * HD] in cd: the input of wo. `pairs` (None: the shard's
        own B * kv_heads) is the number of (row, kv head) pairs K11 sizes
        its launch for; forward passes the whole model's on the int8
        weight route, so that a shard's pairs reduce as on one device."""
        b, t, _ = x.shape
        nh, kvh, hd = self.heads, self.kv_heads, cfg.head_dim
        q, k, v = _project(x, (self.wq, self.wk, self.wv), cd, cd)
        cos, sin = rope
        q = _rope(q.reshape(b, t, nh, hd), cos, sin)
        k = _rope(k.reshape(b, t, kvh, hd), cos, sin)
        # head-major entries [B, KVH, T, HD] into the stacked cache
        _write(cache[0], li, k.transpose(1, 2), pos)
        _write(cache[1], li, v.reshape(b, t, kvh, hd).transpose(1, 2), pos)
        kc, ks = _view(cache[0], li, kv_limit)
        vc, vs = _view(cache[1], li, kv_limit)
        # GQA: contiguous query heads share a kv head
        qg = q.reshape(b, t, kvh, nh // kvh, hd).permute(0, 2, 3, 1, 4)
        if attn == "einsum":
            out = _einsum_attention(qg, kc, ks, vc, vs, q_pos, cd)
        else:
            impl = "torch" if attn == "torch" else "auto"
            qb = qg.to(torch.bfloat16)
            if t == 1:
                out = decode_attention(qb[:, :, :, 0], kc, ks, vc, vs, pos,
                                       impl=impl, plan_pairs=pairs
                                       )[:, :, :, None]
            else:
                out = chunk_attention(qb, kc, ks, vc, vs, pos, impl=impl)
            out = out.to(cd)
        return out.permute(0, 3, 1, 2, 4).reshape(b, t, nh * hd)

    def gate_up(self, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        """silu(gate) * up of the block's gated units, rounded once to cd:
        the input of w_down."""
        gate, up = _project(x, (self.w_gate, self.w_up), cd, torch.float32)
        return (F.silu(gate) * up).to(cd)


class LlamaShard(nn.Module):
    """One model position of a tensor-parallel decoder (parallel/vlm.py):
    its pieces of every block (`LlamaBlock(cfg, tp)`) and its vocab slice
    of lm_head. The embedding and the final norm are the group's."""

    def __init__(self, cfg: LlamaConfig, tp: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.blocks = nn.ModuleList(LlamaBlock(cfg, tp, **fk)
                                    for _ in range(cfg.layers))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size // tp, bias=False,
                                 **fk)


class TPLlama(nn.Module):
    """A tensor-parallel decoder over one data row's model axis:
    `shards[p]` (a LlamaShard) on `devices[p]`; the embedding and the
    final norm on devices[0], where the residual stream lives. forward,
    prefill and greedy_generate take it where they take a Llama; its
    cache is a list of per-shard caches [L, B, KVH / tp, S, HD]. Built by
    parallel/vlm.shard_llama_params or llava_from_placed."""

    def __init__(self, cfg: LlamaConfig, embed: torch.Tensor,
                 final_norm: torch.Tensor, shards, devices):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.shards = nn.ModuleList(shards)
        self.devices = [torch.device(d) for d in devices]


class Llama(nn.Module):
    def __init__(self, cfg: LlamaConfig,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.dim, **fk))
        self.blocks = nn.ModuleList(LlamaBlock(cfg, **fk)
                                    for _ in range(cfg.layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, **fk))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, **fk)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init's distributions (llama.init): N(0, 0.02) for the
        embedding and every matmul weight, unit norm scales."""
        weights = [self.embed, self.lm_head.weight]
        for blk in self.blocks:
            weights += [lin.weight for lin in (
                blk.wq, blk.wk, blk.wv, blk.wo, blk.w_gate, blk.w_up,
                blk.w_down)]
        for w in weights:
            nn.init.normal_(w, std=0.02, generator=generator)


def embed_tokens(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows, in the table's dtype."""
    return model.embed[tokens]


def init_cache(cfg: LlamaConfig, batch: int, dtype=torch.bfloat16,
               seq_len: Optional[int] = None, device=None, tp: int = 1
               ) -> Cache:
    """Stacked KV cache [L, B, KVH, S, HD] of zeros; `dtype=torch.int8`
    makes a QKVCache pair. `seq_len` (default cfg.max_seq) right-sizes it:
    decode attention reads the live cache every step. `tp` makes one
    model position's cache: its kv_heads / tp heads."""
    s = seq_len or cfg.max_seq
    shape = (cfg.layers, batch, cfg.kv_heads // tp, s, cfg.head_dim)
    if dtype == torch.int8:
        return tuple(QKVCache(torch.zeros(shape, dtype=torch.int8,
                                          device=device),
                              torch.zeros(shape[:-1], device=device))
                     for _ in range(2))
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _shards(model, device: torch.device):
    """(shards, their devices): a Llama is its own only shard."""
    if isinstance(model, TPLlama):
        return list(model.shards), model.devices
    return [model], [device]


def _on(x, device: torch.device):
    """x (a tensor, a tuple of them, or an int position) on `device`."""
    if isinstance(x, tuple):
        return tuple(_on(y, device) for y in x)
    return x.to(device) if isinstance(x, torch.Tensor) else x


@torch.no_grad()
def forward(model: Union[Llama, TPLlama], embeds: torch.Tensor, cache,
            pos: Pos, compute_dtype: torch.dtype = torch.bfloat16,
            kv_limit: Optional[int] = None, last_logit_only: bool = False,
            attn: str = "auto") -> Tuple[torch.Tensor, Cache]:
    """(logits [B, T, V] f32, the cache, written in place). `pos` is the
    first query position: an int (every row) or an int tensor [B] (per-row
    offsets, speculative decode). `kv_limit` cuts the attention's view of
    the cache (the chunk attends no further).

    One path for one device and for a TPLlama: the residual stream and
    the norms stay on the first device, each shard takes the normed input
    and computes its heads and gated units (column pieces) into its own
    cache, and the two row-parallel products of a block are summed over
    the shards in f32 (layers.row_parallel) and rounded once to the
    compute dtype. The shards' lm_head slices are gathered in shard
    order, so an argmax over the logits breaks ties as one device does.
    With one shard this is the one-device arithmetic."""
    if attn not in ATTN_ROUTES:
        raise ValueError(f"unknown attn {attn!r}; one of {ATTN_ROUTES}")
    cfg = model.cfg
    cd = compute_dtype
    b, t, _ = embeds.shape
    dev = embeds.device
    shards, devs = _shards(model, dev)
    caches = cache if isinstance(model, TPLlama) else [cache]
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=dev, dtype=torch.int32)
    q_pos = query_positions(pos, b, t, dev)
    rope = _rope_tables(q_pos, cfg.head_dim, cfg.rope_theta)
    local = [(_on(pos, d), _on(rope, d), _on(q_pos, d)) for d in devs]
    # int8 weights: TP's contract is bit-equality with one device, so each
    # shard's K11 splits its keys as the whole model's launch does. Other
    # routes plan for the shard's own pairs: on distinct cards a shard
    # then fills its card (tp times the split of the whole model's plan)
    pairs = (b * cfg.kv_heads
             if isinstance(shards[0].blocks[0].wq, QLinear) else None)
    h = embeds.to(cd)
    for li in range(cfg.layers):
        blocks = [s.blocks[li] for s in shards]
        x = rms_norm(h, blocks[0].attn_norm, cfg.norm_eps)
        outs = [blk.attend(x.to(d), c, li, p, r, qp, cfg, cd, kv_limit,
                           attn, pairs)
                for blk, d, c, (p, r, qp) in zip(blocks, devs, caches, local)]
        h = h + row_parallel(outs, [blk.wo for blk in blocks], cd, dev).to(cd)
        x = rms_norm(h, blocks[0].mlp_norm, cfg.norm_eps)
        inner = [blk.gate_up(x.to(d), cd) for blk, d in zip(blocks, devs)]
        h = h + row_parallel(inner, [blk.w_down for blk in blocks], cd,
                             dev).to(cd)
    if last_logit_only:
        h = h[:, -1:]
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    logits = [matmul(h.to(d), s.lm_head, cd, torch.float32).to(dev)
              for s, d in zip(shards, devs)]
    logits = logits[0] if len(logits) == 1 else torch.cat(logits, -1)
    return logits, cache


def _round64(n: int) -> int:
    return -(-n // 64) * 64


def prefill(model: Union[Llama, TPLlama], prompt_embeds: torch.Tensor,
            cache_len: int, compute_dtype: torch.dtype = torch.bfloat16,
            kv_dtype=None, prefill_chunk: Optional[int] = None,
            attn: str = "auto"):
    """A right-sized cache with the prompt run through it: (last-position
    logits [B, 1, V], cache). `prefill_chunk=C` runs C tokens at a time,
    chunk i attending to cache[:round64(end of chunk i)] only. A TPLlama's
    cache is one a shard, on the shard's device."""
    b, t, _ = prompt_embeds.shape
    dtype = kv_dtype or compute_dtype
    if isinstance(model, TPLlama):
        cache = [init_cache(model.cfg, b, dtype, cache_len, d,
                            len(model.devices)) for d in model.devices]
    else:
        cache = init_cache(model.cfg, b, dtype, cache_len,
                           prompt_embeds.device)
    if prefill_chunk is not None and t > prefill_chunk:
        for s0 in range(0, t, prefill_chunk):
            piece = prompt_embeds[:, s0:s0 + prefill_chunk]
            lim = min(cache_len, _round64(s0 + piece.shape[1]))
            logits, cache = forward(model, piece, cache, s0, compute_dtype,
                                    kv_limit=lim, last_logit_only=True,
                                    attn=attn)
    else:
        logits, cache = forward(model, prompt_embeds, cache, 0, compute_dtype,
                                last_logit_only=True, attn=attn)
    return logits, cache


def _segments(t: int, max_new: int, cache_len: int,
              decode_window: Optional[int]
              ) -> List[Tuple[int, int, Optional[int]]]:
    """(first step, steps, kv_limit) per decode segment (mmrs_tpu
    greedy_generate's decode_window): segment j reads
    cache[:round64(t + its last step + 1)], or the whole cache."""
    if decode_window is None or decode_window >= max_new:
        return [(0, max_new, None)]
    out = []
    for s0 in range(0, max_new, decode_window):
        steps = min(decode_window, max_new - s0)
        lim = min(cache_len, _round64(t + s0 + steps))
        out.append((s0, steps, None if lim >= cache_len else lim))
    return out


def greedy_generate(model: Union[Llama, TPLlama], prompt_embeds: torch.Tensor,
                    max_new_tokens: int = 32, eos_token: int = 2,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    kv_dtype=None, prefill_chunk: Optional[int] = None,
                    decode_window: Optional[int] = None,
                    early_stop: bool = False, attn: str = "auto"
                    ) -> torch.Tensor:
    """Greedy decode (temperature 0). Returns [B, max_new_tokens] int32,
    EOS-padded after each row finishes — the tokens of mmrs_tpu
    greedy_generate. `early_stop` stops once every row has emitted EOS (a
    host check per step; the skipped steps would only give EOS padding).
    The forward after the last emitted token is skipped: its logits are
    never read."""
    cfg = model.cfg
    b, t, _ = prompt_embeds.shape
    if t + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt ({t}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq ({cfg.max_seq})")
    cache_len = min(cfg.max_seq, _round64(t + max_new_tokens))
    logits, cache = prefill(model, prompt_embeds, cache_len, compute_dtype,
                            kv_dtype, prefill_chunk, attn)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    finished = tok == eos_token
    out = torch.full((b, max_new_tokens), eos_token, dtype=torch.int32,
                     device=prompt_embeds.device)
    for s0, steps, lim in _segments(t, max_new_tokens, cache_len,
                                    decode_window):
        for i in range(s0, s0 + steps):
            if early_stop and bool(finished.all()):
                return out
            out[:, i] = tok
            if i == max_new_tokens - 1:
                break
            logits, cache = forward(model, embed_tokens(model, tok[:, None]),
                                    cache, t + i, compute_dtype,
                                    kv_limit=lim, attn=attn)
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            nxt = torch.where(finished, eos_token, nxt)
            finished = finished | (nxt == eos_token)
            tok = nxt
    return out
