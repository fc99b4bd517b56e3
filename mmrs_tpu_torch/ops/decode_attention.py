"""Attention over the LLaMA KV cache — Hopper CUDA kernels K10 / K11 and
their plain PyTorch versions.

Counterpart of mmrs_tpu/ops/decode_attention.py. `chunk_attention` (K10)
takes C > 1 query rows per kv head (prefill chunks, the speculative draft's
T=2 step and the target's T=k+1 verify pass); `decode_attention` (K11) one
(every T=1 decode step). Both read one layer's [B, KVH, S, HD] view of the
stacked cache (`cache[li]`, S cut to `kv_limit`) through its strides, in
bf16 or int8 with f32 per-position scales [B, KVH, S]; nothing is copied.

Math (kernels and plain versions, as the Pallas bodies): q is cast to
bf16, int8 K/V widen exactly to bf16, products are summed in f32;
logits = (q . k) [* k_scale] * hd_scale with hd_scale = f32(1/sqrt(HD));
the mask key_pos <= q_pos (q_pos = pos[b] + c) covers the slot the call
just wrote; f32 softmax (m = max, e = exp(l - m), p = e / sum); p [*
v_scale] in f32, rounded to bf16; p @ V with f32 sums; the output is f32.
`pos` is a Python int (every row) or an int tensor [B] (per-row positions:
speculative decode).

`impl`: "auto" (the kernel for CUDA tensors, the plain version for CPU
tensors) or "torch" (the plain version anywhere). On a CUDA tensor "auto"
launches the kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from mmrs_tpu_torch.ops import _cuda

SMEM_LIMIT = 232448       # shared memory one block may use on Hopper
_DEC_WARPS = 8            # K11 warps per block (csrc: kDecThreads / 32)
_DEC_STAGES = 4           # K11 ring depth (csrc: kDecStages)
DEC_MAX_CLUSTER = 8       # K11 blocks a cluster (csrc: kDecMaxCluster)
DEC_MIN_TILES = 2         # K11 tiles a block's span holds at least
DEC_LOGIT_BUDGET = 96 * 1024   # K11 bytes of [G, span] f32 logits kept
DEC_MAX_SLOTS = 1 << 24   # the longest view K11 plans for
_KEYS = 64                # K10 keys per staged tile (csrc: kAttnKeys)
HEAD_DIMS = (64, 128, 256, 512, 1024)   # the kernels' head-dim instances
                          # (csrc: padded_head_dim): hd % 8 == 0 runs on the
                          # smallest that holds it; 512 and 1024 are K11's
K10_MAX_HD = 256          # K10's widest instance; past it, K11 a query row
_GROUPS = (1, 2, 4, 8)    # K11's instances (csrc: decode_by_group; G <= 4
                          # at 512, G <= 2 at 1024)
MAX_GRID = 65535          # batch rows or kv heads a launch takes

Pos = Union[int, torch.Tensor]


def hd_scale(hd: int) -> float:
    """f32(1/sqrt(hd)), the factor both Pallas bodies multiply by."""
    return float(np.float32(1.0 / float(hd) ** 0.5))


def query_positions(pos: Pos, b: int, t: int, device) -> torch.Tensor:
    """[B, T] int64 query positions: pos (+ per-row offsets) + c."""
    steps = torch.arange(t, device=device)
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(b, 1) + steps
    return (pos + steps).expand(b, t)


def padded_head_dim(hd: int) -> int:
    """The head dim of the kernel instance that runs hd: the smallest of
    HEAD_DIMS that holds it (rows are zero past hd). K11's plain version
    sums in that instance's lane order; past 1024 (no instance, so no
    kernel order) it takes the next power of two."""
    return next((w for w in HEAD_DIMS if w >= hd), 1 << (hd - 1).bit_length())


def lane_elems(hdp: int) -> int:
    """K11's elements a lane at instance HDP (csrc: dec_lane_elems): 8,
    or HDP / 32 past 256 (a warp of lanes a key row)."""
    return 8 if hdp <= 256 else hdp // 32


def _lane_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, KVH, G, T, hd] and k [B, KVH, S, hd], bf16 values held in f32,
    -> q . k [B, KVH, G, T, S] f32 summed in K11's order for the instance
    HDP = padded_head_dim(hd), the dims past hd zero: lane l of a key's
    L = HDP / E lanes (E = `lane_elems`) adds the products of dims E l ..
    E l + E - 1 in turn, then the lanes add by halves (lane l + lane l ^
    off for off = L / 2 .. 1).
    A bf16 product is exact in f32, so each step rounds as the kernel's
    fmaf does and the logits are the kernel's bits; the zero dims add
    exact zeros, but they decide which partial sums pair up."""
    hd = q.shape[-1]
    hdp = padded_head_dim(hd)
    if hdp > hd:
        q = torch.nn.functional.pad(q, (0, hdp - hd))
        k = torch.nn.functional.pad(k, (0, hdp - hd))
    epl = lane_elems(hdp)
    lpr = hdp // epl
    qv = q.unflatten(-1, (lpr, epl))[:, :, :, :, None]       # [..,T,1,L,E]
    kv = k.unflatten(-1, (lpr, epl))[:, :, None, None]       # [..,1,S,L,E]
    acc = qv[..., 0] * kv[..., 0]
    for e in range(1, epl):
        acc = acc + qv[..., e] * kv[..., e]
    lanes = torch.arange(lpr, device=q.device)
    off = lpr // 2
    while off:
        acc = acc + acc[..., lanes ^ off]
        off //= 2
    return acc[..., 0]


def _attn_torch(q: torch.Tensor, k_cache, k_scales, v_cache, v_scales,
                q_pos: torch.Tensor, lanes: bool = False) -> torch.Tensor:
    """q [B, KVH, G, T, HD], caches [B, KVH, S, HD], q_pos [B, T] -> f32
    [B, KVH, G, T, HD]. lanes (K11's plain version): the logits in the
    kernel's order (`_lane_logits`) and the softmax sum in f64, rounded
    once (the same l in any order)."""
    s = k_cache.shape[2]
    k = k_cache.to(torch.bfloat16).float()[:, :, None]       # [B,KVH,1,S,HD]
    v = v_cache.to(torch.bfloat16).float()[:, :, None]
    qf = q.to(torch.bfloat16).float()
    logits = (_lane_logits(qf, k[:, :, 0]) if lanes
              else qf @ k.transpose(-1, -2))
    if k_scales is not None:
        logits = logits * k_scales[:, :, None, None, :]
    logits = logits * hd_scale(q.shape[-1])
    key_pos = torch.arange(s, device=q.device)
    mask = key_pos <= q_pos[:, :, None]                       # [B, T, S]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    total = (e.double().sum(-1, keepdim=True).float() if lanes
             else e.sum(-1, keepdim=True))
    p = e / total
    if v_scales is not None:
        p = p * v_scales[:, :, None, None, :]
    return p.to(torch.bfloat16).float() @ v


def _cache_args(name: str, q: torch.Tensor, k_cache, k_scales, v_cache,
                v_scales) -> Tuple[int, list]:
    """Check one layer's cache view for the kernels; returns (quant flag,
    the strides [sb, sh, ssb, ssh])."""
    b, kvh = q.shape[:2]
    hd = q.shape[-1]
    dev = q.device
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or \
            tuple(k_cache.shape[:2]) != (b, kvh) or k_cache.shape[3] != hd:
        raise ValueError(f"{name}: caches must be [B={b}, KVH={kvh}, S, "
                         f"HD={hd}], got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError(f"{name}: give both scale tensors or neither")
    want = torch.int8 if quant else torch.bfloat16
    if k_cache.dtype != want or v_cache.dtype != want:
        raise ValueError(f"{name} kernel takes a bf16 cache, or an int8 cache "
                         f"with f32 scales; got {k_cache.dtype} "
                         f"({'with' if quant else 'without'} scales)")
    tensors = [k_cache, v_cache] + ([k_scales, v_scales] if quant else [])
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
    if k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1 or \
            k_cache.stride(2) != hd:
        raise ValueError(f"{name} kernel needs K and V of one layout with "
                         f"contiguous [S, HD] rows, got strides "
                         f"{k_cache.stride()} and {v_cache.stride()}")
    if any(st % 8 for st in k_cache.stride()[:2]) or any(
            t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError(f"{name} kernel needs 16-byte aligned cache rows")
    strides = [k_cache.stride(0), k_cache.stride(1), 0, 0]
    if quant:
        if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32 \
                or k_scales.shape != k_cache.shape[:3] \
                or v_scales.shape != k_cache.shape[:3]:
            raise ValueError(f"{name}: scales must be f32 [B, KVH, S]")
        if k_scales.stride() != v_scales.stride() or k_scales.stride(2) != 1:
            raise ValueError(f"{name} kernel needs K and V scales of one "
                             f"layout, contiguous along S")
        strides[2:] = [k_scales.stride(0), k_scales.stride(1)]
    return int(quant), strides


def _pos_args(pos: Pos, b: int, dev) -> Tuple[Optional[int], int]:
    """(pointer to int32 [B] positions or None, the scalar position)."""
    if not isinstance(pos, torch.Tensor):
        return None, int(pos)
    if pos.shape != (b,) or pos.device != dev:
        raise ValueError(f"per-row pos must be [B={b}] on {dev}, got "
                         f"{tuple(pos.shape)} on {pos.device}")
    return pos.to(torch.int32).contiguous(), 0


class DecodePlan(NamedTuple):
    """K11's launch: `cluster` blocks a (batch row, kv head), each owning
    `span` consecutive keys (whole tiles); `cached`: a span's [G,
    span] f32 logits stay in shared memory (else K is streamed three
    times); `smem`: dynamic shared-memory bytes of a block."""
    cluster: int
    span: int
    cached: bool
    smem: int


def dec_keys(hdp: int, quant: bool) -> int:
    """K11's keys a staged tile (csrc: dec_keys) of the instance HDP: 16 KB
    of rows, at most 128 keys."""
    return min(128, 16384 // (hdp * (1 if quant else 2)))


def _dec_smem(span: int, g: int, hdp: int, quant: bool, cached: bool) -> int:
    """K11's dynamic shared memory (csrc: decode_smem_bytes): the ring of
    K or V tiles with their scales, the logits ([G, span] when kept, else
    [G, keys] f32), the block reductions [8, G] f64 and the exchanged sum
    [G] f64 and max [G] f32."""
    keys = dec_keys(hdp, quant)
    stage = keys * (hdp * (1 if quant else 2) + 4)
    return (_DEC_STAGES * stage + 4 * g * (span if cached else keys)
            + 8 * _DEC_WARPS * g + 12 * g)


@lru_cache(maxsize=None)
def decode_plan(s: int, g: int, hd: int, quant: bool, heads: int,
                slots: int) -> DecodePlan:
    """K11's launch for a view of S slots and `heads` = B * KVH (batch
    row, kv head) pairs, on a card that holds `slots` blocks of this kind
    at once: a cluster of slots // heads blocks a pair (so one launch
    fills the card; at most DEC_MAX_CLUSTER, and no block with fewer than
    DEC_MIN_TILES tiles of `dec_keys`), each block a contiguous span.
    Shapes only, never pos: a captured decode step replays any position.
    The logits are kept while G * span f32 fit DEC_LOGIT_BUDGET. Any 1 <=
    S <= DEC_MAX_SLOTS runs; tiles and shared memory are those of hd's
    instance (`padded_head_dim`)."""
    if not 1 <= s <= DEC_MAX_SLOTS:
        raise ValueError(f"decode_attention kernel plans 1 <= S <= "
                         f"{DEC_MAX_SLOTS} slots, got S={s}")
    hd = padded_head_dim(hd)
    keys = dec_keys(hd, quant)
    tiles = -(-s // keys)
    cluster = max(1, min(DEC_MAX_CLUSTER, slots // max(1, heads),
                         -(-tiles // DEC_MIN_TILES)))
    per = -(-tiles // cluster)
    span = per * keys
    cached = 4 * g * span <= DEC_LOGIT_BUDGET
    return DecodePlan(-(-tiles // per), span, cached,
                      _dec_smem(span, g, hd, quant, cached))


@lru_cache(maxsize=None)
def _dec_slots(quant: bool, g: int, hd: int, device: int) -> int:
    """Blocks of K11's kind (hd's instance) that the card holds at once
    (the occupancy of its uncached shared memory, times the SMs)."""
    with torch.cuda.device(device):
        n = _cuda.library().mmrs_decode_slots(
            int(quant), hd, g,
            _dec_smem(0, g, padded_head_dim(hd), quant, False))
    if n < 1:
        raise RuntimeError(f"decode_attention kernel: no occupancy for "
                           f"G={g}, HD={hd}, quant={quant} ({n})")
    return n


def chunk_plan(rows: int, hd: int, quant: bool) -> Tuple[int, int]:
    """(warps per block, dynamic shared-memory bytes) of K10 for `rows` =
    G * C query rows a kv head, at hd's instance HDP: 16 rows a warp, up
    to 4 warps; the bf16 Q tile [64, HDP + 8], and two stages of K and V
    tiles [64, HDP + 8] bf16, or for an int8 cache two stages of raw [64,
    HDP] int8 tiles and their f32 scales plus the widened bf16 K and V
    tiles. Nothing grows with S."""
    hd = padded_head_dim(hd)
    tile = 2 * _KEYS * (hd + 8)
    smem = 3 * tile + 4 * _KEYS * hd + 16 * _KEYS if quant else 5 * tile
    return min(4, -(-rows // 16)), smem


def _common_checks(name: str, q: torch.Tensor, g: int, hd: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes a bf16 q, got {q.dtype}")
    if not 1 <= hd <= HEAD_DIMS[-1]:
        raise ValueError(f"{name} kernel supports head dims up to "
                         f"{HEAD_DIMS[-1]} (instances {HEAD_DIMS}), got {hd}")
    b, kvh = q.shape[:2]
    if not (b >= 1 and kvh >= 1 and g >= 1):
        raise ValueError(f"{name} kernel needs 1 <= B, KVH, G, got "
                         f"B={b}, KVH={kvh}, G={g}")


def group_pieces(g: int, hd: int = 64) -> Tuple[Tuple[int, int, int], ...]:
    """K11 at any G: the (first head, heads, width) of each launch. Each
    launch reads the whole view once, so there are as few as the largest
    instance allows (ceil(G / 8); ceil(G / 4) at hd past 256, ceil(G / 2)
    past 512): pieces of that many heads, the last one's heads padded with
    zero queries up to the smallest instance that holds them (G = 7 -> one
    launch at 8; 12 -> 8 + 4). Every head's softmax is its own, so a split
    changes no result; padded heads are dropped."""
    hdp = padded_head_dim(hd)
    widths = _GROUPS[:4 if hdp <= K10_MAX_HD else 3 if hdp <= 512 else 2]
    top = widths[-1]
    pieces = []
    for start in range(0, g, top):
        heads = min(top, g - start)
        pieces.append((start, heads, next(w for w in widths if w >= heads)))
    return tuple(pieces)


def _on_the_card(name: str, q: torch.Tensor, k_cache, k_scales, v_cache,
                 v_scales, pos: Pos, launch) -> torch.Tensor:
    """The kernels' common route: the checks, a head dim off a multiple of
    8 zero-padded (q and a padded copy of the caches: zero dims add exact
    zeros, and the instance, so K11's lane order, is the one hd takes;
    hd_scale stays hd's), and grids past MAX_GRID batch rows or kv heads
    sliced into launches over views. `launch(q, k_cache, k_scales,
    v_cache, v_scales, pos, scale)` runs one launch's worth."""
    _cuda.refuse_grad(name, q, k_cache, k_scales, v_cache, v_scales)
    hd = q.shape[-1]
    _common_checks(name, q, q.shape[2], hd)
    scale = hd_scale(hd)
    pad = -hd % 8
    if pad:
        q, k_cache, v_cache = (torch.nn.functional.pad(x, (0, pad))
                               for x in (q, k_cache, v_cache))
    b, kvh = q.shape[:2]
    if b <= MAX_GRID and kvh <= MAX_GRID:
        out = launch(q, k_cache, k_scales, v_cache, v_scales, pos, scale)
    else:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        for b0 in range(0, b, MAX_GRID):
            rows = slice(b0, b0 + MAX_GRID)
            p = pos[rows] if isinstance(pos, torch.Tensor) else pos
            for h0 in range(0, kvh, MAX_GRID):
                part = (rows, slice(h0, h0 + MAX_GRID))
                out[part] = launch(
                    q[part].contiguous(), k_cache[part],
                    None if k_scales is None else k_scales[part],
                    v_cache[part], None if v_scales is None else v_scales[part],
                    p, scale)
    return out[..., :hd].contiguous() if pad else out


def _decode_launch(q, k_cache, k_scales, v_cache, v_scales, pos_t, pos0,
                   quant: int, strides, scale: float,
                   plan_pairs: Optional[int] = None) -> torch.Tensor:
    """One K11 launch on q [B, KVH, G, HD] (G an instance of _GROUPS),
    planned for `plan_pairs` (row, kv head) pairs (default B * KVH)."""
    b, kvh, g, hd = q.shape
    s = k_cache.shape[2]
    plan = decode_plan(s, g, hd, bool(quant), plan_pairs or b * kvh,
                       _dec_slots(bool(quant), g, hd, q.device.index or 0))
    q = q.contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _cuda.check(_cuda.library().mmrs_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            None if pos_t is None else pos_t.data_ptr(), pos0, out.data_ptr(),
            b, kvh, g, hd, s, *strides, quant, scale, plan.cluster,
            plan.span, int(plan.cached), plan.smem, _cuda.stream_of(q)),
            "decode_attention")
    decode_attention.launches += 1
    return out


def _decode_cuda(q, k_cache, k_scales, v_cache, v_scales, pos: Pos,
                 plan_pairs: Optional[int] = None) -> torch.Tensor:
    return _on_the_card("decode_attention", q, k_cache, k_scales, v_cache,
                        v_scales, pos, partial(_decode_launches,
                                               plan_pairs=plan_pairs))


def _decode_launches(q, k_cache, k_scales, v_cache, v_scales, pos: Pos,
                     scale: float, plan_pairs: Optional[int] = None
                     ) -> torch.Tensor:
    """K11 on q [B, KVH, G, HD] (hd % 8 == 0, B and KVH in one grid): the
    launches of `group_pieces`."""
    b, kvh, g, hd = q.shape
    quant, strides = _cache_args("decode_attention", q, k_cache, k_scales,
                                 v_cache, v_scales)
    if any(st * k_cache.element_size() % 16 for st in k_cache.stride()[:2]):
        raise ValueError("decode_attention kernel needs 16-byte aligned cache "
                         "rows")
    pos_t, pos0 = _pos_args(pos, b, q.device)
    args = (k_cache, k_scales, v_cache, v_scales, pos_t, pos0, quant, strides,
            scale, plan_pairs)
    pieces = group_pieces(g, hd)
    if len(pieces) == 1 and pieces[0][2] == g:
        return _decode_launch(q, *args)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for start, heads, width in pieces:
        qp = q[:, :, start:start + heads]
        if width > heads:
            qp = torch.cat([qp, qp.new_zeros((b, kvh, width - heads, hd))], 2)
        out[:, :, start:start + heads] = _decode_launch(qp, *args)[:, :, :heads]
    return out


def _chunk_cuda(q, k_cache, k_scales, v_cache, v_scales, pos: Pos
                ) -> torch.Tensor:
    return _on_the_card("chunk_attention", q, k_cache, k_scales, v_cache,
                        v_scales, pos, _chunk_launch)


def _chunk_launch(q, k_cache, k_scales, v_cache, v_scales, pos: Pos,
                  scale: float) -> torch.Tensor:
    """K10 on q [B, KVH, G, C, HD] (hd % 8 == 0, B and KVH in one grid);
    past K10_MAX_HD, K11 once a query row c at position pos + c (its mask,
    key_pos <= pos + c, is the chunk's)."""
    b, kvh, g, c, hd = q.shape
    if padded_head_dim(hd) > K10_MAX_HD:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        for ci in range(c):
            out[:, :, :, ci] = _decode_launches(
                q[:, :, :, ci].contiguous(), k_cache, k_scales, v_cache,
                v_scales, pos + ci, scale)
        return out
    if not 1 <= g * c < 2 ** 31 // hd:
        raise ValueError(f"chunk_attention kernel: G * C = {g * c} rows")
    quant, strides = _cache_args("chunk_attention", q, k_cache, k_scales,
                                 v_cache, v_scales)
    if any(st * k_cache.element_size() % 16 for st in k_cache.stride()[:2]):
        raise ValueError("chunk_attention kernel needs 16-byte aligned cache "
                         "rows")
    s = k_cache.shape[2]
    warps, smem = chunk_plan(g * c, hd, bool(quant))
    q = q.contiguous()
    pos_t, pos0 = _pos_args(pos, b, q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _cuda.check(_cuda.library().mmrs_chunk_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            None if pos_t is None else pos_t.data_ptr(), pos0, out.data_ptr(),
            b, kvh, g, c, hd, s, *strides, quant, scale, warps, smem,
            _cuda.stream_of(q)), "chunk_attention")
    chunk_attention.launches += 1
    return out


def decode_attention(
    q: torch.Tensor,                  # [B, KVH, G, HD]
    k_cache: torch.Tensor,            # [B, KVH, S, HD] int8 or bf16
    k_scales: Optional[torch.Tensor],  # [B, KVH, S] f32 (int8) or None
    v_cache: torch.Tensor,
    v_scales: Optional[torch.Tensor],
    pos: Pos,                         # query position: int or [B]
    impl: str = "auto",
    plan_pairs: Optional[int] = None,
) -> torch.Tensor:                    # [B, KVH, G, HD] f32
    """One decode step's attention over the whole view (K11).
    `plan_pairs` sizes the launch for that many (row, kv head) pairs in
    place of B * KVH: a tensor-parallel shard of int8 weights passes the
    whole model's, so that each of its pairs is reduced as on one device
    (models/llama.forward)."""
    if _cuda.takes_kernel(impl, q):
        return _decode_cuda(q, k_cache, k_scales, v_cache, v_scales, pos,
                            plan_pairs)
    q_pos = query_positions(pos, q.shape[0], 1, q.device)
    return _attn_torch(q[:, :, :, None], k_cache, k_scales, v_cache,
                       v_scales, q_pos, lanes=True)[:, :, :, 0]


def chunk_attention(
    q: torch.Tensor,                  # [B, KVH, G, C, HD]
    k_cache: torch.Tensor,            # [B, KVH, S, HD] int8 or bf16
    k_scales: Optional[torch.Tensor],  # [B, KVH, S] f32 (int8) or None
    v_cache: torch.Tensor,
    v_scales: Optional[torch.Tensor],
    pos: Pos,                         # chunk-start position: int or [B]
    kv_limit: Optional[int] = None,   # read cache[:, :, :kv_limit] only
    impl: str = "auto",
) -> torch.Tensor:                    # [B, KVH, G, C, HD] f32
    """Causal attention of C query rows (at pos + c) over the cache prefix
    (K10). `kv_limit` cuts the view's S: the chunk attends no further."""
    kernel = _cuda.takes_kernel(impl, q)
    if kv_limit is not None:
        k_cache, v_cache = k_cache[:, :, :kv_limit], v_cache[:, :, :kv_limit]
        if k_scales is not None:
            k_scales = k_scales[:, :, :kv_limit]
            v_scales = v_scales[:, :, :kv_limit]
    if kernel:
        return _chunk_cuda(q, k_cache, k_scales, v_cache, v_scales, pos)
    b, _, _, c, _ = q.shape
    q_pos = query_positions(pos, b, c, q.device)
    return _attn_torch(q, k_cache, k_scales, v_cache, v_scales, q_pos)


decode_attention.launches = 0   # kernel launches, for showing the path ran it
chunk_attention.launches = 0
