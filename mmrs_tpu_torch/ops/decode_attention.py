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

from typing import Optional, Tuple, Union

import numpy as np
import torch

from mmrs_tpu_torch.ops import _cuda

SMEM_LIMIT = 232448       # shared memory one block may use on Hopper
_DEC_WARPS = 8            # K11 warps per block (csrc: kDecThreads / 32)
_KEYS = 64                # K10 keys per staged tile (csrc: kAttnKeys)
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)

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


def _attn_torch(q: torch.Tensor, k_cache, k_scales, v_cache, v_scales,
                q_pos: torch.Tensor) -> torch.Tensor:
    """q [B, KVH, G, T, HD], caches [B, KVH, S, HD], q_pos [B, T] -> f32
    [B, KVH, G, T, HD]."""
    s = k_cache.shape[2]
    k = k_cache.to(torch.bfloat16).float()[:, :, None]       # [B,KVH,1,S,HD]
    v = v_cache.to(torch.bfloat16).float()[:, :, None]
    logits = q.to(torch.bfloat16).float() @ k.transpose(-1, -2)
    if k_scales is not None:
        logits = logits * k_scales[:, :, None, None, :]
    logits = logits * hd_scale(q.shape[-1])
    key_pos = torch.arange(s, device=q.device)
    mask = key_pos <= q_pos[:, :, None]                       # [B, T, S]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
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


def decode_smem(g: int, s: int, hd: int) -> int:
    """K11's dynamic shared memory: f32 logits [G, S] and the warps'
    partial outputs [8, G, HD]."""
    return 4 * (g * s + _DEC_WARPS * g * hd)


def chunk_plan(rows: int, hd: int, quant: bool) -> Tuple[int, int]:
    """(warps per block, dynamic shared-memory bytes) of K10 for `rows` =
    G * C query rows a kv head: 16 rows a warp, up to 4 warps; the bf16 Q
    tile [64, HD + 8], and two stages of K and V tiles [64, HD + 8] bf16,
    or for an int8 cache two stages of raw [64, HD] int8 tiles and their
    f32 scales plus the widened bf16 K and V tiles. Nothing grows with S."""
    tile = 2 * _KEYS * (hd + 8)
    smem = 3 * tile + 4 * _KEYS * hd + 16 * _KEYS if quant else 5 * tile
    return min(4, -(-rows // 16)), smem


def _common_checks(name: str, q: torch.Tensor, g: int, hd: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes a bf16 q, got {q.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel supports head dims {_HEAD_DIMS}, "
                         f"got {hd}")
    b, kvh = q.shape[:2]
    if not (1 <= b <= 65535 and 1 <= kvh <= 65535 and g >= 1):
        raise ValueError(f"{name} kernel needs 1 <= B, KVH <= 65535, got "
                         f"B={b}, KVH={kvh}, G={g}")


def _decode_cuda(q, k_cache, k_scales, v_cache, v_scales, pos: Pos
                 ) -> torch.Tensor:
    b, kvh, g, hd = q.shape
    _common_checks("decode_attention", q, g, hd)
    if g not in _GROUPS:
        raise ValueError(f"decode_attention kernel takes G in {_GROUPS}, "
                         f"got {g}")
    quant, strides = _cache_args("decode_attention", q, k_cache, k_scales,
                                 v_cache, v_scales)
    s = k_cache.shape[2]
    smem = decode_smem(g, s, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode_attention kernel: G={g}, S={s} needs {smem}"
                         f" bytes of shared memory (limit {SMEM_LIMIT})")
    q = q.contiguous()
    pos_t, pos0 = _pos_args(pos, b, q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _cuda.check(_cuda.library().mmrs_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scales.data_ptr() if quant else None,
            v_scales.data_ptr() if quant else None,
            None if pos_t is None else pos_t.data_ptr(), pos0, out.data_ptr(),
            b, kvh, g, hd, s, *strides, quant, hd_scale(hd), smem,
            _cuda.stream_of(q)), "decode_attention")
    decode_attention.launches += 1
    return out


def _chunk_cuda(q, k_cache, k_scales, v_cache, v_scales, pos: Pos
                ) -> torch.Tensor:
    b, kvh, g, c, hd = q.shape
    _common_checks("chunk_attention", q, g, hd)
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
            b, kvh, g, c, hd, s, *strides, quant, hd_scale(hd), warps, smem,
            _cuda.stream_of(q)), "chunk_attention")
    chunk_attention.launches += 1
    return out


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")


def decode_attention(
    q: torch.Tensor,                  # [B, KVH, G, HD]
    k_cache: torch.Tensor,            # [B, KVH, S, HD] int8 or bf16
    k_scales: Optional[torch.Tensor],  # [B, KVH, S] f32 (int8) or None
    v_cache: torch.Tensor,
    v_scales: Optional[torch.Tensor],
    pos: Pos,                         # query position: int or [B]
    impl: str = "auto",
) -> torch.Tensor:                    # [B, KVH, G, HD] f32
    """One decode step's attention over the whole view (K11)."""
    _check_impl(impl)
    if impl == "torch" or q.device.type == "cpu":
        b = q.shape[0]
        q_pos = query_positions(pos, b, 1, q.device)
        return _attn_torch(q[:, :, :, None], k_cache, k_scales, v_cache,
                           v_scales, q_pos)[:, :, :, 0]
    return _decode_cuda(q, k_cache, k_scales, v_cache, v_scales, pos)


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
    _check_impl(impl)
    if kv_limit is not None:
        k_cache, v_cache = k_cache[:, :, :kv_limit], v_cache[:, :, :kv_limit]
        if k_scales is not None:
            k_scales = k_scales[:, :, :kv_limit]
            v_scales = v_scales[:, :, :kv_limit]
    if impl == "torch" or q.device.type == "cpu":
        b, _, _, c, _ = q.shape
        q_pos = query_positions(pos, b, c, q.device)
        return _attn_torch(q, k_cache, k_scales, v_cache, v_scales, q_pos)
    return _chunk_cuda(q, k_cache, k_scales, v_cache, v_scales, pos)


decode_attention.launches = 0   # kernel launches, for showing the path ran it
chunk_attention.launches = 0
