"""Fused multi-head attention for short sequences — Hopper CUDA kernel +
plain PyTorch version.

Counterpart of mmrs_tpu/ops/attention.py. The vision towers' attention is
unmasked over short sequences (T = 50 for B/32, 257 for L/14, 577 for the
336-px L/14, 729 for SigLIP so400m/14 at 384 px, heads of 72). The kernels
(`csrc/mha_short_seq.cu`) read each head's column
slice straight from the [B, T, W] projections: bf16 heads up to 128 wide
run on tensor cores (key tiles streamed through shared memory, an exact
two-pass softmax in registers); f32, and bf16 heads wider than 128, on
CUDA cores with key tiles (and 64-dim chunks of the head) streamed the
same way, the same two-pass softmax, and 16 logits or outputs a thread.
Neither route's shared memory grows with T, and batches past
65,535 run as several launches. The plain version splits heads with views
and runs the same math in f32.

Math (both versions, as the Pallas `_mha_kernel`): q already carries
1/sqrt(hd); logits and softmax in f32; the probabilities are rounded to
v's dtype before the AV product, which accumulates in f32; the output is
in q's dtype.

`impl`: "auto" (the kernel for CUDA tensors, the plain version for CPU
tensors) or "torch" (the plain version anywhere).

`pool_attention` is SigLIP's MAP head's attention: one learned query per
image over the tower's T tokens, in plain PyTorch on any device (no
kernel: it is 1/T of the tower's attention).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mmrs_tpu_torch.ops import _cuda

SMEM_LIMIT = 232448   # shared memory one block may use on Hopper
MMA_MAX_HD = 128      # widest bf16 head of the tensor-core route
MMA_HDP = (32, 64, 80, 128)   # the tensor-core route's padded head dims
MMA_KEYS = 64         # csrc/attention_mma.cuh kAttnKeys
MMA_WARPS = 8         # csrc/mha_short_seq.cu kMmaThreads / 32
FMA_TILE = 64         # csrc/mha_short_seq.cu kFmaTile: rows, keys, dims a step
FMA_SMEM = 4 * FMA_TILE * (FMA_TILE + 4) * 4   # kFmaSmem: four [64][68] f32
MAX_BATCH = 65535     # images a launch takes (the grid's z extent)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _mha_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
               ) -> torch.Tensor:
    b, t, w = q.shape
    hd = w // heads

    def split(x):                                 # [B, H, T, hd] f32
        return x.reshape(b, t, heads, hd).transpose(1, 2).float()

    logits = split(q) @ split(k).transpose(-1, -2)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = probs.float() @ split(v)
    return out.transpose(1, 2).reshape(b, t, w).to(q.dtype)


class MhaPlan(NamedTuple):
    route: str    # "mma": bf16 on tensor cores; "fma": CUDA cores
    rows: int     # query rows per block
    smem: int     # dynamic shared-memory bytes


def mha_plan(t: int, hd: int, dtype: torch.dtype) -> MhaPlan:
    """Launch shape of the kernel. bf16 with hd <= 128: tensor cores, 16
    query rows per warp, 4 to 8 warps (fewer for T < 64), shared memory
    bounded whatever T is: the Q tile [rows, hdp + 8] and a double-buffered
    ring of K and V tiles [64, hdp + 8], hdp = hd padded to 32, 64, 80 or
    128 (80: SigLIP's heads of 72, and ViT-H/14's of 80).
    Otherwise the CUDA-core route: 64 query rows against key tiles of 64,
    64 head dims at a time, in FMA_SMEM bytes whatever T and hd are (Q and
    K chunks, the V chunk and the probabilities, [64][68] f32 each)."""
    if dtype == torch.bfloat16 and hd <= MMA_MAX_HD:
        hdp = next(p for p in MMA_HDP if hd <= p)
        # the fewest padded query rows, then the most warps (fewer blocks
        # restaging K and V): 8 warps at T = 577, 6 at 257, 4 at 50
        fewest = min(4, -(-t // 16))
        rows = 16 * min(range(fewest, MMA_WARPS + 1),
                        key=lambda w: (-(-t // (16 * w)) * w, -w))
        return MhaPlan("mma", rows, 2 * (rows + 4 * MMA_KEYS) * (hdp + 8))
    return MhaPlan("fma", FMA_TILE, FMA_SMEM)


def _mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
              ) -> torch.Tensor:
    _cuda.refuse_grad("mha_short_seq", q, k, v)
    _cuda.require_cuda("mha_short_seq", q, k, v)
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"mha_short_seq takes q, k, v of one [B, T, W] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"mha_short_seq kernel takes bf16 or f32 (one "
                         f"type), got {q.dtype}, {k.dtype}, {v.dtype}")
    b, t, w = q.shape
    if heads < 1 or w % heads:
        raise ValueError(f"width {w} is not a multiple of heads={heads}")
    if not (1 <= b and heads <= 65535):
        raise ValueError(f"mha_short_seq kernel needs 1 <= B and heads <= "
                         f"65535, got B={b}, heads={heads}")
    hd = w // heads
    plan = mha_plan(t, hd, q.dtype)
    out = torch.empty_like(q)
    lib = _cuda.library()
    vec = hd % 8 == 0 and w % 8 == 0 and all(
        x.data_ptr() % 16 == 0 for x in (q, k, v, out))
    step = t * w * q.element_size()     # bytes of one image
    with torch.cuda.device(q.device):
        for b0 in range(0, b, MAX_BATCH):   # a launch per 65,535 images
            nb = min(MAX_BATCH, b - b0)
            ptrs = [x.data_ptr() + b0 * step for x in (q, k, v, out)]
            if plan.route == "mma":
                err = lib.mmrs_mha_short_seq_mma(
                    *ptrs, nb, t, w, heads, int(vec), plan.rows // 16,
                    plan.smem, _cuda.stream_of(q))
            else:
                err = lib.mmrs_mha_short_seq(
                    *ptrs, nb, t, w, heads, _DTYPE_CODE[q.dtype], plan.smem,
                    _cuda.stream_of(q))
            _cuda.check(err, "mha_short_seq")
    mha_short_seq.launches += 1
    return out


def mha_short_seq(
    q: torch.Tensor,        # [B, T, W], scale already folded into q
    k: torch.Tensor,        # [B, T, W]
    v: torch.Tensor,        # [B, T, W]
    heads: int,
    impl: str = "auto",
) -> torch.Tensor:          # [B, T, W]
    """Fused MHA for short sequences; softmax in f32, no head transposes in
    device memory. On a CUDA tensor the kernel runs, or this raises."""
    if _cuda.takes_kernel(impl, q):
        return _mha_cuda(q, k, v, heads)
    return _mha_torch(q, k, v, heads)


mha_short_seq.launches = 0   # kernel launches, for showing the path ran it


def pool_attention(
    q: torch.Tensor,        # [B, Q, W], scale already folded into q
    k: torch.Tensor,        # [B, T, W]
    v: torch.Tensor,        # [B, T, W]
    heads: int,
) -> torch.Tensor:          # [B, Q, W]
    """Q queries a row (SigLIP's MAP head: one probe) over T keys, with
    mha_short_seq's math: f32 logits and softmax, the probabilities
    rounded to v's dtype, f32 sums, the output in q's dtype. Plain ops on
    every device: it takes no `impl`."""
    b, nq, w = q.shape
    t, hd = k.shape[1], w // heads

    def split(x, n):                              # [B, H, n, hd] f32
        return x.reshape(b, n, heads, hd).transpose(1, 2).float()

    logits = split(q, nq) @ split(k, t).transpose(-1, -2)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = probs.float() @ split(v, t)
    pool_attention.launches += 1
    return out.transpose(1, 2).reshape(b, nq, w).to(q.dtype)


pool_attention.launches = 0   # calls, for showing the path ran it
