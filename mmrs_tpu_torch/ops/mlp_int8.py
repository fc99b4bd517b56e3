"""Int8 transformer MLP — Hopper CUDA kernels + plain PyTorch version.

Counterpart of mmrs_tpu/ops/mlp_int8.py: one int8 MLP block, quantize ->
int8 w1 -> bias, GELU -> quantize -> int8 w2 -> bias, for the int8 serving
tower. On the card (`csrc/mlp_int8.cu`) a call is four launches: a row
quantization of x, an s8 tensor-core GEMM with w1 whose epilogue applies
scales, bias and the activation and writes f32 h (and each row's max |h|
per column tile) to device memory, a row quantization of h, and the same
GEMM with w2 whose epilogue writes x's dtype. The plain version is `mlp_int8_reference`'s math in PyTorch:
per-row int8 activation quantization (half to even), exact int8 products,
f32 rescale and bias, the activation in f32 (h is never rounded to bf16),
and the output rounded once to x's dtype. Both give the same bits.

The activation is QuickGELU, GELU or GELU's tanh approximation. The
kernels take H in whole 32s: SigLIP's H = 4304 is padded to 4320 by zero
units once, when its tower is quantized (`pad_hidden`,
models/quantize.py).

Weights are in the port's [out, in] layout: w1_q [H, W], w2_q [W, H], with
per-output-channel f32 scales and biases.

`mlp_int8_fused(..., impl=)`: "auto" (the kernels for CUDA tensors, the
plain version for CPU tensors) or "torch" (the plain version anywhere).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from mmrs_tpu_torch.ops import _cuda
from mmrs_tpu_torch.ops.int8 import int8_linear, quantize_act

# csrc/mlp_int8.cu's GEMM geometry (kTileM, kTileN, kStages, kSmemBytes),
# checked against the built library at first load: 128 x 128 output
# tiles, a ring of K steps of 128 bytes (an A and a B tile of 128-byte rows
# a stage), plus the 1024-byte tile alignment
TILE_M = 128
TILE_N = 128
STAGES = 3
SMEM_BYTES = STAGES * (TILE_M + TILE_N) * 128 + 1024
MAX_GRID_Y = 65535
_ACT_CODE = {"quick_gelu": 0, "gelu": 1, "gelu_tanh": 2}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _activation(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act == "gelu_tanh":
        return F.gelu(h, approximate="tanh")
    return F.gelu(h)


def pad_hidden(w1_q, s1, b1, w2_q):
    """The layers with H padded to a multiple of 32 by zero units (zero
    codes, unit scales, zero biases): a zero unit's h is act(0) = 0, whose
    code is 0, so the padded MLP gives the same bits (SigLIP's H = 4304)."""
    pad = -w1_q.shape[0] % 32
    if not pad:
        return w1_q, s1, b1, w2_q
    return (F.pad(w1_q, (0, 0, 0, pad)), F.pad(s1, (0, pad), value=1.0),
            F.pad(b1, (0, pad)), F.pad(w2_q, (0, pad)).contiguous())


def _mlp_int8_torch(x, w1_q, s1, b1, w2_q, s2, b2, act: str) -> torch.Tensor:
    xq, sx = quantize_act(x)
    h = _activation(int8_linear(xq, sx, w1_q, s1, b1, torch.float32), act)
    hq, sh = quantize_act(h)
    return int8_linear(hq, sh, w2_q, s2, b2, x.dtype)


class MlpPlan(NamedTuple):
    tile_m: int           # rows of a GEMM block (two warpgroups of 64)
    tile_n: int           # output columns of a GEMM block (one wgmma n128)
    stages: int           # cp.async ring depth, K steps of 128 bytes
    h_shape: Tuple[int, int]     # the f32 h buffer [M, H] (its int8 codes alike)
    hmax_shape: Tuple[int, int]  # each row's max |h| per column tile of x.w1


def mlp_plan(m: int, w: int, h: int) -> MlpPlan:
    """Launch shape of the kernels for x [m, w], w1 [h, w], w2 [w, h]: two
    s8 GEMMs of 128 x 128 output tiles fed by a 3-stage ring, with f32 h
    [m, h], its per-tile row maxima and the int8 codes of x and h in device
    memory between them. Refuses, with a message, what they cannot run: W
    or H not a multiple of 32 (whole 16-byte chunks of both operands,
    4-value row quantization; a ragged H is padded once beforehand,
    `pad_hidden`), M < 1, or more than 65,535 column tiles."""
    if w % 32 or h % 32 or w < 32 or h < 32:
        raise ValueError(f"mlp_int8 kernel needs W % 32 == 0 and H % 32 == "
                         f"0 (32-byte K steps; pad a ragged H with "
                         f"pad_hidden), got W={w}, H={h}")
    if not 1 <= m < 2 ** 31:
        raise ValueError(f"mlp_int8 kernel needs 1 <= M < 2^31, got M={m}")
    if -(-max(w, h) // TILE_N) > MAX_GRID_Y:
        raise ValueError(f"mlp_int8 kernel: W={w}, H={h} need more than "
                         f"{MAX_GRID_Y} column tiles of {TILE_N}")
    return MlpPlan(TILE_M, TILE_N, STAGES, (m, h), (m, -(-h // TILE_N)))


@lru_cache(maxsize=None)
def _library():
    """The kernel library, after checking that its GEMM geometry is the one
    `mlp_plan` describes."""
    lib = _cuda.library()
    built = tuple(lib.mmrs_mlp_int8_geometry(i) for i in range(4))
    want = (TILE_M, TILE_N, STAGES, SMEM_BYTES)
    if built != want:
        raise RuntimeError(
            f"csrc/mlp_int8.cu has (kTileM, kTileN, kStages, kSmemBytes) = "
            f"{built}, but ops/mlp_int8.py plans for {want}")
    return lib


def _mlp_int8_cuda(x, w1_q, s1, b1, w2_q, s2, b2, act: str) -> torch.Tensor:
    _cuda.refuse_grad("mlp_int8", x, s1, b1, s2, b2)
    _cuda.require_cuda("mlp_int8", x, w1_q, s1, b1, w2_q, s2, b2)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"mlp_int8 kernel takes bf16 or f32 x, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"mlp_int8 takes x [M, W], got {tuple(x.shape)}")
    m, w = x.shape
    h = w1_q.shape[0]
    if (w1_q.shape != (h, w) or w2_q.shape != (w, h) or s1.shape != (h,)
            or b1.shape != (h,) or s2.shape != (w,) or b2.shape != (w,)):
        raise ValueError(
            f"mlp_int8: x [{m}, {w}] needs w1 [H, {w}], w2 [{w}, H] and "
            f"per-channel scales/biases, got w1 {tuple(w1_q.shape)}, w2 "
            f"{tuple(w2_q.shape)}")
    if w1_q.dtype != torch.int8 or w2_q.dtype != torch.int8 or any(
            t.dtype != torch.float32 for t in (s1, b1, s2, b2)):
        raise ValueError("mlp_int8 kernel takes int8 weights and f32 "
                         "scales and biases")
    plan = mlp_plan(m, w, h)
    if w1_q.data_ptr() % 16 or w2_q.data_ptr() % 16:
        raise ValueError("mlp_int8 kernel needs 16-byte aligned weights")
    out = torch.empty_like(x)
    _launch(x, w1_q, s1, b1, w2_q, s2, b2, act, out, _scratch(x, plan))
    mlp_int8_fused.launches += 1
    return out


def _scratch(x: torch.Tensor, plan: MlpPlan) -> Tuple[torch.Tensor, ...]:
    """The buffers between the four launches: the codes and row scales of
    x, f32 h and its per-tile row maxima, the codes and row scales of h."""
    m, w = x.shape
    dev = x.device
    return (torch.empty((m, w), dtype=torch.int8, device=dev),
            torch.empty((m,), dtype=torch.float32, device=dev),
            torch.empty(plan.h_shape, dtype=torch.float32, device=dev),
            torch.empty(plan.hmax_shape, dtype=torch.float32, device=dev),
            torch.empty(plan.h_shape, dtype=torch.int8, device=dev),
            torch.empty((m,), dtype=torch.float32, device=dev))


def _launch(x, w1_q, s1, b1, w2_q, s2, b2, act, out, scratch,
            only: int = -1) -> None:
    """The four launches on checked inputs, or (`only` 0-3) one of them
    alone on the scratch a whole call left (for timing a launch)."""
    xq, sx, hbuf, hmax, hq, sh = scratch
    (m, w), h = x.shape, w1_q.shape[0]
    with torch.cuda.device(x.device):
        _cuda.check(_library().mmrs_mlp_int8(
            x.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2_q.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            xq.data_ptr(), sx.data_ptr(), hbuf.data_ptr(), hmax.data_ptr(),
            hq.data_ptr(), sh.data_ptr(), m, w, h, _DTYPE_CODE[x.dtype],
            _ACT_CODE[act], only, _cuda.stream_of(x)), "mlp_int8")


def mlp_int8_fused(
    x: torch.Tensor,       # [M, W] bf16/f32
    w1_q: torch.Tensor,    # [H, W] int8
    s1: torch.Tensor,      # [H] f32 per-output-channel scales
    b1: torch.Tensor,      # [H] f32
    w2_q: torch.Tensor,    # [W, H] int8
    s2: torch.Tensor,      # [W] f32
    b2: torch.Tensor,      # [W] f32
    act: str = "quick_gelu",
    impl: str = "auto",
) -> torch.Tensor:         # [M, W] in x.dtype
    """One transformer MLP block on int8 weights. On a CUDA tensor the
    kernel runs, or this raises: there is no fallback."""
    kernel = _cuda.takes_kernel(impl, x)
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")
    if kernel:
        return _mlp_int8_cuda(x, w1_q, s1, b1, w2_q, s2, b2, act)
    return _mlp_int8_torch(x, w1_q, s1, b1, w2_q, s2, b2, act)


mlp_int8_fused.launches = 0   # calls that launched the kernels (four a call)
