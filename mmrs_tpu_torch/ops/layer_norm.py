"""The towers' LayerNorm (E2) — Hopper CUDA kernel + plain PyTorch version.

`models/layers.LayerNorm` normalizes each row of bf16 activations over its
last dimension with f32 statistics and rounds once back to bf16, as the
JAX package's `layer_norm` (mmrs_tpu/models/layers.py) does in jnp, which
XLA fuses. The plain version is the three ops the layer always ran: the
bf16 -> f32 copy, `F.layer_norm` in f32, the f32 -> bf16 copy (about 20
bytes an element through device memory). The kernel
(`csrc/layer_norm.cu`) does the whole norm in one pass at 4 bytes an
element: the JAX order of arithmetic (the f32 mean, then the f32 mean of
squared deviations, then `(x - mean) * rsqrt(var + eps) * gamma + beta`)
and one rounding. Both compute in f32 with sums in different orders: an
element differs by one bf16 ulp where their f32 results fall on either
side of a rounding boundary, and an output near zero by the f32 rounding
of the row's mean carried through its gain.

`layer_norm(x, weight, bias, eps, impl=)`: "auto" runs the kernel for a
bf16 CUDA tensor while autograd does not record the call; a CPU tensor,
any other dtype (the f32 towers), a recording autograd (training) or
`impl="torch"` keep the plain ops. The kernel takes rows [..., W] with W %
8 == 0 and W <= 2048 (a 2-D view at any row stride that is a multiple of
8, as CLIP's `ln_post` on the CLS rows) and weight and bias [W] in f32
(the towers) or bf16 (LLaVA's tower, cast whole), read as stored; on
anything else it raises.
"""

from __future__ import annotations

from functools import lru_cache

import torch
import torch.nn.functional as F

from mmrs_tpu_torch.ops import _cuda

THREADS = 256                 # csrc/layer_norm.cu kThreads
WARPS = THREADS // 32         # rows a block takes at once: one a warp
VECTOR = 8                    # bf16 values in a 16-byte load
MAX_WIDTH = 8 * 32 * VECTOR   # csrc/layer_norm.cu: kMaxVpl vectors a lane


def _layer_norm_torch(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps).to(x.dtype)


def layer_norm_plan(rows: int, slots: int) -> int:
    """Blocks of THREADS for `rows` rows on a card that holds `slots` blocks
    at once: one warp a row, at most one wave; the warps stride over the
    rest."""
    return max(1, min(-(-rows // WARPS), slots))


@lru_cache(maxsize=None)
def _slots(width: int, bf16_params: bool, device: int) -> int:
    with torch.cuda.device(device):
        n = _cuda.library().mmrs_layer_norm_slots(width, int(bf16_params))
    if n < 1:
        raise RuntimeError("layer_norm: the occupancy query failed")
    return n


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    """x as [M, W] rows the kernel reads in place (unit column stride, a
    row stride that keeps 16-byte loads aligned), else a fresh contiguous
    copy (`contiguous()` would keep a contiguous view off the 16-byte
    grid)."""
    rows = x.reshape(-1, x.shape[-1])
    if (rows.stride(-1) != 1 or rows.stride(0) % VECTOR
            or rows.data_ptr() % 16):
        rows = rows.clone(memory_format=torch.contiguous_format)
    return rows


def _layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    _cuda.refuse_grad("layer_norm", x, weight, bias)
    _cuda.require_cuda("layer_norm", weight, bias)
    if x.device != weight.device:
        raise ValueError(f"layer_norm: inputs on {x.device} and "
                         f"{weight.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"layer_norm kernel takes bf16 rows, got {x.dtype}")
    w = x.shape[-1] if x.dim() else 0
    if w < VECTOR or w % VECTOR or w > MAX_WIDTH:
        raise ValueError(f"layer_norm kernel needs W % 8 == 0 and W <= "
                         f"{MAX_WIDTH}, got {tuple(x.shape)}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype not in (torch.float32, torch.bfloat16) or p.shape != (w,):
            raise ValueError(f"layer_norm kernel takes an f32 or bf16 {name} "
                             f"[{w}], got {p.dtype} {tuple(p.shape)}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"layer_norm kernel takes weight and bias of one "
                         f"dtype, got {weight.dtype} and {bias.dtype}")
    bf16_params = weight.dtype == torch.bfloat16
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = _rows_view(x)
    m = rows.shape[0]
    if m == 0:
        return out
    dev = x.get_device()
    blocks = layer_norm_plan(m, _slots(w, bf16_params, dev))
    # the launcher makes `dev` current itself, only where it is not
    _cuda.check(_cuda.library().mmrs_layer_norm(
        rows.data_ptr(), rows.stride(0), weight.data_ptr(), bias.data_ptr(),
        int(bf16_params), out.data_ptr(), m, w, eps, blocks, dev,
        _cuda.stream_of(x)),
        "layer_norm")
    layer_norm.launches += 1
    return out


def takes_kernel(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, impl: str) -> bool:
    """Whether `layer_norm` launches the kernel: the route rule
    (_cuda.takes_kernel), bf16 rows, and autograd not recording the
    call."""
    return (_cuda.takes_kernel(impl, x) and x.dtype == torch.bfloat16
            and not _cuda.records_grad(x, weight, bias))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, impl: str = "auto") -> torch.Tensor:
    """LayerNorm over x's last dimension with f32 statistics, in x's dtype:
    the kernel where `takes_kernel` says so (it raises on what it cannot
    take), else the plain ops."""
    if takes_kernel(x, weight, bias, impl):
        return _layer_norm_cuda(x, weight, bias, eps)
    return _layer_norm_torch(x, weight, bias, eps)


layer_norm.launches = 0   # kernel launches, for showing the path ran it
