"""The float dense layer's epilogue — Hopper CUDA kernel + plain PyTorch
version.

`models/layers.dense` multiplies bf16 operands into f32 sums (cuBLAS,
`out_dtype=torch.float32`); what follows is its epilogue: the f32 bias
added to the sums, one rounding to the compute dtype, and, where an MLP's
first layer hands it over, the activation. The plain version is the ops
the layer always ran: `torch.add(acc, b, out=)` (or `(acc + b).to()` while
autograd records), then `quick_gelu` / `gelu` op by op. The kernel
(`csrc/dense_epilogue.cu`) does all of it in one pass over the sums,
with the same roundings, bit for bit: 6 bytes an element, where the plain
ops move about 6 for the bias and about 34 more for QuickGELU.

`bias_act(y32, bias, act, out_dtype, impl=)`: "auto" (the kernel for CUDA
tensors, the plain version for CPU tensors) or "torch" (the plain version
anywhere). The kernel takes f32 sums [..., N] with N % 8 == 0, an f32
bias [N] or None, and writes bf16; on anything else it raises.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from mmrs_tpu_torch.ops import _cuda

THREADS = 256         # csrc/dense_epilogue.cu kThreads
COLUMNS = 8           # columns a thread takes: two 16-byte f32 loads
_ACT_CODE = {None: 0, "quick_gelu": 1, "gelu": 2}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float()).to(x.dtype)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu}


def act_name(act: Optional[Callable]) -> Optional[str]:
    """The name `bias_act` (and the int8 MLP) take for an activation: None
    for none, else its key in ACTIVATIONS; any other callable raises."""
    if act is None:
        return None
    for name, fn in ACTIVATIONS.items():
        if fn is act:
            return name
    raise ValueError(f"no epilogue for the activation {act!r}")


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records an op on these tensors (a training step)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _bias_act_torch(y32: torch.Tensor, bias: Optional[torch.Tensor],
                    act: Optional[str], out_dtype: torch.dtype
                    ) -> torch.Tensor:
    if bias is None:
        y = y32.to(out_dtype)
    elif records_grad(y32, bias):   # `out=` has no autograd formula
        y = (y32 + bias.float()).to(out_dtype)
    else:
        # one pass: the f32 sum, rounded as it is stored
        y = torch.add(y32, bias.float(),
                      out=torch.empty_like(y32, dtype=out_dtype))
    return y if act is None else ACTIVATIONS[act](y)


def bias_act_plan(m: int, n: int, slots: int) -> int:
    """Blocks of THREADS for m rows of n columns on a card that holds
    `slots` blocks at once: enough for every 8-column group of every row,
    at most one wave, rounded up to a multiple of n / 8 groups' worth of
    threads, so that each thread keeps one column group (its bias) down
    all the rows it takes."""
    groups = n // COLUMNS
    unit = groups // math.gcd(groups, THREADS)     # blocks of one whole stride
    need = -(-m * groups // THREADS)
    blocks = max(1, min(need, slots))
    return -(-blocks // unit) * unit


@lru_cache(maxsize=None)
def _slots(act: int, has_bias: bool, device: int) -> int:
    with torch.cuda.device(device):
        n = _cuda.library().mmrs_bias_act_slots(act, int(has_bias))
    if n < 1:
        raise RuntimeError("dense_epilogue: the occupancy query failed")
    return n


def _bias_act_cuda(y32: torch.Tensor, bias: Optional[torch.Tensor],
                   act: Optional[str], out_dtype: torch.dtype
                   ) -> torch.Tensor:
    _cuda.refuse_grad("bias_act", y32, bias)
    _cuda.require_cuda("bias_act", y32,
                       *(() if bias is None else (bias,)))
    if y32.dtype != torch.float32 or out_dtype != torch.bfloat16:
        raise ValueError(f"bias_act kernel takes f32 sums and writes bf16, "
                         f"got {y32.dtype} -> {out_dtype}")
    n = y32.shape[-1] if y32.dim() else 0
    if n < COLUMNS or n % COLUMNS:
        raise ValueError(f"bias_act kernel needs N % 8 == 0 columns, got "
                         f"{tuple(y32.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (n,)):
        raise ValueError(f"bias_act kernel takes an f32 bias [{n}], got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")
    out = torch.empty_like(y32, dtype=out_dtype)
    m = y32.numel() // n
    if m == 0:
        return out
    if y32.data_ptr() % 16:
        raise ValueError("bias_act kernel needs 16-byte aligned sums")
    dev = y32.get_device()
    blocks = bias_act_plan(m, n, _slots(_ACT_CODE[act], bias is not None,
                                        dev))
    # the launcher makes `dev` current itself, only where it is not: no
    # per-launch device context here
    _cuda.check(_cuda.library().mmrs_bias_act(
        y32.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, _ACT_CODE[act], blocks, dev,
        _cuda.stream_of(y32)), "bias_act")
    bias_act.launches += 1
    return out


def bias_act(y32: torch.Tensor, bias: Optional[torch.Tensor],
             act: Optional[str], out_dtype: torch.dtype,
             impl: str = "auto") -> torch.Tensor:
    """act(round(y32 + bias)) in out_dtype: the f32 sums of a dense layer,
    plus its f32 bias (None: none), rounded once, then `act` ("quick_gelu",
    "gelu" or None) with the plain ops' roundings. On a CUDA tensor the
    kernel runs, or this raises."""
    if impl not in ("auto", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "torch" or y32.device.type == "cpu":
        return _bias_act_torch(y32, bias, act, out_dtype)
    return _bias_act_cuda(y32, bias, act, out_dtype)


bias_act.launches = 0   # kernel launches, for showing the path ran it
