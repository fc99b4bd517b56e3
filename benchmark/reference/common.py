"""Plain float32 layers shared by the reference towers."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def fake_int8(t: torch.Tensor) -> torch.Tensor:
    """Rows of t rounded to int8 codes with one scale a row (max |t| / 127)
    and scaled back: the control's operands."""
    s = t.abs().amax(-1, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.round(t / s).clamp(-127, 127) * s


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           int8: bool = False) -> torch.Tensor:
    """x @ w.T + b in float32 (w is [out, in])."""
    x, w = x.float(), w.float()
    if int8:
        x, w = fake_int8(x), fake_int8(w)
    y = x @ w.T
    return y if b is None else y + b.float()


def layer_norm(x: torch.Tensor, w: Weights, name: str, eps: float
               ) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w[f"{name}.weight"].float(),
                        w[f"{name}.bias"].float(), eps)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": gelu}


def attention(x: torch.Tensor, w: Weights, name: str, heads: int,
              mask: Optional[torch.Tensor], int8: bool) -> torch.Tensor:
    """Multi-head self-attention of [B, T, W] rows; `mask` is additive and
    broadcasts to [B, heads, T, T]."""
    b, t, width = x.shape
    hd = width // heads

    def proj(p):
        y = linear(x, w[f"{name}.w{p}.weight"], w[f"{name}.w{p}.bias"], int8)
        return y.reshape(b, t, heads, hd).transpose(1, 2)

    q, k, v = proj("q"), proj("k"), proj("v")
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        logits = logits + mask
    out = torch.softmax(logits, dim=-1) @ v
    out = out.transpose(1, 2).reshape(b, t, width)
    return linear(out, w[f"{name}.wo.weight"], w[f"{name}.wo.bias"], int8)


def mlp(x: torch.Tensor, w: Weights, name: str, act, int8: bool
        ) -> torch.Tensor:
    h = act(linear(x, w[f"{name}.w1.weight"], w[f"{name}.w1.bias"], int8))
    return linear(h, w[f"{name}.w2.weight"], w[f"{name}.w2.bias"], int8)


def pre_ln_block(x: torch.Tensor, w: Weights, name: str, heads: int,
                 mask: Optional[torch.Tensor], act, eps: float, int8: bool
                 ) -> torch.Tensor:
    """The CLIP residual block: x + attn(LN(x)), then + mlp(LN(.))."""
    x = x + attention(layer_norm(x, w, f"{name}.ln1", eps), w,
                      f"{name}.attn", heads, mask, int8)
    return x + mlp(layer_norm(x, w, f"{name}.ln2", eps), w, f"{name}.mlp",
                   act, int8)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
