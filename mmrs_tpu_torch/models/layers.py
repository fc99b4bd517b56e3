"""Shared transformer building blocks for the CLIP towers and LLaMA.

Counterpart of mmrs_tpu/models/layers.py, restricted to what the CLIP
towers and the LLaMA decoder (`matmul`) use. Numerics follow the JAX
package:
  - matmuls take the compute dtype (bf16 by default); the products are
    summed in f32, the f32 bias is added to the f32 sums and the result
    is rounded once to the compute dtype (on the card, with an MLP's
    activation, in one epilogue kernel: ops/dense_epilogue.py);
  - int8 layers (`QLinear`, the int8 serving tower) quantize their input
    per row (round half to even), multiply int8 by int8 into exact int32
    sums, and rescale and add the bias in f32 before the one rounding;
  - LayerNorm runs in f32 regardless of the compute dtype (on the card,
    bf16 rows in one kernel: ops/layer_norm.py);
  - unmasked (vision) attention is the fused short-sequence MHA
    (ops/attention.py: the CUDA kernel on a GPU), with f32 softmax;
  - masked (text) attention is plain PyTorch with the softmax in the
    compute dtype, as the JAX package's XLA form;
  - the int8 MLP is the fused int8 MLP (ops/mlp_int8.py: the CUDA kernel
    on a GPU), with f32 hidden activations;
  - int4 layers (`QLinear4`, the int4-weight LLaMA) are unpacked to the
    compute dtype and multiplied as float weights (f32 sums);
  - a tensor-parallel decoder's or block's row-parallel products
    (`row_parallel`) add f32 partial sums; int8 pieces share one global
    activation scale and add exact int32 sums, equal to the one-device
    int8 product.
Every kernel a tower launches (K2, K6, E1 and E2) follows one `impl`:
"auto" (the kernels on the card) or "torch" (the plain ops anywhere).

Weights live in `nn.Linear` modules ([out, in] layout; matmul weights in
the compute dtype, biases f32), `QLinear` or `QLinear4` modules; the
layer stack is a plain list of per-layer modules (the JAX package stacks
layers for `lax.scan`; models/convert_jax.py splits that stack).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.ops._cuda import records_grad
from mmrs_tpu_torch.ops.attention import mha_short_seq, pool_attention
from mmrs_tpu_torch.ops.dense_epilogue import (ACTIVATIONS, act_name,
                                               bias_act, gelu, quick_gelu)
from mmrs_tpu_torch.ops.int8 import INV_127, int8_linear, int_mm, quantize_act
from mmrs_tpu_torch.ops.layer_norm import layer_norm
from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused


class LayerNorm(nn.Module):
    """LayerNorm computed in f32; output in the input's dtype. `impl`
    ("auto": one E2 launch for bf16 rows on the card outside autograd;
    "torch": the plain ops) goes to ops/layer_norm.layer_norm."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, impl=impl)


class QLinear(nn.Module):
    """int8 linear layer (mmrs_tpu layers.QTensor): per-output-channel
    symmetric int8 weights, w ~= q * s, and an f32 bias. Buffers: q int8
    [out, in], s f32 [out], bias f32 [out] or None."""

    def __init__(self, out_features: int, in_features: int,
                 bias: bool = True):
        super().__init__()
        self.register_buffer(
            "q", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("s", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias
                             else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QLinear":
        """Quantize a float layer as mmrs_tpu layers.quantize_weight does:
        s = max(|w|, 1e-12) / 127 over each output channel's inputs, codes
        round(w / s) half to even (no clip: |w / s| <= 127). The JAX
        package runs this op by op, outside `jit`, so its / 127 is a true
        division (under `jit` XLA makes it a product: ops/int8.INV_127)."""
        w32 = lin.weight.detach().float()
        with torch.device(w32.device):
            layer = cls(*w32.shape, bias=lin.bias is not None)
        layer.q, layer.s = int8_weight(w32, 1)
        if lin.bias is not None:
            layer.bias = lin.bias.detach().float()
        return layer


class QLinear4(nn.Module):
    """int4 linear layer (mmrs_tpu layers.QTensor4): symmetric int4 codes
    (-7..7) with one f32 scale per (group of K inputs, output channel),
    w ~= code * s[group]. Buffers: packed int8 [out, in / 2], inputs 2i
    and 2i + 1 of a row in the low and high nibble of byte i (the JAX
    [K / 2, N] bytes, transposed); s f32 [in / group, out], the JAX
    layout. Bias-free (the LLaMA stack's projections)."""

    def __init__(self, out_features: int, in_features: int,
                 groups: int = 1):
        super().__init__()
        self.register_buffer("packed", torch.zeros(
            (out_features, in_features // 2), dtype=torch.int8))
        self.register_buffer("s", torch.ones((groups, out_features)))

    @classmethod
    def from_linear(cls, lin: nn.Linear, group: int = 128) -> "QLinear4":
        """Quantize a float layer as mmrs_tpu quantize_weight_int4 does."""
        packed, s = quantize_weight_int4(lin.weight.detach().T, group)
        with torch.device(packed.device):
            layer = cls(s.shape[1], packed.shape[0] * 2, s.shape[0])
        layer.packed, layer.s = packed.T.contiguous(), s
        return layer

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        """The [out, in] weight in `dtype`, row-major as an `nn.Linear`'s:
        unpack_int4's values (code and scale each cast to `dtype`, one
        rounding of their product), unpacked along the rows' bytes."""
        w = _int4_codes(self.packed, 1)
        out, k = w.shape
        groups = self.s.shape[0]
        w = w.reshape(out, groups, k // groups).to(dtype) \
            * self.s.T[:, :, None].to(dtype)
        return w.reshape(out, k)


def _int4_codes(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """The int8 codes of packed nibbles, byte i's low nibble at 2i and its
    high nibble at 2i + 1 along `dim`. The low nibble sign-extends as
    ((b & 0xF) ^ 8) - 8, the high one by an arithmetic shift."""
    return torch.stack([((packed & 0xF) ^ 8) - 8, packed >> 4],
                       dim=dim + 1).flatten(dim, dim + 1)


def quantize_weight_int4(w: torch.Tensor, group: int = 128):
    """(packed int8 [K / 2, N], f32 scales [K / G, N]) of a [K, N] kernel,
    as mmrs_tpu layers.quantize_weight_int4 (run op by op: true
    divisions): s = max(max |w| over a group, 1e-12) / 7, codes
    clip(round(w / s), -7, 7) half to even, rows 2i / 2i + 1 in the low /
    high nibble of byte row i."""
    w32 = w.float()
    k, n = w32.shape
    if k % (2 * group) and k != group:
        raise ValueError(f"K={k} must be a multiple of 2*group={2 * group}")
    g = w32.reshape(k // group, group, n)
    s = _true_div(torch.clamp(g.abs().amax(1, keepdim=True), min=1e-12), 7.0)
    q = torch.clamp(torch.round(g / s), -7, 7).to(torch.int32).reshape(k, n)
    byte = ((q[1::2] & 0xF) << 4) | (q[0::2] & 0xF)
    return byte.to(torch.uint8).view(torch.int8), s.squeeze(1)


def unpack_int4(packed: torch.Tensor, s: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The dequantized [K, N] kernel in `dtype` from JAX-layout packed int8
    [K / 2, N] bytes and [K / G, N] scales: codes and scales each cast to
    `dtype` and multiplied there (one rounding), as mmrs_tpu unpack_int4."""
    w = _int4_codes(packed, 0)
    k, n = w.shape
    groups = s.shape[0]
    w = w.reshape(groups, k // groups, n).to(dtype) * s[:, None].to(dtype)
    return w.reshape(k, n)


def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as a true division on every device, as the JAX
    package's eager quantizers divide: CUDA divides a tensor by a Python
    scalar as a product with the scalar's reciprocal, which can differ in
    the last bit."""
    return x / torch.full_like(x, c)


def int8_weight(w32: torch.Tensor, dim: int):
    """(int8 codes, f32 scales) of f32 weights, one scale per channel over
    `dim` (the inputs): s = max(max|w|, 1e-12) / 127, q = round(w / s)
    half to even, as mmrs_tpu layers.quantize_weight."""
    s = _true_div(torch.clamp(w32.abs().amax(dim, keepdim=True), min=1e-12),
                  127.0)
    return torch.round(w32 / s).to(torch.int8), s.squeeze(dim)


def _mm_f32(x2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2d @ w.T as f32 sums of the compute-dtype operands' products (exact
    in f32). cuBLAS returns them directly for bf16 operands (`out_dtype`,
    CUDA only, no autograd formula); elsewhere, and in a training step,
    the operands are widened to f32 first."""
    if x2d.is_cuda and x2d.dtype != torch.float32 and not records_grad(
            x2d, w):
        return torch.mm(x2d, w.T, out_dtype=torch.float32)
    return x2d.float() @ w.float().T


def dense(x: torch.Tensor, layer, compute_dtype: torch.dtype,
          act: Optional[Callable] = None, impl: str = "auto"
          ) -> torch.Tensor:
    """act(x @ W^T + b) in the compute dtype: f32 sums plus the f32 bias,
    rounded once (mmrs_tpu layers.dense), then `act` (None, quick_gelu or
    gelu) on the rounded result. A `QLinear` quantizes x per row first, in
    x's own dtype (layers._dense_int8). A float layer's epilogue (bias,
    rounding, activation) goes to ops/dense_epilogue.bias_act with `impl`
    ("auto": one kernel launch on the card; "torch": the plain ops) for
    bf16 results in calls autograd does not record, else to the plain
    ops; both give the same bits."""
    if isinstance(layer, QLinear):
        xq, sx = quantize_act(x)
        y = int8_linear(xq, sx, layer.q, layer.s, layer.bias, compute_dtype)
        return y if act is None else act(y)
    x = x.to(compute_dtype)
    y = _mm_f32(x.reshape(-1, x.shape[-1]), layer.weight.to(compute_dtype))
    bias = None if layer.bias is None else layer.bias.float()
    if compute_dtype != torch.bfloat16 or records_grad(y, bias):
        impl = "torch"
    y = bias_act(y, bias, act_name(act), compute_dtype, impl=impl)
    return y.reshape(*x.shape[:-1], -1)


def matmul(x: torch.Tensor, layer, compute_dtype: torch.dtype,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bias-free x @ W^T returned in `out_dtype` (default: the compute
    dtype), as mmrs_tpu layers.matmul for the LLaMA stack: float weights
    give f32 sums of compute-dtype products; a `QLinear` quantizes x per
    row and rescales its exact int32 sums as acc * sx * s; a `QLinear4`
    is unpacked to the compute dtype and multiplied as a float weight."""
    out_dtype = out_dtype or compute_dtype
    if isinstance(layer, QLinear):
        xq, sx = quantize_act(x)
        return int8_linear(xq, sx, layer.q, layer.s, None, out_dtype)
    if isinstance(layer, QLinear4):
        # the JAX package's form: the kernel unpacked to the compute dtype
        # in device memory, then the float product (no fused kernel)
        w = layer.dequantize(compute_dtype)
    else:
        w = layer.weight.to(compute_dtype)
    x = x.to(compute_dtype)
    y = _mm_f32(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], -1).to(out_dtype)


def row_parallel(xs, layers, compute_dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The model axis's sum of the row-parallel products x_p @ W_p^T
    (x_p [..., K_p] on piece p's device, W_p the layer's [N, K_p] piece):
    f32 [..., N] on `device`, the pieces added there in position order.
    One piece is `matmul`'s f32 result. Float pieces (and `QLinear4`
    pieces, whole K-groups each) give f32 partial sums. `QLinear` pieces
    follow the one-device int8 rule, as GSPMD's partitioning of the JAX
    `_dense_int8` computes it: the input is quantized with the global row
    max (the largest of the pieces' row maxima), the pieces' exact int32
    sums are added, and acc * sx * s is taken once (the scales s are
    replicated), so the result equals the whole layer's bit for bit."""
    if len(xs) == 1:
        return matmul(xs[0], layers[0], compute_dtype, torch.float32)
    if isinstance(layers[0], QLinear):
        x32 = [x.float() for x in xs]
        amax = torch.stack([x.abs().amax(-1, keepdim=True).to(device)
                            for x in x32]).amax(0)
        sx = torch.clamp(amax, min=1e-12) * INV_127
        acc = None
        for x, layer in zip(x32, layers):
            xq = torch.round(x / sx.to(x.device)).to(torch.int8)
            part = int_mm(xq.reshape(-1, xq.shape[-1]), layer.q).to(device)
            acc = part if acc is None else acc + part
        acc = acc.reshape(*xs[0].shape[:-1], -1)
        return torch.mul(acc, sx) * layers[0].s.to(device)
    total = None
    for x, layer in zip(xs, layers):
        part = matmul(x, layer, compute_dtype, torch.float32).to(device)
        total = part if total is None else total + part
    return total


def project(x: torch.Tensor, layer: nn.Linear, compute_dtype: torch.dtype
            ) -> torch.Tensor:
    """Final embedding projection: compute-dtype operands, f32 result (the
    JAX towers keep the projected features in f32), plus the layer's f32
    bias where it has one (SigLIP's text head)."""
    bias = None if layer.bias is None else layer.bias.float()
    return F.linear(x.to(compute_dtype).float(),
                    layer.weight.to(compute_dtype).float(), bias)


class Attention(nn.Module):
    """Multi-head self-attention. With `tp` > 1 it is one model position's
    piece (BlockPiece): heads / tp heads, the column pieces of wq / wk /
    wv with their biases and the bias-free row piece of wo (the model
    axis adds wo's bias once, Block.forward)."""

    def __init__(self, width: int, heads: int, tp: int = 1):
        super().__init__()
        self.heads = heads // tp
        part = width // tp
        self.wq = nn.Linear(width, part)
        self.wk = nn.Linear(width, part)
        self.wv = nn.Linear(width, part)
        self.wo = nn.Linear(part, width, bias=tp == 1)

    def heads_out(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                  compute_dtype: torch.dtype, impl: str = "auto"
                  ) -> torch.Tensor:
        """The attention of the layer's heads, [B, T, heads * hd] in the
        compute dtype: the input of wo."""
        b, t, _ = x.shape
        cd = compute_dtype
        if isinstance(self.wq, QLinear):
            # the int8 tower quantizes the layer input once for all three
            xq, sx = quantize_act(x)
            q, k, v = (int8_linear(xq, sx, p.q, p.s, p.bias, cd)
                       for p in (self.wq, self.wk, self.wv))
        else:
            q, k, v = (dense(x, p, cd, impl=impl)
                       for p in (self.wq, self.wk, self.wv))
        hd = q.shape[-1] // self.heads
        # 1/sqrt(hd) folded into q, rounded to the compute dtype first (a
        # host scalar: no device tensor is made per call)
        scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=cd))
        q = q * scale
        if mask is None:
            return mha_short_seq(q, k, v, self.heads, impl=impl)

        def split(y):                              # [B, H, T, hd]
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        logits = split(q).float() @ split(k).float().transpose(-1, -2)
        probs = torch.softmax((logits + mask).to(cd), dim=-1)
        out = (probs.float() @ split(v).float()).to(cd)
        return out.transpose(1, 2).reshape(b, t, -1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                compute_dtype: torch.dtype, impl: str = "auto"
                ) -> torch.Tensor:
        return dense(self.heads_out(x, mask, compute_dtype, impl),
                     self.wo, compute_dtype, impl=impl)


class MLP(nn.Module):
    """Two-layer MLP. With `tp` > 1 it is one model position's piece
    (BlockPiece): hidden / tp units, the column piece of w1 with its bias
    and the bias-free row piece of w2."""

    def __init__(self, width: int, hidden: int, act: Callable, tp: int = 1):
        super().__init__()
        self.w1 = nn.Linear(width, hidden // tp)
        self.w2 = nn.Linear(hidden // tp, width, bias=tp == 1)
        self.act = act

    def inner(self, x: torch.Tensor, compute_dtype: torch.dtype,
              impl: str = "auto") -> torch.Tensor:
        """act(x @ w1^T + b1) in the compute dtype: the input of w2."""
        return dense(x, self.w1, compute_dtype, act=self.act, impl=impl)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                impl: str = "auto") -> torch.Tensor:
        if isinstance(self.w1, QLinear):
            w1, w2 = self.w1, self.w2
            y = mlp_int8_fused(
                x.reshape(-1, x.shape[-1]).to(compute_dtype), w1.q, w1.s,
                w1.bias, w2.q, w2.s, w2.bias,
                act=act_name(self.act), impl=impl)
            return y.reshape(x.shape)
        return dense(self.inner(x, compute_dtype, impl), self.w2,
                     compute_dtype, impl=impl)


class BlockPiece(nn.Module):
    """One model position's piece of a tensor-parallel Block: heads / tp
    heads and hidden / tp MLP units (the pieces' parameters are exactly
    the Block's split ones, under the same names). The LayerNorms and the
    biases of wo and w2 stay the Block's."""

    def __init__(self, width: int, heads: int, hidden: int, act: Callable,
                 tp: int):
        super().__init__()
        self.attn = Attention(width, heads, tp)
        self.mlp = MLP(width, hidden, act, tp)


def _row_dense(xs, layers, bias: Optional[torch.Tensor],
               compute_dtype: torch.dtype, device: torch.device,
               impl: str = "auto") -> torch.Tensor:
    """sum_p x_p @ W_p^T + b over the model axis, rounded once to the
    compute dtype on `device`: `dense` for one piece (the one-device
    arithmetic, its epilogue by `impl`), else row_parallel's f32 sum plus
    the f32 bias."""
    if len(xs) == 1:
        return dense(xs[0], layers[0], compute_dtype, impl=impl)
    y = row_parallel(xs, layers, compute_dtype, device)
    return (y if bias is None else y + bias.float()).to(compute_dtype)


class Block(nn.Module):
    """CLIP-style pre-LayerNorm residual block. `hidden` is the MLP's width
    (default mlp_ratio x width; SigLIP's 4304), `eps` the LayerNorms'."""

    def __init__(self, width: int, heads: int, act: Callable,
                 mlp_ratio: int = 4, hidden: Optional[int] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.ln1 = LayerNorm(width, eps)
        self.attn = Attention(width, heads)
        self.ln2 = LayerNorm(width, eps)
        self.mlp = MLP(width, hidden or width * mlp_ratio, act)

    def piece(self, tp: int) -> BlockPiece:
        """An empty (meta-device) piece of this block for a model axis of
        tp positions."""
        with torch.device("meta"):
            return BlockPiece(self.ln1.weight.shape[0], self.attn.heads,
                              self.mlp.w1.out_features, self.mlp.act, tp)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                compute_dtype: torch.dtype, impl: str = "auto",
                pieces=None, devices=None) -> torch.Tensor:
        """The block on x's device, or tensor-parallel with `pieces` (one
        BlockPiece a model position, pieces[p] on devices[p]): each piece
        takes the LayerNorm's output and computes its heads and MLP units,
        and the two row-parallel products are summed over the pieces in
        f32 on x's device (row_parallel) with this block's bias before the
        one rounding. Without pieces the block is its own one piece: the
        one-device arithmetic."""
        cd = compute_dtype
        parts = [self] if pieces is None else list(pieces)
        devs = [x.device] if pieces is None else list(devices)
        h = self.ln1(x, impl)
        outs = [p.attn.heads_out(h.to(d), None if mask is None
                                 else mask.to(d), cd, impl)
                for p, d in zip(parts, devs)]
        x = x + _row_dense(outs, [p.attn.wo for p in parts],
                           self.attn.wo.bias, cd, x.device, impl)
        h = self.ln2(x, impl)
        if isinstance(self.mlp.w1, QLinear):     # the fused int8 MLP (K6)
            return x + self.mlp(h, cd, impl)
        inner = [p.mlp.inner(h.to(d), cd, impl) for p, d in zip(parts, devs)]
        return x + _row_dense(inner, [p.mlp.w2 for p in parts],
                              self.mlp.w2.bias, cd, x.device, impl)


class MapHead(nn.Module):
    """Multihead attention pooling (SigLIP's `SiglipMultiheadAttention
    PoolingHead`): a learned probe [1, 1, W] attends over the tokens
    (`nn.MultiheadAttention`'s in-projection as wq / wk / wv, its
    out-projection as wo, through `dense`), then h + MLP(LayerNorm(h)).
    Returns the pooled [B, W] in the compute dtype."""

    def __init__(self, width: int, heads: int, hidden: int, act: Callable,
                 eps: float = 1e-5):
        super().__init__()
        self.probe = nn.Parameter(torch.zeros(1, 1, width))
        self.attn = Attention(width, heads)
        self.ln = LayerNorm(width, eps)
        self.mlp = MLP(width, hidden, act)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype,
                impl: str = "auto") -> torch.Tensor:
        cd, a = compute_dtype, self.attn
        # the probe's query is the same for every image: one row
        q = dense(self.probe, a.wq, cd, impl=impl)
        k, v = (dense(x, p, cd, impl=impl) for p in (a.wk, a.wv))
        scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1] // a.heads),
                                   dtype=cd))
        out = pool_attention((q * scale).expand(x.shape[0], -1, -1), k, v,
                             a.heads)
        h = dense(out, a.wo, cd, impl=impl)
        return (h + self.mlp(self.ln(h, impl), cd, impl))[:, 0]


def init_blocks(blocks: nn.ModuleList, generator: torch.Generator) -> None:
    """Random init matching mmrs_tpu's init_block_params distributions:
    N(0, 0.02) weights, zero biases, unit LayerNorm scales."""
    for blk in blocks:
        for lin in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                    blk.mlp.w1, blk.mlp.w2):
            nn.init.normal_(lin.weight, std=0.02, generator=generator)
            nn.init.zeros_(lin.bias)
