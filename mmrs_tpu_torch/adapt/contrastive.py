"""CLIP contrastive training step, on one device or DP x TP over a mesh.

Counterpart of mmrs_tpu/adapt/contrastive.py. The reference never trains
the towers (only the Tip-Adapter head, code/main_custom.py:148-247); the
JAX package adds full-tower contrastive fine-tuning so that galleries can
be domain-adapted.

What it keeps of the JAX step:
  - the loss: symmetric InfoNCE over exp(logit_scale) * img . txt^T in
    f32, the towers in `compute_dtype` with f32 master parameters (each
    layer casts its weights as the JAX layers do);
  - the attention route: the JAX loss runs its towers on XLA attention
    (mmrs_tpu/models/layers.py's default `attn_impl="xla"`), never on a
    Pallas kernel, so the vision tower runs `impl="torch"` (the plain
    ops) and the text tower its plain masked attention.
    The kernels record no autograd history and refuse grad-requiring
    inputs (ops/_cuda.refuse_grad);
  - the optimizer: AdamW with no schedule, weight decay on every
    parameter (optax's `adamw` without a mask);
  - `remat=True`: activation checkpointing of the loss
    (torch.utils.checkpoint in place of jax.checkpoint);
  - the mesh layout (`clip_param_specs`): each block's wq / wk / wv and
    w1 (with their biases) column-parallel over the model axis, wo and w2
    row-parallel, everything else replicated; the batch split over the
    data axis, the loss over the whole batch. One process drives every
    position: each data row runs its rows through the towers' own
    forwards with each block's pieces (layers.BlockPiece) on the row's
    devices (layers.Block.forward: the row-parallel products' f32 partial
    sums added on the row's first device, as parallel/vlm.py's decoder),
    the embeddings meet on the mesh's first device, and autograd carries
    the gradients back through the copies (torch.func.functional_call
    over each row's copies of the masters), summing them over the data
    rows, to one master copy of each piece (on data row 0's devices).
    AdamW steps the pieces, and `model` is given the gathered parameters
    after every step.
The towers' serving entry points (`clip.encode_image` / `encode_text`) run
under inference mode, whose tensors cannot be saved for backward; the loss
calls the modules directly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmrs_tpu_torch.models.clip import CLIP
from mmrs_tpu_torch.models.layers import Block, BlockPiece
from mmrs_tpu_torch.ops.normalize import l2_normalize

# a block's parameters split over the model axis: the dim of each (0 the
# out features of a column-parallel layer and its bias, 1 the in features
# of a row-parallel one); every other parameter is replicated. These are
# exactly the parameters of a layers.BlockPiece.
_BLOCK_SPECS = {
    "attn.wq.weight": 0, "attn.wq.bias": 0,
    "attn.wk.weight": 0, "attn.wk.bias": 0,
    "attn.wv.weight": 0, "attn.wv.bias": 0,
    "attn.wo.weight": 1,
    "mlp.w1.weight": 0, "mlp.w1.bias": 0,
    "mlp.w2.weight": 1,
}
_TOWERS = ("visual", "text")


def clip_param_specs(model: CLIP) -> Dict[str, Optional[int]]:
    """Parameter name -> the dim split over the model axis, or None where
    the parameter is replicated (mmrs_tpu clip_param_specs in the port's
    [out, in] layout)."""
    specs = {}
    for name, _ in model.named_parameters():
        tail = name.split(".blocks.", 1)[-1].split(".", 1)[-1]
        specs[name] = (_BLOCK_SPECS.get(tail) if ".blocks." in name
                       else None)
    return specs


def _info_nce(img: torch.Tensor, txt: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    logits = torch.exp(logit_scale) * (img.float() @ txt.float().T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = F.cross_entropy(logits, labels)
    lt = F.cross_entropy(logits.T, labels)
    return 0.5 * (li + lt)


def _embed(model: CLIP, images: torch.Tensor, tokens: torch.Tensor,
           compute_dtype: torch.dtype, pieces=None, devices=None):
    """L2-normalized (image, text) embeddings. With `pieces` ({tower:
    [each block's BlockPieces, one a model position on `devices`]}) the
    towers run tensor-parallel (layers.Block.forward)."""
    img = model.visual(images, compute_dtype, impl="torch",
                       pieces=None if pieces is None else pieces["visual"],
                       devices=devices)
    txt = model.text(tokens, compute_dtype,
                     pieces=None if pieces is None else pieces["text"],
                     devices=devices)
    return l2_normalize(img), l2_normalize(txt)


def contrastive_loss(model: CLIP, images: torch.Tensor, tokens: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """images [B, H, W, 3] CLIP-normalized, tokens [B, T] -> scalar f32."""
    img, txt = _embed(model, images, tokens, compute_dtype)
    return _info_nce(img, txt, model.logit_scale)


def make_train_step(
    model: CLIP,
    mesh=None,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.01,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
) -> Tuple[Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           torch.optim.Optimizer]:
    """Returns (train_step, optimizer). `train_step(images, tokens)` takes
    one AdamW step on `model` in place and returns the step's loss (a
    detached f32 scalar on the model's device).

    `model` holds f32 master parameters that require grad (a CLIP from
    `CLIP(cfg, generator)` or `convert_jax.from_jax_params`; the serving
    towers of `pipeline.build_towers` are frozen and cast, and are refused
    here). With `mesh` (a parallel/mesh.Mesh whose first device holds
    `model`) the step is DP x TP as the module docstring says: the batch
    must divide the data axis, the heads and MLP widths the model axis;
    the optimizer steps the split parameters' pieces, and `model` holds
    the gathered parameters after each step."""
    bad = [n for n, p in model.named_parameters()
           if p.dtype != torch.float32 or not p.requires_grad]
    if bad:
        raise ValueError(
            f"make_train_step needs f32 parameters that require grad; "
            f"{len(bad)} are not (first: {bad[0]})")
    if mesh is not None:
        return _mesh_train_step(model, mesh, learning_rate, weight_decay,
                                compute_dtype, remat)
    opt = torch.optim.AdamW(list(model.parameters()), lr=learning_rate,
                            weight_decay=weight_decay)

    def loss_of(images, tokens):
        if remat:
            from torch.utils.checkpoint import checkpoint

            return checkpoint(contrastive_loss, model, images, tokens,
                              compute_dtype, use_reentrant=False)
        return contrastive_loss(model, images, tokens, compute_dtype)

    def train_step(images: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
        with torch.enable_grad():
            loss = loss_of(images, tokens)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        opt.step()
        return loss.detach()

    return train_step, opt


def _piece(blk: Block, tp: int, p: int, dev: torch.device) -> BlockPiece:
    """Model position p's BlockPiece of `blk` on `dev`: copies of the split
    parameters' slices, on the dims of _BLOCK_SPECS."""
    piece = blk.piece(tp).to_empty(device=dev)
    with torch.no_grad():
        for name, t in piece.named_parameters():
            dim = _BLOCK_SPECS[name]
            n = t.shape[dim]
            t.copy_(blk.get_parameter(name).narrow(dim, p * n, n))
    return piece


class _MeshTowers(nn.Module):
    """The DP x TP step's master parameters: `model`'s replicated ones and
    data row 0's block pieces (`pieces[tower][i][p]` on the row's position
    p). forward embeds one data row's batch rows on its `devices`."""

    def __init__(self, model: CLIP, pieces: Dict[str, List[List[BlockPiece]]]):
        super().__init__()
        self.model = model
        self.pieces = nn.ModuleDict({
            tower: nn.ModuleList(nn.ModuleList(ps) for ps in blocks)
            for tower, blocks in pieces.items()})

    def forward(self, images, tokens, devices, compute_dtype):
        return _embed(self.model, images, tokens, compute_dtype,
                      self.pieces, devices)


def _mesh_train_step(model: CLIP, mesh, learning_rate: float,
                     weight_decay: float, compute_dtype: torch.dtype,
                     remat: bool):
    from torch.func import functional_call

    from mmrs_tpu_torch.parallel.mesh import (data_size, model_size,
                                              row_devices)

    data, tp = data_size(mesh), model_size(mesh)
    rows = [row_devices(mesh, d) for d in range(data)]
    for tower in (model.visual, model.text):
        w, heads = tower.cfg.width, tower.cfg.heads
        if heads % tp or (4 * w) % tp:
            raise ValueError(f"a model axis of {tp} does not divide the "
                             f"{heads} heads / {4 * w} MLP units of a tower")
    towers = _MeshTowers(model, {
        tower: [[_piece(blk, tp, p, dev) for p, dev in enumerate(rows[0])]
                for blk in getattr(model, tower).blocks]
        for tower in _TOWERS})
    specs = clip_param_specs(model)
    # the masters: the pieces and model's replicated parameters (model's
    # split ones are only written back, after each step)
    masters = {n: t for n, t in towers.named_parameters()
               if n.startswith("pieces.") or specs[n[len("model."):]] is None}
    opt = torch.optim.AdamW(list(masters.values()), lr=learning_rate,
                            weight_decay=weight_decay)
    home = rows[0][0]

    def on_row(d: int) -> Dict[str, torch.Tensor]:
        """The masters on data row d's devices (differentiable copies; row
        0's are the masters): a piece on its position, the rest on the
        row's first device."""
        return {n: t.to(rows[d][int(n.split(".")[3])
                                if n.startswith("pieces.") else 0])
                for n, t in masters.items()}

    def loss_of(images, tokens):
        b = images.shape[0]
        if b % data:
            raise ValueError(f"a batch of {b} does not split over the "
                             f"mesh's data axis of {data}")
        per = b // data
        img, txt = [], []
        for d, devs in enumerate(rows):
            args = (towers, on_row(d),
                    (images[d * per:(d + 1) * per].to(devs[0]),
                     tokens[d * per:(d + 1) * per].to(devs[0]), devs,
                     compute_dtype))
            if remat:
                from torch.utils.checkpoint import checkpoint

                i, t = checkpoint(functional_call, *args, use_reentrant=False)
            else:
                i, t = functional_call(*args)
            img.append(i.to(home))
            txt.append(t.to(home))
        return _info_nce(torch.cat(img), torch.cat(txt),
                         model.logit_scale.to(home))

    def train_step(images: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
        with torch.enable_grad():
            loss = loss_of(images, tokens)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        opt.step()
        with torch.no_grad():
            for tower in _TOWERS:
                for blk, ps in zip(getattr(model, tower).blocks,
                                   towers.pieces[tower]):
                    for name, dim in _BLOCK_SPECS.items():
                        dst = blk.get_parameter(name)
                        dst.copy_(torch.cat([pc.get_parameter(name).to(
                            dst.device) for pc in ps], dim))
        return loss.detach()

    return train_step, opt
