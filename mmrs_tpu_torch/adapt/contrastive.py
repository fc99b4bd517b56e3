"""CLIP contrastive training step on one device.

Counterpart of mmrs_tpu/adapt/contrastive.py. The reference never trains
the towers (only the Tip-Adapter head, code/main_custom.py:148-247); the
JAX package adds full-tower contrastive fine-tuning so that galleries can
be domain-adapted. Its step is DP x TP over a mesh (`clip_param_specs`);
here it runs on one device, and `mesh=` raises until ROADMAP A.12.

What it keeps of the JAX step:
  - the loss: symmetric InfoNCE over exp(logit_scale) * img . txt^T in
    f32, the towers in `compute_dtype` with f32 master parameters (each
    layer casts its weights as the JAX layers do);
  - the attention route: the JAX loss runs its towers on XLA attention
    (mmrs_tpu/models/layers.py's default `attn_impl="xla"`), never on a
    Pallas kernel, so the vision tower runs `attn_impl="torch"` (and
    `mlp_impl="torch"`) and the text tower its plain masked attention.
    The kernels record no autograd history and refuse grad-requiring
    inputs (ops/_cuda.refuse_grad);
  - the optimizer: AdamW with no schedule, weight decay on every
    parameter (optax's `adamw` without a mask);
  - `remat=True`: activation checkpointing of the loss
    (torch.utils.checkpoint in place of jax.checkpoint).
The towers' serving entry points (`clip.encode_image` / `encode_text`) run
under inference mode, whose tensors cannot be saved for backward; the loss
calls the modules directly.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from mmrs_tpu_torch.models.clip import CLIP
from mmrs_tpu_torch.ops.normalize import l2_normalize


def contrastive_loss(model: CLIP, images: torch.Tensor, tokens: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16
                     ) -> torch.Tensor:
    """images [B, H, W, 3] CLIP-normalized, tokens [B, T] -> scalar f32."""
    img = l2_normalize(model.visual(images, compute_dtype, attn_impl="torch",
                                    mlp_impl="torch"))
    txt = l2_normalize(model.text(tokens, compute_dtype))
    logits = torch.exp(model.logit_scale) * (img.float() @ txt.float().T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = F.cross_entropy(logits, labels)
    lt = F.cross_entropy(logits.T, labels)
    return 0.5 * (li + lt)


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
    here)."""
    if mesh is not None:
        raise NotImplementedError(
            "the DP x TP train step over a mesh is ported with ROADMAP A.12")
    params = list(model.parameters())
    bad = [n for n, p in model.named_parameters()
           if p.dtype != torch.float32 or not p.requires_grad]
    if bad:
        raise ValueError(
            f"make_train_step needs f32 parameters that require grad; "
            f"{len(bad)} are not (first: {bad[0]})")
    opt = torch.optim.AdamW(params, lr=learning_rate,
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
