"""Tensor-parallel hosting of the VLM verifier's decoder: the mesh's model
axis.

Counterpart of mmrs_tpu/parallel/vlm.py. The Megatron layout over the
`model` axis of a (data, model) `Mesh` (parallel/mesh.py), in the port's
[out, in] `nn.Linear` weights:

  wq / wk / wv / w_gate / w_up   split on out (dim 0)   column-parallel
  wo / w_down                    split on in (dim 1)    row-parallel
  lm_head                        split on out (vocab)   vocab-parallel
  embedding / norms              replicated

Heads, kv heads, mlp_dim and the vocabulary must divide the model axis
(`draft_tp_divisible`). The JAX package hands the layout to GSPMD, which
inserts the all-reduces; here one process drives each data row's model
positions in a loop (models/llama.py: the residual stream on the row's
first device, each shard's heads and gated units on its own, the two
row-parallel products a block summed there in f32, layers.row_parallel),
so the model axis never crosses a process and needs no NCCL group: the
partial sums move by device-to-device copies, which are no-ops where the
mesh repeats a card. A data axis wider than 1 splits the batch rows, each
data row running its own TP group (the batch-DP x decoder-TP shape); the
tokens come back on the mesh's first device, gathered over the process
group when the data rows cross processes (parallel/multihost.py).

The vision tower and the projector are replicated in JAX, every chip
computing the same values; here they run once a data row, on its first
model position, and a replicated draft (`replicate_llama_params`) is held
and run there too: a copy on the row's other positions would compute
nothing that is read.

Attention on a CUDA tensor: each shard's K10 (prefill chunks) and K11
(decode steps) are ordinary one-device launches over its KVH / tp heads,
so the port's kernel rule holds under a mesh (the kernel, or an error).
The JAX package keeps a meshed verifier on XLA attention instead
(Pallas under GSPMD partitioning was never run there). A shard sizes
K11's launch for the whole model's (row, kv head) pairs
(`decode_attention(plan_pairs=)`), so each pair reduces as on one device.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from mmrs_tpu_torch.models import checkpoint, convert_jax, llama, llava
from mmrs_tpu_torch.models.layers import QLinear, QLinear4, _true_div
from mmrs_tpu_torch.models.llama import (Llama, LlamaConfig, LlamaShard,
                                         TPLlama)
from mmrs_tpu_torch.models.llava import TPLLaVA
from mmrs_tpu_torch.models.vit import VisionTransformer
from mmrs_tpu_torch.parallel.mesh import (Mesh, data_devices, data_size,
                                          first_device, local_positions,
                                          model_size, row_devices)
from mmrs_tpu_torch.parallel.multihost import all_gather_processes


def llama_param_specs() -> Dict[str, Any]:
    """The dim of each decoder leaf's [out, in] weight that splits over
    the model axis (0 column- or vocab-parallel, 1 row-parallel), None
    where it is replicated; named as the port's module attributes."""
    return {
        "embed": None,
        "blocks": {
            "attn_norm": None,
            "wq": 0, "wk": 0, "wv": 0,
            "wo": 1,
            "mlp_norm": None,
            "w_gate": 0, "w_up": 0,
            "w_down": 1,
        },
        "final_norm": None,
        "lm_head": 0,
    }


def _scale_spec(dim: Optional[int]) -> Optional[int]:
    """The split of an int8 layer's per-output-channel scales [out]: they
    shed the weight's in axis, so they split with a column-parallel
    weight and are replicated beside a row-parallel one."""
    return 0 if dim == 0 else None


@dataclass
class MeshModel:
    """A model placed on a mesh: `rows[d]` data row d's model (a
    llama.TPLlama, a llava.TPLLaVA, or a replicated copy on the row's
    first device), None where another process drives the row."""

    mesh: Mesh
    cfg: Any
    rows: List[Optional[nn.Module]]


def draft_tp_divisible(draft_cfg: LlamaConfig, mesh: Mesh) -> bool:
    """True iff the decoder's shapes admit the Megatron layout on `mesh`'s
    model axis (heads, kv heads, mlp_dim and vocabulary all divide it)."""
    tp = model_size(mesh)
    return (draft_cfg.heads % tp == 0 and draft_cfg.kv_heads % tp == 0
            and draft_cfg.mlp_dim % tp == 0
            and draft_cfg.vocab_size % tp == 0)


def _check_divisible(cfg: LlamaConfig, mesh: Mesh) -> None:
    if not draft_tp_divisible(cfg, mesh):
        raise ValueError(
            f"a model axis of {model_size(mesh)} does not divide the "
            f"decoder's heads/kv-heads/mlp/vocab ({cfg.heads}/"
            f"{cfg.kv_heads}/{cfg.mlp_dim}/{cfg.vocab_size})")


def _piece(t: torch.Tensor, dim: int, p: int, tp: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, p * n, n)


def _layer_piece(layer: nn.Module, dim: int, p: int, tp: int,
                 dev: torch.device) -> nn.Module:
    """Position p's piece of a linear layer split on `dim` of its [out,
    in] weight. Float pieces are views where the device stays (a 7B on a
    repeated card holds no second copy); int8 row pieces are made whole
    rows (the int8 product takes contiguous operands); int4 row pieces
    take whole K-groups."""
    with torch.device("meta"):
        if isinstance(layer, QLinear):
            out = QLinear(1, 1, bias=False)
        elif isinstance(layer, QLinear4):
            out = QLinear4(1, 2)
        else:
            out = nn.Linear(1, 1, bias=False)
    if isinstance(layer, QLinear):
        q = _piece(layer.q, dim, p, tp).to(dev)
        out.q = q if dim == 0 else q.contiguous()
        out.s = (layer.s if _scale_spec(dim) is None
                 else _piece(layer.s, 0, p, tp)).to(dev)
    elif isinstance(layer, QLinear4):
        groups = layer.s.shape[0]
        if dim == 1 and groups % tp:
            raise ValueError(f"a model axis of {tp} does not divide the "
                             f"{groups} K-groups of an int4 row-parallel "
                             f"layer")
        out.packed = _piece(layer.packed, dim, p, tp).to(dev)
        out.s = _piece(layer.s, 1 - dim, p, tp).to(dev)
    else:
        w = _piece(layer.weight.detach(), dim, p, tp).to(dev)
        out.weight = nn.Parameter(w, requires_grad=False)
        out.out_features, out.in_features = w.shape
    return out


def _tp_llama(model: Llama, devs: List[torch.device]) -> TPLlama:
    """A TPLlama over `devs` (one data row's model positions) from a
    one-device Llama."""
    cfg, tp = model.cfg, len(devs)
    specs = llama_param_specs()["blocks"]
    shards = []
    for p, dev in enumerate(devs):
        with torch.device("meta"):
            shard = LlamaShard(cfg, tp)
        for blk, piece in zip(model.blocks, shard.blocks):
            for name, dim in specs.items():
                src = getattr(blk, name)
                setattr(piece, name,
                        nn.Parameter(src.detach().to(dev), requires_grad=False)
                        if dim is None
                        else _layer_piece(src, dim, p, tp, dev))
        shard.lm_head = _layer_piece(model.lm_head, 0, p, tp, dev)
        shards.append(shard)
    return TPLlama(cfg, model.embed.detach().to(devs[0]),
                   model.final_norm.detach().to(devs[0]), shards, devs)


def _copy_to(module: nn.Module, dev: torch.device) -> nn.Module:
    """`module` itself when it lies on `dev`, else a copy there (the
    original stays where it is)."""
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    if all(t.device == torch.device(dev) for t in tensors):
        return module
    memo: Dict[int, Any] = {}
    for t in tensors:
        moved = t.detach().to(dev)
        memo[id(t)] = (nn.Parameter(moved, requires_grad=t.requires_grad)
                       if isinstance(t, nn.Parameter) else moved)
    return copy.deepcopy(module, memo)


def _placed_rows(mesh: Mesh, row_fn: Callable[[List[torch.device]], Any]
                 ) -> List[Optional[nn.Module]]:
    rows: List[Optional[nn.Module]] = [None] * data_size(mesh)
    for d in local_positions(mesh):
        rows[d] = row_fn(row_devices(mesh, d))
    return rows


def shard_llama_params(model: Llama, mesh: Mesh) -> MeshModel:
    """The decoder Megatron-sharded over the model axis of every data row
    this process drives (int8 `QLinear` and int4 `QLinear4` layers
    included: their scales follow `_scale_spec`)."""
    _check_divisible(model.cfg, mesh)
    return MeshModel(mesh, model.cfg,
                     _placed_rows(mesh, lambda devs: _tp_llama(model, devs)))


def replicate_llama_params(model: nn.Module, mesh: Mesh) -> MeshModel:
    """The whole model (a Llama, or a LLaVA draft VLM) on each data row's
    first device: the draft's layout when its shapes do not divide the
    model axis. It runs there with no cross-device traffic."""
    return MeshModel(mesh, model.cfg,
                     _placed_rows(mesh, lambda devs: _copy_to(model,
                                                              devs[0])))


def shard_llava_params(model: llava.LLaVA, mesh: Mesh) -> MeshModel:
    """A LLaVA on `mesh`: the tower and projector on each data row's first
    device, the decoder Megatron-sharded over the row (shard_llama_params)."""
    _check_divisible(model.cfg.lm, mesh)

    def row(devs):
        return TPLLaVA(model.cfg, _copy_to(model.visual, devs[0]),
                       _copy_to(model.proj1, devs[0]),
                       _copy_to(model.proj2, devs[0]),
                       _tp_llama(model.lm, devs))

    return MeshModel(mesh, model.cfg, _placed_rows(mesh, row))


# -- placing a checkpoint as it is read ------------------------------------

class Placed(NamedTuple):
    """A checkpoint leaf (JAX layout) placed on a mesh: pieces[d][p] data
    row d's piece at model position p (None where nothing is placed)."""

    pieces: List[Optional[List[Optional[torch.Tensor]]]]


def _placer(mesh: Mesh, dim: Optional[int], kernel: bool, everywhere: bool
            ) -> Callable[[torch.Tensor], Placed]:
    """Places a host tensor: split on `dim` over each data row's model
    positions, or whole (on every position when `everywhere`, else on the
    row's first). A split kernel's pieces are stored as their transpose,
    the port's [out, in] layout, and given back as JAX-layout views of it,
    so the modules built from them copy nothing. One copy a distinct
    (device, piece)."""
    tp = model_size(mesh)

    def put(t: torch.Tensor) -> Placed:
        copies: Dict[Any, torch.Tensor] = {}
        grid: List[Optional[List[Optional[torch.Tensor]]]] = \
            [None] * data_size(mesh)
        for d in local_positions(mesh):
            row: List[Optional[torch.Tensor]] = []
            for p, dev in enumerate(row_devices(mesh, d)):
                if dim is None and p and not everywhere:
                    row.append(None)
                    continue
                key = (dev, None if dim is None else p)
                if key not in copies:
                    x = t if dim is None else _piece(t, dim, p, tp)
                    x = x.to(dev)
                    if kernel and dim is not None:
                        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
                    copies[key] = x
                row.append(copies[key])
            grid[d] = row
        return Placed(grid)

    return put


def llava_checkpoint_placement(mesh: Mesh):
    """`checkpoint.load_npz` placement for the TP LLaVA layout: flat key
    (e.g. "lm/blocks/wq", "lm/blocks/wq@int8q", "visual/blocks/w1") ->
    a function that places the host array. The decoder is split per
    `llama_param_specs` (JAX [..., K, N] kernels: column pieces on N,
    row pieces on K; int8 scales per `_scale_spec`), its replicated
    leaves go to every position, and the tower and projector to each
    data row's first. Loading a 7B straight into its placement keeps one
    array at a time on the host. `llava_from_placed` builds the model."""
    specs = llama_param_specs()

    def place(key: str):
        if not key.startswith("lm/"):
            return _placer(mesh, None, False, everywhere=False)
        node: Any = specs
        for part in key[3:].split("/"):
            node = node.get(part.split("@")[0]) if isinstance(node, dict) \
                else None
        if not isinstance(node, int):
            return _placer(mesh, None, False, everywhere=True)
        if key.endswith("@int8s"):
            dim = _scale_spec(node)
            return _placer(mesh, None if dim is None else -1, False,
                           everywhere=True)
        return _placer(mesh, -1 if node == 0 else -2, True, everywhere=True)

    return place


def _pick(tree: Any, d: int, p: int) -> Any:
    """The JAX-layout tree of data row d's pieces at model position p."""
    if isinstance(tree, dict):
        return {k: _pick(v, d, p) for k, v in tree.items()}
    if isinstance(tree, checkpoint.QWeight):
        return checkpoint.QWeight(_pick(tree.q, d, p), _pick(tree.s, d, p))
    if isinstance(tree, Placed):
        return tree.pieces[d][p]
    return tree


def llava_from_placed(tree: Dict[str, Any], cfg: llava.LLaVAConfig,
                      mesh: Mesh) -> MeshModel:
    """The TP LLaVA of a `load_npz(path, placement=
    llava_checkpoint_placement(mesh))` tree: the same model as
    `shard_llava_params` of the one-device LLaVA of that checkpoint."""
    _check_divisible(cfg.lm, mesh)
    tp = model_size(mesh)
    rows: List[Optional[nn.Module]] = [None] * data_size(mesh)
    for d in local_positions(mesh):
        devs = row_devices(mesh, d)
        at = [_pick(tree, d, p) for p in range(tp)]
        shards = []
        for p, dev in enumerate(devs):
            sd: Dict[str, torch.Tensor] = {}
            convert_jax._llama_sd(at[p]["lm"], sd)
            del sd["embed"], sd["final_norm"]          # the group's
            with torch.device("meta"):
                shard = LlamaShard(cfg.lm, tp)
            shards.append(convert_jax._assign(shard, sd, dev))
        lm = TPLlama(cfg.lm, at[0]["lm"]["embed"], at[0]["lm"]["final_norm"],
                     shards, devs)
        sd = {}
        convert_jax._visual_sd(at[0]["visual"], sd)
        convert_jax._linear(sd, "proj1", at[0]["proj_w1"], at[0]["proj_b1"])
        convert_jax._linear(sd, "proj2", at[0]["proj_w2"], at[0]["proj_b2"])
        with torch.device("meta"):
            head = nn.Module()
            head.visual = VisionTransformer(cfg.vision)
            head.proj1 = nn.Linear(cfg.vision.width, cfg.lm.dim)
            head.proj2 = nn.Linear(cfg.lm.dim, cfg.lm.dim)
        head = convert_jax._assign(head, sd, devs[0])
        rows[d] = TPLLaVA(cfg, head.visual, head.proj1, head.proj2, lm)
    return MeshModel(mesh, cfg, rows)


def quantize_mesh_llava(model: MeshModel) -> MeshModel:
    """quantize.quantize_llava of a TP LLaVA, in place: each data row's
    tower, and every decoder piece with the codes and scales of the
    one-device quantization (a row-parallel piece's per-output-channel
    scale comes from the largest |w| over all the pieces of its layer).
    Layers already int8 stay as they are."""
    from mmrs_tpu_torch.models.quantize import quantize_tree

    specs = llama_param_specs()["blocks"]
    seen = set()
    for row in model.rows:
        if row is None:
            continue
        if id(row.visual) not in seen:
            seen.add(id(row.visual))
            quantize_tree(row.visual)
        lm = row.lm
        for li in range(lm.cfg.layers):
            blocks = [s.blocks[li] for s in lm.shards]
            for name, dim in specs.items():
                if dim is not None:
                    pieces = _quantized([getattr(b, name) for b in blocks],
                                        dim, lm.devices)
                    for b, q in zip(blocks, pieces):
                        setattr(b, name, q)
        for s, q in zip(lm.shards, _quantized(
                [s.lm_head for s in lm.shards], 0, lm.devices)):
            s.lm_head = q
    return model


def _quantized(layers: List[nn.Module], dim: int,
               devs: List[torch.device]) -> List[nn.Module]:
    """int8 pieces of one layer's float pieces (layers.int8_weight's
    codes and scales of the whole layer)."""
    if not isinstance(layers[0], nn.Linear):
        return layers
    if dim == 0:
        return [QLinear.from_linear(lyr) for lyr in layers]
    w32 = [lyr.weight.detach().float() for lyr in layers]
    amax = torch.stack([w.abs().amax(1).to(devs[0]) for w in w32]).amax(0)
    s = _true_div(torch.clamp(amax, min=1e-12), 127.0)
    out = []
    for w, dev in zip(w32, devs):
        with torch.device("meta"):
            q = QLinear(1, 1, bias=False)
        sd = s.to(dev)
        q.q, q.s = torch.round(w / sd[:, None]).to(torch.int8), sd
        out.append(q)
    return out


# -- generate over the mesh -------------------------------------------------

def _over_rows(mesh: Mesh, fn: Callable, models: List[MeshModel],
               inputs: List[torch.Tensor], stats: bool = False):
    """fn(row models..., row inputs...) on each data row this process
    drives, the batch split into contiguous row blocks over the data axis
    (the batch must divide it); the tokens concatenated in row order on
    the mesh's first device, every process's rows gathered. With `stats`,
    fn returns (tokens, speculative stats) and the rows' stats are merged
    as one batch's: the rounds of the longest row block, every row's
    emitted count."""
    data = data_size(mesh)
    b = inputs[0].shape[0]
    if b % data:
        raise ValueError(f"a batch of {b} does not split over the mesh's "
                         f"data axis of {data}")
    per = b // data
    devs = data_devices(mesh)
    home = first_device(mesh)
    toks, emitted, rounds = [], [], 0
    for d in local_positions(mesh):
        row_in = [x[d * per:(d + 1) * per].to(devs[d]) for x in inputs]
        out = fn(*[m.rows[d] for m in models], *row_in)
        if stats:
            out, st = out
            rounds = max(rounds, int(st["rounds"]))
            emitted.append(st["emitted"].to(home))
        toks.append(out.to(home))
    tokens = all_gather_processes(torch.cat(toks))
    if not stats:
        return tokens
    rounds = int(all_gather_processes(torch.tensor([rounds])).max())
    return tokens, {"rounds": rounds,
                    "emitted": all_gather_processes(torch.cat(emitted))}


def make_tp_generate(cfg: LlamaConfig, mesh: Mesh, max_new_tokens: int,
                     eos_token: int = 2,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     kv_dtype=None, prefill_chunk: Optional[int] = None,
                     decode_window: Optional[int] = None,
                     early_stop: bool = False, attn: str = "auto"):
    """`gen(params, prompt_embeds)`: llama.greedy_generate of a
    `shard_llama_params` model over `mesh` (the one-device decode options
    compose: they restructure only the loop over positions). With a data
    axis wider than 1 the prompt rows split over it; the batch must
    divide it. Tokens [B, max_new_tokens] int32 on the mesh's first
    device."""
    _check_divisible(cfg, mesh)

    def row(model, embeds):
        return llama.greedy_generate(
            model, embeds, max_new_tokens, eos_token, compute_dtype,
            kv_dtype=kv_dtype, prefill_chunk=prefill_chunk,
            decode_window=decode_window, early_stop=early_stop, attn=attn)

    return lambda params, prompt_embeds: _over_rows(mesh, row, [params],
                                                     [prompt_embeds])


def make_tp_llava_generate(cfg: llava.LLaVAConfig, mesh: Mesh,
                           max_new_tokens: int = 32, eos_token: int = 2,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           impl: str = "auto", kv_dtype=None,
                           prefill_chunk: Optional[int] = None,
                           decode_window: Optional[int] = None,
                           early_stop: bool = False, attn: str = "auto"):
    """`gen(params, images, pre_tokens, post_tokens)`: llava.generate of a
    `shard_llava_params` model over `mesh` (the tower once a data row, the
    decoder tensor-parallel)."""
    _check_divisible(cfg.lm, mesh)

    def row(model, images, pre, post):
        return llava.generate(
            model, images, pre, post, max_new_tokens, eos_token,
            compute_dtype, impl, kv_dtype=kv_dtype,
            prefill_chunk=prefill_chunk, decode_window=decode_window,
            early_stop=early_stop, attn=attn)

    return lambda params, images, pre, post: _over_rows(
        mesh, row, [params], [images, pre, post])


def make_tp_llava_speculative_generate(
        cfg: llava.LLaVAConfig, draft_cfg: llava.LLaVAConfig, mesh: Mesh,
        max_new_tokens: int = 32, draft_tokens: int = 4, eos_token: int = 2,
        compute_dtype: torch.dtype = torch.bfloat16, impl: str = "auto",
        kv_dtype=None, prefill_chunk: Optional[int] = None,
        attn: str = "auto", return_stats: bool = False):
    """`gen(params, draft_params, images, pre_tokens, post_tokens)`:
    llava.generate_speculative with the target decoder tensor-parallel and
    the draft VLM sharded or replicated, as its params were placed
    (shard_llava_params / replicate_llama_params). The tokens are those of
    make_tp_llava_generate of the target."""
    _check_divisible(cfg.lm, mesh)

    def row(model, draft, images, pre, post):
        return llava.generate_speculative(
            model, draft, images, pre, post, max_new_tokens, draft_tokens,
            eos_token, compute_dtype, impl, kv_dtype=kv_dtype,
            prefill_chunk=prefill_chunk, attn=attn,
            return_stats=return_stats)

    return lambda params, dparams, images, pre, post: _over_rows(
        mesh, row, [params, dparams], [images, pre, post], return_stats)


def make_tp_speculative_generate(
        target_cfg: LlamaConfig, draft_cfg: LlamaConfig, mesh: Mesh,
        max_new_tokens: int, draft_tokens: int = 4, eos_token: int = 2,
        compute_dtype: torch.dtype = torch.bfloat16, kv_dtype=None,
        prefill_chunk: Optional[int] = None, attn: str = "auto",
        return_stats: bool = False):
    """`gen(tparams, dparams, target_embeds, draft_embeds)`: speculative
    greedy decode (models/speculative.py) with the target TP-sharded over
    `mesh`; the tokens are make_tp_generate's of the target. The draft is
    hosted as its params were placed: `shard_llama_params` splits its
    weight stream (it needs `draft_tp_divisible`) at the price of two
    partial-sum exchanges a layer, `replicate_llama_params` runs the whole
    draft on each row's first device with none."""
    from mmrs_tpu_torch.models.speculative import speculative_generate

    _check_divisible(target_cfg, mesh)

    def row(target, draft, temb, demb):
        return speculative_generate(
            target, draft, temb, demb, max_new_tokens=max_new_tokens,
            draft_tokens=draft_tokens, eos_token=eos_token,
            compute_dtype=compute_dtype, kv_dtype=kv_dtype,
            prefill_chunk=prefill_chunk, attn=attn,
            return_stats=return_stats)

    return lambda tparams, dparams, temb, demb: _over_rows(
        mesh, row, [tparams, dparams], [temb, demb], return_stats)
