"""Release-layout checkpoint loading: the exact artifacts users download.

A copy of mmrs_tpu/models/release.py for the PyTorch port: numpy and the
port's configs only. BF16 safetensors are read as their uint16 bits
through checkpoint.bf16_from_bits (no `ml_dtypes`); the converters
(models/convert.py) return numpy trees with the JAX package's keys,
shapes and dtypes, which checkpoint.save_npz writes and
models/convert_jax.py loads.

Drop-in parity (the "real-weight pack"): the day real weights land,
`mmrs parity --release DIR` must run the full golden gate with ZERO code
changes. This module therefore reads the published file layouts directly:

  - OpenAI clip `ViT-B-32.pt` / `ViT-L-14.pt`: TorchScript archives — what
    `clip.load("ViT-B/32")` downloads (code/test_clip.py:6). Plain
    torch.save state dicts are accepted too.
  - HF model directories (config.json + pytorch_model.bin or
    model.safetensors, sharded via *.index.json or not):
      * openai/clip-vit-large-patch14 (code/test_taiyi.py:17)
      * IDEA-CCNL/Taiyi-CLIP-Roberta-large-326M-Chinese (code/test_taiyi.py:11)
      * llava-v1.5-7b in BOTH layouts: the original liuhaotian layout that
        `llava.model.builder.load_pretrained_model` reads
        (model.mm_projector.*, model.vision_tower.vision_tower.*,
        code/test_llava.py:8-13) and the transformers
        LlavaForConditionalGeneration layout (vision_tower.*,
        language_model.*, multi_modal_projector.*).
  - tokenizer artifacts found next to the weights:
    bpe_simple_vocab_16e6.txt(.gz) (CLIP BPE, CLIP/lab1.py:56 relies on
    clip.tokenize's bundled copy), vocab.txt (BERT WordPiece,
    code/test_taiyi.py:20), tokenizer.model (SentencePiece,
    code/test_llava.py:8).

Model configs are DERIVED — from config.json for HF dirs, from state-dict
shapes for OpenAI archives (head count follows CLIP's width//64
convention) — so any released size loads without code edits.

The safetensors reader/writer below is self-contained numpy (the format is
an 8-byte header length + JSON header + raw little-endian tensor bytes);
no safetensors dependency is needed.
"""

from __future__ import annotations

import json
import os
import re
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from mmrs_tpu_torch.models.configs import BertConfig, TextConfig, VITConfig

StateDict = Dict[str, np.ndarray]

# ---------------------------------------------------------------------------
# safetensors (pure numpy)
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> f32 numpy (exact)."""
    from mmrs_tpu_torch.models.checkpoint import bf16_from_bits

    return bf16_from_bits(np.array(bits)).float().numpy().reshape(bits.shape)


def read_safetensors(path: str) -> StateDict:
    """Read a .safetensors file: u64-le header size, JSON header mapping
    name -> {dtype, shape, data_offsets}, then the raw tensor buffer."""
    out: StateDict = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        buf = f.read()
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        a, b = meta["data_offsets"]
        dt = (np.dtype(np.uint16) if meta["dtype"] == "BF16"
              else np.dtype(_ST_DTYPES[meta["dtype"]]))
        arr = np.frombuffer(buf[a:b], dtype=dt).reshape(meta["shape"])
        # bf16 / f16 -> f32 at the boundary (converters expect float numpy)
        if meta["dtype"] == "BF16":
            arr = _bf16_to_f32(arr)
        elif meta["dtype"] == "F16":
            arr = arr.astype(np.float32)
        out[name] = arr
    return out


def write_safetensors(path: str, tensors: StateDict) -> None:
    """Minimal writer (tests/export): f32/f16/i64/i32/i8/u8/bool tensors."""
    rev = {v: k for k, v in _ST_DTYPES.items()}
    header: Dict[str, Any] = {}
    blobs = []
    off = 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        code = rev[arr.dtype.type]
        raw = arr.tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)


# ---------------------------------------------------------------------------
# torch files (TorchScript archives and plain state dicts)
# ---------------------------------------------------------------------------

def load_torch_state(path: str) -> StateDict:
    """State dict from a .pt/.bin file. TorchScript archives (the OpenAI
    CLIP release format) are tried first, then plain torch.save files."""
    import torch

    from mmrs_tpu_torch.models.convert import state_dict_to_numpy

    try:
        obj = torch.jit.load(path, map_location="cpu")
        return state_dict_to_numpy(obj.state_dict())
    except Exception:  # noqa: BLE001 — not a TorchScript archive
        pass
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 — pickled module/container
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj \
            and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return state_dict_to_numpy(obj)


def load_model_dir_state(d: str) -> StateDict:
    """Merge the weight files of an HF model directory: sharded
    (*.index.json) or single pytorch_model.bin / model.safetensors."""
    def _load_one(p: str) -> StateDict:
        return (read_safetensors(p) if p.endswith(".safetensors")
                else load_torch_state(p))

    for index in ("model.safetensors.index.json",
                  "pytorch_model.bin.index.json"):
        ip = os.path.join(d, index)
        if os.path.exists(ip):
            with open(ip) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            out: StateDict = {}
            for s in shards:
                out.update(_load_one(os.path.join(d, s)))
            return out
    for single in ("model.safetensors", "pytorch_model.bin"):
        sp = os.path.join(d, single)
        if os.path.exists(sp):
            return _load_one(sp)
    # index-less sharded dirs: merge ONLY shard-patterned files (a blind
    # *.safetensors glob would also swallow adapter_model.safetensors etc.)
    import glob as _glob

    for pat in ("model-*.safetensors", "pytorch_model-*.bin"):
        shards = sorted(_glob.glob(os.path.join(d, pat)))
        if shards:
            out = {}
            for s in shards:
                out.update(_load_one(s))
            return out
    raise FileNotFoundError(f"no weight files found in {d}")


# ---------------------------------------------------------------------------
# config derivation
# ---------------------------------------------------------------------------

def _heads(width: int) -> int:
    """CLIP's convention: 64-dim heads (ViT-B 768/12, ViT-L 1024/16,
    text 512/8 all follow width // 64)."""
    return max(1, width // 64)


def openai_clip_configs(sd: StateDict):
    """Derive (VITConfig, TextConfig) from an OpenAI archive's shapes,
    the same way clip.model.build_model does."""
    conv = sd["visual.conv1.weight"]              # [W, 3, P, P]
    width, _, patch, _ = conv.shape
    n_pos = sd["visual.positional_embedding"].shape[0]
    grid = int(round((n_pos - 1) ** 0.5))
    layers = len({int(m.group(1)) for k in sd
                  if (m := re.match(r"visual\.transformer\.resblocks\.(\d+)\.",
                                    k))})
    embed_dim = int(sd["text_projection"].shape[1])
    t_width = int(sd["ln_final.weight"].shape[0])
    t_layers = len({int(m.group(1)) for k in sd
                    if (m := re.match(r"transformer\.resblocks\.(\d+)\.", k))})
    vocab, ctx = sd["token_embedding.weight"].shape[0], \
        sd["positional_embedding"].shape[0]
    return (
        VITConfig(image_size=grid * patch, patch_size=patch, width=width,
                  layers=layers, heads=_heads(width), embed_dim=embed_dim),
        TextConfig(vocab_size=int(vocab), context_length=int(ctx),
                   width=t_width, layers=t_layers, heads=_heads(t_width),
                   embed_dim=embed_dim),
    )


def vit_config_from_json(vc: dict, embed_dim: int) -> VITConfig:
    return VITConfig(
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 32),
        width=vc.get("hidden_size", 768),
        layers=vc.get("num_hidden_layers", 12),
        heads=vc.get("num_attention_heads", _heads(vc.get("hidden_size", 768))),
        embed_dim=embed_dim,
        quick_gelu=vc.get("hidden_act", "quick_gelu") == "quick_gelu",
    )


def text_config_from_json(tc: dict, embed_dim: int) -> TextConfig:
    return TextConfig(
        vocab_size=tc.get("vocab_size", 49408),
        context_length=tc.get("max_position_embeddings", 77),
        width=tc.get("hidden_size", 512),
        layers=tc.get("num_hidden_layers", 12),
        heads=tc.get("num_attention_heads", _heads(tc.get("hidden_size", 512))),
        embed_dim=embed_dim,
        quick_gelu=tc.get("hidden_act", "quick_gelu") == "quick_gelu",
    )


def bert_config_from_json(c: dict, num_labels: Optional[int] = None
                          ) -> BertConfig:
    return BertConfig(
        vocab_size=c.get("vocab_size", 21128),
        hidden_size=c.get("hidden_size", 1024),
        layers=c.get("num_hidden_layers", 24),
        heads=c.get("num_attention_heads", 16),
        intermediate_size=c.get("intermediate_size", 4096),
        max_position_embeddings=c.get("max_position_embeddings", 512),
        type_vocab_size=c.get("type_vocab_size", 2),
        num_labels=num_labels if num_labels is not None
        else c.get("num_labels", 768),
        layer_norm_eps=c.get("layer_norm_eps", 1e-12),
        pad_token_id=c.get("pad_token_id", 0),
    )


def llama_config_from_json(c: dict):
    from mmrs_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=c.get("vocab_size", 32000),
        dim=c.get("hidden_size", 4096),
        layers=c.get("num_hidden_layers", 32),
        heads=c.get("num_attention_heads", 32),
        kv_heads=c.get("num_key_value_heads",
                       c.get("num_attention_heads", 32)),
        mlp_dim=c.get("intermediate_size", 11008),
        rope_theta=c.get("rope_theta", 10000.0),
        norm_eps=c.get("rms_norm_eps", 1e-5),
        max_seq=c.get("max_position_embeddings", 2048),
    )


def vit_config_from_vision_sd(sd: StateDict, embed_dim: int,
                              quick_gelu: bool = True) -> VITConfig:
    """Derive a VITConfig from an HF CLIPVisionModel state dict (prefix
    stripped to vision_model.*) — used for the llava original layout,
    whose config.json names the tower but carries no vision_config."""
    conv = sd["vision_model.embeddings.patch_embedding.weight"]
    width, _, patch, _ = conv.shape
    n_pos = sd["vision_model.embeddings.position_embedding.weight"].shape[0]
    grid = int(round((n_pos - 1) ** 0.5))
    layers = len({int(m.group(1)) for k in sd
                  if (m := re.match(r"vision_model\.encoder\.layers\.(\d+)\.",
                                    k))})
    return VITConfig(image_size=grid * patch, patch_size=patch, width=width,
                     layers=layers, heads=_heads(width), embed_dim=embed_dim,
                     quick_gelu=quick_gelu)


# ---------------------------------------------------------------------------
# the original liuhaotian llava layout
# ---------------------------------------------------------------------------

def original_llava(sd: StateDict, cfg) -> Dict[str, Any]:
    """liuhaotian/llava-v1.5-7b state dict -> llava params.

    Layout (what code/test_llava.py's load_pretrained_model reads):
      model.embed_tokens / model.layers.N.* / model.norm / lm_head  (LM)
      model.mm_projector.0.* and .2.*                    (2-layer MLP)
      model.vision_tower.vision_tower.vision_model.*     (CLIP ViT-L/336)
    """
    from mmrs_tpu_torch.models.convert import _arr, hf_clip_vision, hf_llama

    vt_prefix = "model.vision_tower.vision_tower."
    vt = {k[len(vt_prefix):]: v for k, v in sd.items()
          if k.startswith(vt_prefix)}
    # hf_clip_vision expects a visual_projection; llava takes layer -2
    # features, so the projection is unused — fake it.
    vt["visual_projection.weight"] = np.zeros(
        (cfg.vision.embed_dim, cfg.vision.width), np.float32)
    lm_sd = {k: v for k, v in sd.items()
             if not k.startswith("model.mm_projector.")
             and not k.startswith(vt_prefix)}
    return {
        "visual": hf_clip_vision(vt, cfg.vision),
        "proj_w1": _arr(sd["model.mm_projector.0.weight"].T),
        "proj_b1": _arr(sd["model.mm_projector.0.bias"]),
        "proj_w2": _arr(sd["model.mm_projector.2.weight"].T),
        "proj_b2": _arr(sd["model.mm_projector.2.bias"]),
        "lm": hf_llama(lm_sd, cfg.lm),
    }


# ---------------------------------------------------------------------------
# layout detection + loading
# ---------------------------------------------------------------------------

@dataclass
class ReleaseModel:
    kind: str                       # openai_clip | hf_clip | taiyi_bert | llava
    params: Dict[str, Any]
    config: Any                     # CLIPConfig / (vision VITConfig) /
    #                                 BertConfig / LLaVAConfig
    path: str
    extras: Dict[str, str] = field(default_factory=dict)  # tokenizer files


def detect_layout(path: str) -> str:
    """'openai_clip' for a .pt file; HF dirs dispatch on config.json."""
    if os.path.isfile(path):
        return "openai_clip"
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(f"{path}: no config.json (not an HF dir)")
    with open(cfg_path) as f:
        c = json.load(f)
    mt = c.get("model_type", "")
    archs = c.get("architectures") or []
    if mt == "clip" or any("CLIPModel" in a for a in archs):
        return "hf_clip"
    if mt == "clip_vision_model" or any("CLIPVision" in a for a in archs):
        return "hf_clip_vision"
    if mt == "bert" or any("BertFor" in a for a in archs):
        return "taiyi_bert"
    if mt in ("llava", "llava_llama") or any("Llava" in a for a in archs):
        return "llava"
    raise ValueError(f"{path}: unrecognized model_type {mt!r} / {archs}")


def _find_tokenizer_files(d: str) -> Dict[str, str]:
    out = {}
    if not os.path.isdir(d):
        return out
    for name in os.listdir(d):
        low = name.lower()
        p = os.path.join(d, name)
        if "bpe_simple_vocab" in low:
            out["clip_bpe"] = p
        elif name == "vocab.txt":
            out["bert_vocab"] = p
        elif name == "tokenizer.model":
            out["sp_model"] = p
    return out


def load_release_model(path: str) -> ReleaseModel:
    """Load one released checkpoint (file or HF dir) into our params."""
    from mmrs_tpu_torch.models.clip import CLIPConfig

    kind = detect_layout(path)
    if kind == "openai_clip":
        from mmrs_tpu_torch.models.convert import openai_clip

        sd = load_torch_state(path)
        vcfg, tcfg = openai_clip_configs(sd)
        cfg = CLIPConfig(vision=vcfg, text=tcfg)
        return ReleaseModel(kind, openai_clip(sd, vcfg, tcfg), cfg, path,
                            _find_tokenizer_files(os.path.dirname(path)))

    with open(os.path.join(path, "config.json")) as f:
        cj = json.load(f)
    sd = load_model_dir_state(path)
    extras = _find_tokenizer_files(path)

    if kind == "hf_clip":
        from mmrs_tpu_torch.models.convert import hf_clip

        embed = cj.get("projection_dim", 512)
        vcfg = vit_config_from_json(cj.get("vision_config", {}), embed)
        tcfg = text_config_from_json(cj.get("text_config", {}), embed)
        cfg = CLIPConfig(vision=vcfg, text=tcfg)
        return ReleaseModel(kind, hf_clip(sd, vcfg, tcfg), cfg, path, extras)

    if kind == "hf_clip_vision":
        from mmrs_tpu_torch.models.convert import hf_clip_vision

        embed = cj.get("projection_dim", cj.get("hidden_size", 768))
        vcfg = vit_config_from_json(cj, embed)
        if "visual_projection.weight" not in sd:
            sd = dict(sd)
            sd["visual_projection.weight"] = np.eye(
                vcfg.width, vcfg.embed_dim, dtype=np.float32).T
        return ReleaseModel(kind, hf_clip_vision(sd, vcfg), vcfg, path,
                            extras)

    if kind == "taiyi_bert":
        from mmrs_tpu_torch.models.convert import hf_bert_classifier

        num_labels = (sd["classifier.weight"].shape[0]
                      if "classifier.weight" in sd else None)
        bcfg = bert_config_from_json(cj, num_labels=num_labels)
        return ReleaseModel(kind, hf_bert_classifier(sd, bcfg), bcfg, path,
                            extras)

    if kind == "llava":
        from mmrs_tpu_torch.models.convert import hf_llava
        from mmrs_tpu_torch.models.llava import LLaVAConfig

        lm_json = cj.get("text_config", cj)  # hf layout nests; original flat
        lcfg = llama_config_from_json(lm_json)
        if "model.mm_projector.0.weight" in sd:          # original layout
            vt_prefix = "model.vision_tower.vision_tower."
            vt = {k[len(vt_prefix):]: v for k, v in sd.items()
                  if k.startswith(vt_prefix)}
            vcfg = vit_config_from_vision_sd(vt, embed_dim=lcfg.dim)
            cfg = LLaVAConfig(vision=vcfg, lm=lcfg)
            return ReleaseModel(kind, original_llava(sd, cfg), cfg, path,
                                extras)
        # transformers LlavaForConditionalGeneration layout (>=4.52
        # prefixes everything with "model."; hf_llava normalizes the
        # weights itself — this strip only feeds the config fallback)
        vt = {k.rsplit("vision_tower.", 1)[1]: v for k, v in sd.items()
              if "vision_tower." in k}
        vcfg = (vit_config_from_json(cj["vision_config"], lcfg.dim)
                if "vision_config" in cj
                else vit_config_from_vision_sd(vt, embed_dim=lcfg.dim))
        cfg = LLaVAConfig(vision=vcfg, lm=lcfg)
        return ReleaseModel(kind, hf_llava(sd, cfg), cfg, path, extras)

    raise AssertionError(kind)


def scan_pack(root: str) -> Dict[str, Any]:
    """Scan a drop-in directory for every recognizable release artifact.

    Returns {"models": {kind: path}, "tokenizers": {name: path}}. `root`
    may itself be a single model (file or HF dir) or a directory whose
    children are the models (the layout a user creates by downloading the
    reference's four checkpoints side by side)."""
    models: Dict[str, str] = {}
    toks = _find_tokenizer_files(root)

    def _try(path: str):
        try:
            kind = detect_layout(path)
        except (FileNotFoundError, ValueError):
            return
        models.setdefault(kind, path)

    if os.path.isfile(root):
        _try(root)
    else:
        _try(root)
        for name in sorted(os.listdir(root)):
            p = os.path.join(root, name)
            if os.path.isdir(p) or name.endswith(".pt"):
                _try(p)
            if os.path.isdir(p):
                for k, v in _find_tokenizer_files(p).items():
                    toks.setdefault(k, v)
    return {"models": models, "tokenizers": toks}
