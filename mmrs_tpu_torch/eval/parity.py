"""Real-weight parity gate + bf16-vs-f32 rank-parity gate.

Counterpart of mmrs_tpu/eval/parity.py on the PyTorch port. The reference
records golden outputs that pin its exact behavior:

  - smoke probs [0.9927937, 0.00421068, 0.00299572] for CLIP.png vs
    ("a diagram", "a dog", "a cat")            (code/test_clip.py:18)
  - EN lychee threshold 27.6327 -> F1 0.9468   (clip_en.ipynb cell 76;
    reused at code/merge_dataset.py:395)
  - CN lychee threshold 10.3771 -> F1 1.00     (clip_cn.ipynb cell 18;
    code/merge_dataset.py:397)

`mmrs-torch parity` drives this module: given a converted checkpoint it
reproduces the smoke probs, given labeled folders the calibrated
thresholds, and given a directory of downloaded releases (`--release`)
the whole drop-in gate (models/release.py reads the published layouts).
The towers run on the card (K3, K2; K6 in the int8 tower) unless the CPU
is asked for.

The rank-parity half needs no weights at all: it checks that bf16 gallery
residency (the serving default) preserves the f32 top-k ranking on a
synthetic gallery — every disagreement must be a near-tie within the bf16
rounding bound, and planted well-separated queries must match exactly.
The bf16 top-k is the fused scan (ops/topk.cosine_topk: K1 on the card);
the f32 oracle is numpy.

The tokenizer differentials import `transformers` / `tokenizers` when
they run; without them a section records why it was skipped.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# code/test_clip.py:18 (printed expectation kept in the reference)
GOLDEN_SMOKE_PROBS = (0.9927937, 0.00421068, 0.00299572)
GOLDEN_SMOKE_TEXTS = ("a diagram", "a dog", "a cat")
# clip_en.ipynb cell 76 / merge_dataset.py:395 and clip_cn.ipynb cell 18 /
# merge_dataset.py:397
GOLDEN_EN_LYCHEE = {"threshold": 27.6327, "f1": 0.9468,
                    "precision": 0.959, "recall": 0.935}
GOLDEN_CN_LYCHEE = {"threshold": 10.3771, "f1": 1.00}

# one bf16 mantissa step at ~1.0; two rounded unit-norm inputs give score
# noise a small multiple of this
BF16_EPS = 2.0 ** -8

# the int8 gate's inputs: images and distractor gallery rows from these
# seeds (CPU generators, so every device sees the same values)
GATE_IMAGE_SEED = 1
GATE_GALLERY_SEED = 2
GATE_GALLERY_ROWS = 1000


@dataclass
class SmokeResult:
    probs: np.ndarray              # [3]
    golden: Tuple[float, float, float]
    max_abs_diff: float
    ok: bool


def smoke_probs(towers, image_path: str,
                texts: Sequence[str] = GOLDEN_SMOKE_TEXTS,
                image_size: int = 224) -> np.ndarray:
    """The code/test_clip.py flow on our towers: one image, three captions,
    softmax of 100 * cosine logits."""
    from mmrs_tpu_torch.io.images import load_image
    from mmrs_tpu_torch.models.clip import zeroshot_probs

    r = load_image(image_path, size=image_size)
    img = towers.image_encode(np.asarray(r.pixels)[None])
    txt = towers.text_encode(list(texts))
    probs = zeroshot_probs(torch.from_numpy(np.asarray(img, np.float32)),
                           torch.from_numpy(np.asarray(txt, np.float32)))
    return probs.numpy().astype(np.float32)[0]


def check_smoke(probs: np.ndarray, atol: float = 5e-3) -> SmokeResult:
    golden = np.asarray(GOLDEN_SMOKE_PROBS, np.float32)
    diff = float(np.max(np.abs(probs - golden)))
    return SmokeResult(probs=probs, golden=GOLDEN_SMOKE_PROBS,
                       max_abs_diff=diff, ok=diff <= atol)


def threshold_parity(result, golden: dict, thr_atol: float = 0.05,
                     f1_atol: float = 0.01) -> dict:
    """Compare a SweepResult against a recorded notebook threshold."""
    thr_ok = abs(result.best_threshold - golden["threshold"]) <= thr_atol
    f1_ok = abs(result.best_f1 - golden["f1"]) <= f1_atol
    return {
        "best_threshold": result.best_threshold,
        "golden_threshold": golden["threshold"],
        "threshold_ok": thr_ok,
        "best_f1": result.best_f1,
        "golden_f1": golden["f1"],
        "f1_ok": f1_ok,
        # the aggregated gate keys on "ok": without it a failed headline
        # threshold parity would not fail the release gate
        "ok": bool(thr_ok and f1_ok),
    }


# --------------------------------------------------------------------------
# release drop-in gate: the whole parity suite over downloaded artifacts
# --------------------------------------------------------------------------

# texts exercised by the tokenizer differentials: the golden smoke captions,
# the reference's prompt templates, and the llava template chunks
DIFFERENTIAL_TEXTS = [
    "a diagram", "a dog", "a cat",
    "a photo of lychee", "a photo of a T-shirt",
    "a photo that is not a guitar",
    "Does this image contain a cat?",
    "Answer with ONLY a single word: 'yes' or 'no'.",
    "hello world!", "  spaced   out  ", "café 中文",
]
DIFFERENTIAL_TEXTS_CN = [
    "一张荔枝的图片", "一张T恤的图片", "一张吉他的图片",
    "一张羽毛球拍的图片", "一张包子的图片", "中文 mixed english 123",
]


def _compute_dtype(device: torch.device) -> torch.dtype:
    # bf16 is the serving dtype on the card; the CPU (tests) verifies in f32
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _device(device) -> torch.device:
    from mmrs_tpu_torch.pipeline import default_device

    return torch.device(device) if device is not None else default_device()


def _image_encoder(model, dtype: torch.dtype, device: torch.device):
    from mmrs_tpu_torch.models import clip as clip_mod
    from mmrs_tpu_torch.ops.preprocess import normalize_images

    def image_encode(pixels_u8):
        x = normalize_images(torch.from_numpy(np.ascontiguousarray(
            pixels_u8)).to(device), dtype=dtype)
        return clip_mod.encode_image(model, x, dtype).cpu().numpy()

    return image_encode


def build_release_towers(rm, tokenizer=None, device=None):
    """Encode callables from a loaded openai_clip / hf_clip ReleaseModel
    (the pipeline.build_towers shape, but weights come from the release),
    on `device` (default: pipeline.default_device()). `params` is the CLIP
    module, its weights f32 (the int8 gate's reference tower)."""
    from mmrs_tpu_torch.models import clip as clip_mod
    from mmrs_tpu_torch.models import convert_jax
    from mmrs_tpu_torch.pipeline import Towers

    device = _device(device)
    dtype = _compute_dtype(device)
    model = convert_jax.from_jax_params(rm.params, rm.config).to(
        device).requires_grad_(False)

    text_encode = None
    if tokenizer is not None:
        def text_encode(texts):
            ids = torch.from_numpy(np.asarray(tokenizer(texts))).to(device)
            return clip_mod.encode_text(model, ids, dtype).cpu().numpy()

    return Towers(image_encode=_image_encoder(model, dtype, device),
                  text_encode=text_encode, params=model,
                  clip_config=rm.config, tokenizer=tokenizer)


def build_cn_towers(clip_rm, bert_rm, bert_tokenizer=None, device=None):
    """The Chinese pair: HF CLIP image tower x Taiyi text tower
    (code/test_taiyi.py:9-27 — text features are the classifier logits)."""
    from mmrs_tpu_torch.models import clip as clip_mod
    from mmrs_tpu_torch.models import convert_jax
    from mmrs_tpu_torch.models.clip import TaiyiCLIPConfig
    from mmrs_tpu_torch.pipeline import Towers

    device = _device(device)
    dtype = _compute_dtype(device)
    vcfg = (clip_rm.config.vision if hasattr(clip_rm.config, "vision")
            else clip_rm.config)
    visual = (clip_rm.params["visual"] if "visual" in clip_rm.params
              else clip_rm.params)
    ccfg = TaiyiCLIPConfig(vision=vcfg, text=bert_rm.config)
    model = convert_jax.from_jax_taiyi(
        {"visual": visual, "text": bert_rm.params,
         "logit_scale": np.float32(ccfg.logit_scale_init)}, ccfg)
    model = model.to(device).requires_grad_(False)

    text_encode = None
    if bert_tokenizer is not None:
        def text_encode(texts):
            ids, mask = (torch.from_numpy(np.asarray(x)).to(device)
                         for x in bert_tokenizer(texts))
            return clip_mod.taiyi_encode_text(model, ids, mask,
                                              dtype).cpu().numpy()

    return Towers(image_encode=_image_encoder(model, dtype, device),
                  text_encode=text_encode, params=model, clip_config=ccfg,
                  tokenizer=bert_tokenizer)


def clip_bpe_differential(merges_path: str, texts=None) -> dict:
    """Our CLIP BPE over the REAL merges file vs transformers'
    CLIPTokenizer (independent merge application; shared standard vocab
    construction). One wrong merge rule = a token-id mismatch here."""
    import gzip
    import tempfile

    from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer

    texts = texts or DIFFERENTIAL_TEXTS
    ours = CLIPTokenizer.from_file(merges_path)
    try:
        import json as _json

        from transformers import CLIPTokenizer as HFTok
    except Exception as e:  # noqa: BLE001
        return {"checked": 0, "ok": True, "skipped": f"no oracle: {e!r}"}
    note = None
    try:
        import ftfy  # noqa: F401 — the oracle's openai-faithful text cleaner
    except ImportError:
        # Without ftfy, HF's fallback cleaner space-splits CJK chars — a
        # known divergence from OpenAI's clip.tokenize (which requires
        # ftfy and keeps CJK runs intact, as we do). Compare on the texts
        # both normalize identically.
        texts = [t for t in texts
                 if not any(0x4E00 <= ord(c) <= 0x9FFF for c in t)]
        note = "no ftfy: CJK texts excluded from the HF comparison"
    with tempfile.TemporaryDirectory() as td:
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges_txt = "\n".join(
            [lines[0]] + [m for m in lines[1:49152 - 256 - 2 + 1]
                          if len(m.split()) == 2])
        mp = f"{td}/merges.txt"
        with open(mp, "w", encoding="utf-8") as f:
            f.write(merges_txt)
        vp = f"{td}/vocab.json"
        with open(vp, "w", encoding="utf-8") as f:
            _json.dump(ours.encoder, f, ensure_ascii=False)
        hf = HFTok(vocab_file=vp, merges_file=mp)
        mism = []
        for t in texts:
            mine = ours.encode(t)  # raw BPE ids (no sot/eot framing)
            theirs = hf(t, add_special_tokens=False)["input_ids"]
            if mine != theirs:
                mism.append({"text": t, "ours": mine, "hf": theirs})
    out = {"checked": len(texts), "mismatches": mism, "ok": not mism}
    if note:
        out["note"] = note
    return out


def sp_differential(model_path: str, texts=None) -> dict:
    """Our SentencePiece BPE over the REAL tokenizer.model vs an HF
    `tokenizers` BPE assembled exactly the way transformers'
    LlamaConverter converts it."""
    from mmrs_tpu_torch.cascade.verifier import llava_v1_prompt_parts
    from mmrs_tpu_torch.models.sentencepiece import SentencePieceBPE

    pre, post = llava_v1_prompt_parts("Does this image contain a cat?")
    texts = texts or (DIFFERENTIAL_TEXTS + [pre, post, "yes", "no"])
    ours = SentencePieceBPE.from_file(model_path, add_bos=False)
    try:
        from tokenizers import AddedToken, Tokenizer, normalizers
        from tokenizers.models import BPE
        from transformers.convert_slow_tokenizer import generate_merges
        from transformers.utils import sentencepiece_model_pb2_new as pb2
    except Exception as e:  # noqa: BLE001
        return {"checked": 0, "ok": True, "skipped": f"no oracle: {e!r}"}
    proto = pb2.ModelProto()
    with open(model_path, "rb") as f:
        proto.ParseFromString(f.read())
    vocab_scores = [(p.piece, p.score) for p in proto.pieces]
    vocab = {w: i for i, (w, _) in enumerate(vocab_scores)}
    merges = generate_merges(vocab, vocab_scores)
    unk = proto.pieces[proto.trainer_spec.unk_id].piece \
        if proto.pieces else "<unk>"
    hf = Tokenizer(BPE(vocab, merges, unk_token=unk, fuse_unk=True,
                       byte_fallback=True, dropout=None))
    specials = [p.piece for p in proto.pieces if p.type == 3]  # CONTROL
    hf.add_tokens([AddedToken(s, normalized=False, special=True)
                   for s in specials])
    hf.normalizer = normalizers.Sequence(
        [normalizers.Prepend(prepend="▁"),
         normalizers.Replace(pattern=" ", content="▁")])
    mism = []
    for t in texts:
        if not t:
            continue
        mine = ours.encode(t, add_bos=False)
        theirs = hf.encode(t, add_special_tokens=False).ids
        if mine != theirs:
            mism.append({"text": t, "ours": mine, "hf": theirs})
    return {"checked": len(texts), "mismatches": mism, "ok": not mism}


def bert_vocab_differential(vocab_path: str, texts=None) -> dict:
    """Our WordPiece over the REAL vocab.txt vs transformers' BertTokenizer
    (the Taiyi text path, code/test_taiyi.py:20)."""
    from mmrs_tpu_torch.models.tokenizer import BertWordPieceTokenizer

    texts = texts or DIFFERENTIAL_TEXTS_CN
    ours = BertWordPieceTokenizer.from_vocab_file(vocab_path)
    try:
        from transformers import BertTokenizer
    except Exception as e:  # noqa: BLE001
        return {"checked": 0, "ok": True, "skipped": f"no oracle: {e!r}"}
    hf = BertTokenizer(vocab_file=vocab_path)
    mism = []
    for t in texts:
        ids, mask = ours([t])
        mine = ids[0][mask[0] == 1].tolist()
        theirs = hf(t)["input_ids"]
        if mine != theirs:
            mism.append({"text": t, "ours": mine, "hf": theirs})
    return {"checked": len(texts), "mismatches": mism, "ok": not mism}


def gate_inputs(ccfg, n_images: int = 16):
    """The int8 gate's default inputs: images N(0, 0.25) [n, S, S, 3] f32
    from GATE_IMAGE_SEED and GATE_GALLERY_ROWS distractor rows [R,
    embed_dim] N(0, 1) from GATE_GALLERY_SEED (CPU generators)."""
    size = ccfg.vision.image_size
    imgs = torch.randn((n_images, size, size, 3), generator=torch.Generator()
                       .manual_seed(GATE_IMAGE_SEED)) * 0.5
    gal = torch.randn((GATE_GALLERY_ROWS, ccfg.vision.embed_dim),
                      generator=torch.Generator().manual_seed(
                          GATE_GALLERY_SEED))
    return imgs, gal.numpy()


def int8_geometry_gate(model, ccfg, n_images: int = 16, images=None,
                       gallery=None, impl: str = "auto") -> dict:
    """int8 serving-tower gate on GIVEN weights (a CLIP module, f32): the
    embedding cosine of the int8 tower (a quantized copy, bf16 compute;
    K6 and K2 on the card) to the f32 tower, and top-1 retrieval agreement
    against the f32 embeddings plus distractor rows. `images` [n, S, S, 3]
    (CLIP-normalized) and `gallery` [R, D] default to gate_inputs';
    `impl="torch"` runs the towers' plain route (K2 / K6 plain)."""
    from mmrs_tpu_torch.models import clip as clip_mod
    from mmrs_tpu_torch.models.quantize import quantize_clip_visual

    device = next(model.parameters()).device
    if images is None or gallery is None:
        d_imgs, d_gal = gate_inputs(ccfg, n_images)
        images = d_imgs if images is None else images
        gallery = d_gal if gallery is None else gallery
    imgs = torch.tensor(np.asarray(images, np.float32)).to(device)
    f32 = clip_mod.encode_image(model, imgs, torch.float32,
                                impl=impl).cpu().numpy()
    q8_model = quantize_clip_visual(copy.deepcopy(model))
    q8 = clip_mod.encode_image(q8_model, imgs, torch.bfloat16,
                               impl=impl).cpu().numpy()
    del q8_model
    cos = np.sum(f32 * q8, axis=1)
    gal = np.concatenate([f32, np.asarray(gallery, np.float32)])
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    top1 = (np.argmax(q8 @ gal.T, 1) == np.argmax(f32 @ gal.T, 1))
    return {"min_cosine_vs_f32": float(cos.min()),
            "top1_agreement": float(top1.mean()),
            "ok": bool(cos.min() > 0.995 and top1.all())}


def _embed_folder(towers, folder: str, image_size: int) -> np.ndarray:
    from mmrs_tpu_torch.io.dataset import FolderDataset

    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tiff", ".gif")
    paths = sorted(
        os.path.join(r, f)
        for r, _, fs in os.walk(folder) for f in fs
        if f.lower().endswith(exts))
    ds = FolderDataset([(p, "x") for p in paths], image_size=image_size)
    return np.concatenate(
        [towers.image_encode(b.pixels)[b.ok] for b in ds.batches(64)], axis=0)


def release_gate(root: str, image: Optional[str] = None,
                 pos_dir: Optional[str] = None,
                 neg_dir: Optional[str] = None,
                 prompt: Optional[str] = None,
                 golden: str = "en",
                 logit_scale: float = 100.0,
                 llava_smoke: bool = False,
                 device=None) -> dict:
    """The whole drop-in gate over a directory of downloaded releases.

    Runs every check the discovered artifacts allow: smoke probs
    (openai_clip + --image, code/test_clip.py:18), notebook threshold
    reproduction (tower pair + --pos-dir/--neg-dir/--prompt), int8
    geometry, and the three tokenizer differentials. Sections report
    ok=True/False; missing inputs are recorded as "skipped", never
    silently dropped."""
    from mmrs_tpu_torch.models.release import load_release_model, scan_pack
    from mmrs_tpu_torch.models.tokenizer import (BertWordPieceTokenizer,
                                                 CLIPTokenizer)
    from mmrs_tpu_torch.search.calibrate import find_thresholds

    device = _device(device)
    pack = scan_pack(root)
    report: dict = {
        "found_models": dict(pack["models"]),
        "found_tokenizers": dict(pack["tokenizers"]),
    }
    models = {}
    for kind, path in pack["models"].items():
        models[kind] = load_release_model(path)
        report.setdefault("loaded", {})[kind] = {
            "path": path,
            "config": repr(models[kind].config),
        }
    toks = pack["tokenizers"]

    # tokenizer differentials (independent of weights)
    if "clip_bpe" in toks:
        report["clip_bpe_differential"] = clip_bpe_differential(
            toks["clip_bpe"])
    if "sp_model" in toks:
        report["sp_differential"] = sp_differential(toks["sp_model"])
    if "bert_vocab" in toks:
        report["bert_vocab_differential"] = bert_vocab_differential(
            toks["bert_vocab"])

    # EN towers (openai archive preferred — the reference's clip.load path)
    en_rm = models.get("openai_clip") or (
        models.get("hf_clip") if "taiyi_bert" not in models else None)
    en_towers = None
    if en_rm is not None:
        tok = (CLIPTokenizer.from_file(toks["clip_bpe"])
               if "clip_bpe" in toks else None)
        en_towers = build_release_towers(en_rm, tokenizer=tok, device=device)
        if image and tok is not None:
            probs = smoke_probs(en_towers, image,
                                image_size=en_rm.config.vision.image_size)
            s = check_smoke(probs)
            report["smoke"] = {"probs": [float(p) for p in s.probs],
                               "golden": list(s.golden),
                               "max_abs_diff": s.max_abs_diff, "ok": s.ok}
        elif image:
            report["smoke"] = {"skipped": "no bpe merges file in pack"}
        report["int8_tower"] = int8_geometry_gate(en_towers.params,
                                                  en_rm.config)
    elif image:
        # --image was asked for but no EN tower resolves (e.g. the pack
        # pairs hf_clip with taiyi_bert): record the skip, never drop the
        # section silently (the gate's documented contract)
        report["smoke"] = {"skipped": "no EN CLIP tower in pack"}

    # CN pair (HF CLIP image tower x Taiyi text tower)
    cn_towers = None
    if "hf_clip" in models and "taiyi_bert" in models:
        btok = (BertWordPieceTokenizer.from_vocab_file(toks["bert_vocab"])
                if "bert_vocab" in toks else None)
        cn_towers = build_cn_towers(models["hf_clip"], models["taiyi_bert"],
                                    bert_tokenizer=btok, device=device)
        report.setdefault("loaded", {})["cn_pair"] = {
            "image_tower": models["hf_clip"].path,
            "text_tower": models["taiyi_bert"].path}

    # notebook threshold reproduction
    if pos_dir and neg_dir and prompt:
        towers = cn_towers if golden == "cn" else en_towers
        if towers is None or towers.text_encode is None:
            report["threshold"] = {
                "skipped": f"no usable {golden} tower pair/tokenizer"}
        else:
            size = towers.clip_config.vision.image_size
            txt = np.asarray(towers.text_encode([prompt])[0])
            txt = txt / np.linalg.norm(txt)
            pos = _embed_folder(towers, pos_dir, size)
            neg = _embed_folder(towers, neg_dir, size)
            res = find_thresholds(pos @ txt * logit_scale,
                                  neg @ txt * logit_scale)
            gold = GOLDEN_CN_LYCHEE if golden == "cn" else GOLDEN_EN_LYCHEE
            report["threshold"] = threshold_parity(res, gold)

    # llava: structural load + optional smoke decode
    if "llava" in models:
        rm = models["llava"]
        n_params = int(sum(np.prod(x.shape) for x in
                           _iter_arrays(rm.params)))
        sec = {"path": rm.path, "n_params": n_params,
               "lm_dim": rm.config.lm.dim, "lm_layers": rm.config.lm.layers,
               "vision_size": rm.config.vision.image_size, "ok": True}
        if llava_smoke and image and "sp_model" in toks:
            from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
            from mmrs_tpu_torch.models import convert_jax
            from mmrs_tpu_torch.models.sentencepiece import SentencePieceBPE

            ver = LLaVAVerifier(
                convert_jax.from_jax_llava(rm.params, rm.config,
                                           device=device),
                rm.config, SentencePieceBPE.from_file(toks["sp_model"]),
                max_new_tokens=8, image_size=rm.config.vision.image_size,
                early_stop=True, device=device)
            out = ver.generate_text(image, "Does this image contain a dog?")
            sec["smoke_answer"] = out
            sec["smoke_parsed_yes"] = "yes" in out.lower()
        report["llava"] = sec

    oks = [sec["ok"] for sec in report.values()
           if isinstance(sec, dict) and "ok" in sec]
    report["ok"] = bool(oks) and all(oks)
    return report


def _iter_arrays(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_arrays(v)
    elif hasattr(tree, "shape"):
        yield tree


# --------------------------------------------------------------------------
# bf16-vs-f32 rank parity (no weights needed)
# --------------------------------------------------------------------------

@dataclass
class RankParityReport:
    n: int
    queries: int
    k: int
    exact_queries: int             # queries whose top-k list matches exactly
    tie_flips: int                 # rank disagreements that are eps-ties
    violations: int                # disagreements beyond the tie tolerance
    max_tie_gap: float             # largest f32 score gap among flips
    planted_exact: Optional[bool]  # well-separated queries matched exactly
    ok: bool


def _topk_f32(queries: np.ndarray, gallery: np.ndarray, k: int):
    scores = queries @ gallery.T
    idx = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(scores, idx, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    return np.take_along_axis(vals, order, 1), np.take_along_axis(idx, order, 1)


def rank_parity_report(
    n: int = 100_000,
    d: int = 512,
    queries: int = 16,
    k: int = 10,
    seed: int = 0,
    tie_tol: float = 4 * BF16_EPS,
    planted: int = 4,
    impl: str = "auto",
    device=None,
) -> RankParityReport:
    """Serving-dtype rank gate: top-k over the bf16 device gallery (the
    fused scan, K1 on the card; `impl="torch"` its plain version) must
    equal the f32 oracle, except for flips between scores that the f32
    oracle itself calls a near-tie (gap < tie_tol — bf16 input rounding
    cannot preserve order below its own quantization noise). `planted`
    queries are given a clearly-separated true top-k (margin >> tie_tol),
    the realistic retrieval case; those must match EXACTLY. The gallery
    comes from numpy's seeded rng, as the JAX package's."""
    from mmrs_tpu_torch.ops.topk import cosine_topk

    device = _device(device)
    rng = np.random.default_rng(seed)
    gallery = rng.normal(size=(n, d)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    qs = rng.normal(size=(queries, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)

    # plant well-separated neighborhoods for the first `planted` queries:
    # k rows at descending, well-spaced cosines to query i. Rows are
    # drawn WITHOUT replacement across ALL planted queries — a shared
    # row would let query i+1 overwrite query i's planted neighbor and
    # fail the exact-match assertion with no real bf16 violation
    n_planted = min(planted, queries)
    all_rows = rng.choice(n, size=n_planted * k, replace=False)
    for i in range(n_planted):
        rows = all_rows[i * k:(i + 1) * k]
        for j, r in enumerate(rows):
            target = 0.95 - 0.03 * j          # gaps 10x the tie tolerance
            orth = rng.normal(size=d).astype(np.float32)
            orth -= orth @ qs[i] * qs[i]
            orth /= np.linalg.norm(orth)
            gallery[r] = target * qs[i] + np.sqrt(1 - target ** 2) * orth

    v32, i32 = _topk_f32(qs, gallery, k)

    g16 = torch.from_numpy(gallery).to(device).to(torch.bfloat16)
    q16 = torch.from_numpy(qs).to(device).to(torch.bfloat16)
    _, i16 = cosine_topk(q16, g16, k=k, impl=impl)
    i16 = i16.cpu().numpy()
    del g16

    scores32 = qs @ gallery.T
    exact = 0
    tie_flips = 0
    violations = 0
    max_gap = 0.0
    planted_exact = True
    for qi in range(queries):
        if np.array_equal(i16[qi], i32[qi]):
            exact += 1
            continue
        if qi < planted:
            planted_exact = False
        # every position disagreement must be a near-tie in f32 scores
        for pos in range(k):
            a, b = i16[qi, pos], i32[qi, pos]
            if a == b:
                continue
            gap = abs(scores32[qi, a] - scores32[qi, b])
            max_gap = max(max_gap, float(gap))
            if gap < tie_tol:
                tie_flips += 1
            else:
                violations += 1
    return RankParityReport(
        n=n, queries=queries, k=k, exact_queries=exact,
        tie_flips=tie_flips, violations=violations, max_tie_gap=max_gap,
        planted_exact=planted_exact if planted else None,
        ok=(violations == 0) and (planted_exact if planted else True),
    )
