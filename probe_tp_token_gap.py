#!/usr/bin/env python3
"""The bf16 token gaps that chip_smoke.py holds to TP_TOKEN_GAP, read over
many verify packs on one NVIDIA GPU.

    python3 probe_tp_token_gap.py [--packs N] [--nudge]
    python3 probe_tp_token_gap.py --tree DIR [--packs N] [--nudge]
        (DIR: an unpacked earlier commit of this repository: its package in
        place of this one's, with this checkout's chip_smoke.py helpers)

Builds chip_smoke.py's seeded LLaVA-v1.5-7B (phases 4e and 4j) and N packs
of VERIFY_BATCH synthetic JPEGs: pack 0 is phase 4j's pack (the first of
phase 4e's 16 images), pack p > 0 eight images from seed SEED + 1000 + p.
For each pack, on the embeddings the tree's default route gives (the
tower's kernels where the tree has them):
  - 4j: the decoder at TP = 2 and TP = 4 (the first card repeated where
    the machine has one) decodes 32 greedy tokens a row; the one-device
    decoder is fed them, and the gap is how far a fed token lies below its
    best logit at most, over the pack's 256 steps; `same` the steps at
    which it picks the fed token;
  - 4e: the all-plain route (the tower's and the decoder's plain ops) fed
    the one-device kernel route's tokens: the same two readings;
  - the one-device decoder's own top-2 margins (median, least).
With --nudge, the 4j readings again on the same embeddings moved by one
bf16 ulp at a seeded half of the image tokens' elements (up or down, never
across zero): how far rounding alone moves the gap.
Also, on a tree with ops/layer_norm.py, the digest of the embeddings with
every LayerNorm on its plain ops, to set beside an earlier tree's default.
One line a reading, a JSON line of all of them, then the card's name and
power limit.
"""

import hashlib
import importlib.util
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 32
TP_WIDTHS = (2, 4)
NUDGE_SEED = 20260


def load_smoke():
    """This checkout's chip_smoke.py (its greedy trace and data makers),
    whatever package --tree puts first."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of sha256 over the tensor's bytes."""
    raw = t.detach().contiguous().view(torch.int16).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def nudge(emb: torch.Tensor, start: int, n: int, seed: int) -> torch.Tensor:
    """emb [B, T, D] bf16 with the rows start..start+n moved by one bf16 ulp
    at a seeded half of their nonzero elements, up or down in magnitude
    with equal odds (a step of the raw bits; a zero stays)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    part = emb[:, start:start + n]
    pick = torch.rand(part.shape, generator=g) < 0.5
    step = torch.where(torch.rand(part.shape, generator=g) < 0.5, 1, -1)
    step = (step * pick).to(torch.int16).to(emb.device)
    bits = part.contiguous().view(torch.int16)
    bits = torch.where(part != 0, bits + step, bits)
    out = emb.clone()
    out[:, start:start + n] = bits.view(torch.bfloat16)
    return out


def pack_paths(sm, root: str, packs: int):
    """[paths of pack p]: pack 0 phase 4j's (the first VERIFY_BATCH of
    phase 4e's LLAVA_IMAGES), then VERIFY_BATCH images a seed."""
    first = sm.synthetic_jpegs(os.path.join(root, "p0"), sm.LLAVA_IMAGES,
                               sm.SEED)[:sm.VERIFY_BATCH]
    return [first] + [sm.synthetic_jpegs(os.path.join(root, f"p{p}"),
                                         sm.VERIFY_BATCH, sm.SEED + 1000 + p)
                      for p in range(1, packs)]


def probe(sm, dev, packs: int, with_nudge: bool, rows):
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.models import layers, llava
    from mmrs_tpu_torch.models.configs import VIT_L14_336
    from mmrs_tpu_torch.models.llama import LLAMA2_7B
    from mmrs_tpu_torch.models.sentencepiece import SentencePieceBPE
    from mmrs_tpu_torch.parallel.mesh import make_mesh
    from mmrs_tpu_torch.parallel.vlm import shard_llava_params

    bf16 = torch.bfloat16
    cfg = llava.LLaVAConfig(vision=VIT_L14_336, lm=LLAMA2_7B)
    model = llava.LLaVA(cfg, torch.Generator(device=dev).manual_seed(
        sm.SEED), device=dev, dtype=bf16).requires_grad_(False)
    devs, how = sm.tp_devices(max(TP_WIDTHS))
    sharded = {tp: shard_llava_params(model, make_mesh(
        MeshConfig(data_size=1, model_size=tp), devs[:tp])).rows[0]
        for tp in TP_WIDTHS}
    print(f"probe mesh: {how}", flush=True)
    tmp = tempfile.TemporaryDirectory()
    tok_path = os.path.join(tmp.name, "tokenizer.model")
    sm.tiny_sentencepiece(tok_path)
    v = LLaVAVerifier(model, cfg, SentencePieceBPE.from_file(tok_path),
                      max_new_tokens=STEPS, prefill_chunk=64, device=dev)
    pre_ids, post_ids = v._prompt_ids(v.prompt_template.format(
        category="cat"))
    pre, post = v._ids(pre_ids, sm.VERIFY_BATCH), v._ids(post_ids,
                                                         sm.VERIFY_BATCH)
    plain_norms = hasattr(layers, "layer_norm")

    def embeds(images, impl="auto", norms="auto"):
        saved = getattr(layers, "layer_norm", None)
        if norms == "torch":
            layers.layer_norm = (lambda *a, **kw:
                                 saved(*a, **{**kw, "impl": "torch"}))
        try:
            with torch.inference_mode():
                img = llava.encode_images(model, images, bf16, impl)
                return llava.build_multimodal_embeds(model, pre, img, post,
                                                     bf16)
        finally:
            if norms == "torch":
                layers.layer_norm = saved

    def trace(lm, emb, attn="auto", forced=None):
        with torch.inference_mode():
            return sm.greedy_trace(lm, emb, None, attn, STEPS, forced=forced)

    def held(tokens, emb, attn="auto"):
        """(gap, same): the one-device decoder on `emb` fed `tokens`."""
        _, tf, _, gaps = trace(model.lm, emb, attn, forced=tokens)
        return float(gaps.max()), int((tf == tokens).sum())

    t0 = time.perf_counter()
    for p, paths in enumerate(pack_paths(sm, tmp.name, packs)):
        images = torch.cat([v._load_image(path) for path in paths])
        emb = embeds(images)
        row = {"pack": p, "embeds": digest(emb)}
        if plain_norms:
            row["embeds_plain_norms"] = digest(embeds(images,
                                                      norms="torch"))
        _, tk, mk, _ = trace(model.lm, emb)
        row["margin_median"] = float(mk.median())
        row["margin_min"] = float(mk.min())
        ep = embeds(images, impl="torch")
        row["4e_gap"], row["4e_same"] = held(tk, ep, attn="torch")
        variants = [("as built", emb)]
        if with_nudge:
            image_rows = emb.shape[1] - pre.shape[1] - post.shape[1]
            variants.append(("+1 ulp", nudge(emb, pre.shape[1], image_rows,
                                             NUDGE_SEED + p)))
        for name, e in variants:
            for tp, sh in sharded.items():
                _, tt, _, _ = trace(sh.lm, e)
                gap, same = held(tt, e)
                row[f"{name}: tp{tp}_gap"] = gap
                row[f"{name}: tp{tp}_same"] = same
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print("probe " + json.dumps(row), flush=True)
    tmp.cleanup()


def main(argv) -> int:
    tree = ROOT
    if "--tree" in argv:
        tree = os.path.abspath(argv[argv.index("--tree") + 1])
    packs = int(argv[argv.index("--packs") + 1]) if "--packs" in argv else 8
    sys.path.insert(0, tree)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    sm = load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rows = []
    probe(sm, dev, packs, "--nudge" in argv, rows)
    print(json.dumps({"tree": tree, "rows": rows,
                      "seconds": time.perf_counter() - t0}))
    print(sm.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
