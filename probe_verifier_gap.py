#!/usr/bin/env python3
"""Where the LLaVA verifier's kernel route parts from its plain route, on
one NVIDIA GPU.

    python3 probe_verifier_gap.py             (from the repository root)
    python3 probe_verifier_gap.py --tree DIR  (DIR: an unpacked earlier
        commit of this repository whose towers take one `impl`: its
        package in place of this one's, on the inputs that a run without
        --tree saved)

Builds chip_smoke.py phase 4e's seeded LLaVA-v1.5-7B and its first verify
pack (8 synthetic JPEGs, the llava_v1 prompt around the image), then holds
routes that switch pieces to their kernels against the all-plain route
(every op's plain PyTorch version) for the four weight x KV-cache
combinations bf16 + bf16, bf16 + int8, int8 + bf16 and int8 + int8:
  - the tower with a plain decoder: K3 (the images' normalize), K2 (the
    L/14-336 attention), K6 (the fused int8 MLP; int8 weights) alone;
  - the decoder on the plain route's image embeds: K10 and K11 together,
    K10 alone, K11 alone;
  - every kernel (phase 4e's kernel route);
  - two controls, plain routes that differ from the plain route only in
    rounding: the tower's attention, and the decoder's, in f64 (logits,
    softmax and P.V; the probabilities still rounded to bf16 and the
    outputs to their types). What such a route moves is what any other
    order of the same sums would move: the floor a kernel is held to.
A row gives the image embeds' and the prefill logits' largest difference
from the plain route's, and what the plain route finds when it is fed the
row's 32 greedy tokens a row: how far a fed token lies below its best
logit at most (the gap) and at how many of the 256 steps it picks the fed
token (the agreement). Then, for K2 alone and the tower's control, at blocks
0, 11 and 22 of the bf16 and the int8 tower: the block output's largest
difference from the plain route's and, in the int8 tower, the share of
the codes of the block's two row quantizations (of its LayerNorms'
outputs) that differ.
One line a row, a JSON line of all of them, then the card's name and
power limit.
"""

import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(ROOT, "mmrs_tpu_torch", "_build", "probe",
                      "verifier_inputs.pt")
STEPS = 32
BLOCKS = (0, 11, 22)


def load_smoke():
    """This checkout's chip_smoke.py (its greedy trace and data makers),
    whatever package --tree puts first."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pack_inputs(sm, model, dev):
    """(uint8 images [8, 336, 336, 3], pre ids, post ids) of phase 4e's
    first pack, made here and saved to INPUTS for the --tree runs."""
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.io.images import load_image
    from mmrs_tpu_torch.models.sentencepiece import SentencePieceBPE

    with tempfile.TemporaryDirectory() as tmp:
        paths = sm.synthetic_jpegs(os.path.join(tmp, "folder"),
                                   sm.LLAVA_IMAGES, sm.SEED)
        tok_path = os.path.join(tmp, "tokenizer.model")
        sm.tiny_sentencepiece(tok_path)
        tok = SentencePieceBPE.from_file(tok_path)
        v = LLaVAVerifier(model, model.cfg, tok, max_new_tokens=STEPS,
                          prefill_chunk=64, device=dev)
        u8 = torch.from_numpy(np.stack([
            np.array(load_image(p, size=v.image_size, stack="hf").pixels)
            for p in paths[:sm.VERIFY_BATCH]]))
    pre_ids, post_ids = v._prompt_ids(v.prompt_template.format(
        category="cat"))
    pre, post = v._ids(pre_ids, sm.VERIFY_BATCH), v._ids(post_ids,
                                                         sm.VERIFY_BATCH)
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save({"u8": u8, "pre": pre.cpu(), "post": post.cpu()}, INPUTS)
    return u8.to(dev), pre, post


class patched:
    """Inside the block, module.name is make(the original); a patched
    holds any number of such (module, name, make) and can be entered
    again."""

    def __init__(self, *patches):
        self.patches = patches

    def __enter__(self):
        self.saved = []
        for module, name, make in self.patches:
            self.saved.append((module, name, getattr(module, name)))
            setattr(module, name, make(self.saved[-1][2]))

    def __exit__(self, *exc):
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)


def plain_only(orig):
    """orig, run as its plain version whatever impl its caller passes."""
    return lambda *args, **kw: orig(*args, **{**kw, "impl": "torch"})


def kernel_only(orig):
    """orig, run on its kernel whatever impl its caller passes."""
    return lambda *args, **kw: orig(*args, **{**kw, "impl": "auto"})


def mha_f64(q, k, v, heads, impl="auto"):
    """The tower's attention (ops/attention's plain math) in f64: q, k, v
    [B, T, W] with 1/sqrt(hd) in q; p rounded to v's type, out to q's."""
    b, t, w = q.shape

    def split(x):
        return x.reshape(b, t, heads, w // heads).transpose(1, 2).double()

    p = torch.softmax(split(q) @ split(k).transpose(-1, -2), dim=-1)
    out = p.to(v.dtype).double() @ split(v)
    return out.transpose(1, 2).reshape(b, t, w).to(q.dtype)


def cache_attention_f64(q, k_cache, k_scales, v_cache, v_scales, pos,
                        kv_limit=None, impl="auto", plan_pairs=None):
    """K10's and K11's plain math (ops/decode_attention) in f64: q [B,
    KVH, G, HD] (a decode step) or [B, KVH, G, C, HD] (a chunk at pos);
    the probabilities rounded to bf16, the output f32."""
    step = q.dim() == 4
    if step:
        q = q[:, :, :, None]
    if kv_limit is not None:
        k_cache, v_cache = k_cache[:, :, :kv_limit], v_cache[:, :, :kv_limit]
        if k_scales is not None:
            k_scales = k_scales[:, :, :kv_limit]
            v_scales = v_scales[:, :, :kv_limit]
    b, t, hd = q.shape[0], q.shape[3], q.shape[-1]
    s = k_cache.shape[2]
    start = (pos.to(q.device).long().reshape(b, 1)
             if isinstance(pos, torch.Tensor) else torch.full(
                 (b, 1), int(pos), device=q.device))
    q_pos = start + torch.arange(t, device=q.device)
    k = k_cache.to(torch.bfloat16).double()[:, :, None]
    v = v_cache.to(torch.bfloat16).double()[:, :, None]
    logits = q.to(torch.bfloat16).double() @ k.transpose(-1, -2)
    if k_scales is not None:
        logits = logits * k_scales.double()[:, :, None, None, :]
    logits = logits * float(np.float32(1.0 / float(hd) ** 0.5))
    mask = torch.arange(s, device=q.device) <= q_pos[:, :, None]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    if v_scales is not None:
        p = p * v_scales.double()[:, :, None, None, :]
    out = (p.to(torch.bfloat16).double() @ v).float()
    return out[:, :, :, 0] if step else out


def block_taps(model, route):
    """route() with forward hooks on the tower's blocks BLOCKS: {block:
    (ln1 out, ln2 out, block out)}."""
    taps, hooks = {}, []
    for i in BLOCKS:
        blk = model.visual.blocks[i]
        got = taps.setdefault(i, [None, None, None])
        for j, mod in enumerate((blk.ln1, blk.ln2, blk)):
            def hook(_m, _a, out, got=got, j=j):
                got[j] = out.detach().clone()
            hooks.append(mod.register_forward_hook(hook))
    try:
        route()
    finally:
        for h in hooks:
            h.remove()
    return taps


def probe(sm, dev, out_rows, saved: bool = False):
    from mmrs_tpu_torch.models import layers, llama, llava
    from mmrs_tpu_torch.models.configs import VIT_L14_336
    from mmrs_tpu_torch.models.llama import LLAMA2_7B
    from mmrs_tpu_torch.models.quantize import quantize_llava
    from mmrs_tpu_torch.ops.int8 import quantize_act
    from mmrs_tpu_torch.ops.preprocess import normalize_images

    bf16 = torch.bfloat16
    cfg = llava.LLaVAConfig(vision=VIT_L14_336, lm=LLAMA2_7B)
    model = llava.LLaVA(cfg, torch.Generator(device=dev).manual_seed(
        sm.SEED), device=dev, dtype=bf16).requires_grad_(False)
    if saved:
        saved = torch.load(INPUTS)
        u8, pre, post = (saved[k].to(dev) for k in ("u8", "pre", "post"))
    else:
        u8, pre, post = pack_inputs(sm, model, dev)
    img_k = normalize_images(u8, dtype=bf16)
    img_p = normalize_images(u8, dtype=bf16, impl="torch")

    def embeds(img, impl, *kernels):
        """The image embeds with the tower on `impl`, and the layers'
        functions named in `kernels` on their kernels all the same."""
        with torch.inference_mode(), patched(
                *((layers, name, kernel_only) for name in kernels)):
            e = llava.encode_images(model, img, bf16, impl)
            return llava.build_multimodal_embeds(model, pre, e, post, bf16)

    def trace(emb, kv, attn, forced=None):
        with torch.inference_mode():
            return sm.greedy_trace(model.lm, emb, kv, attn, STEPS,
                                   forced=forced)

    amp = []
    for weights in ("bf16", "int8"):
        if weights == "int8":
            quantize_llava(model)
        e_p = embeds(img_p, "torch")
        towers = {"K3": embeds(img_k, "torch"),
                  "K2": embeds(img_p, "torch", "mha_short_seq"),
                  "all": embeds(img_k, "auto")}
        with patched((layers, "mha_short_seq", lambda _: mha_f64)):
            towers["f64"] = embeds(img_p, "torch")
        if weights == "int8":
            towers["K6"] = embeds(img_p, "torch", "mlp_int8_fused")
        rows = [("K3", towers["K3"], "torch", patched()),
                ("K2", towers["K2"], "torch", patched())]
        if weights == "int8":
            rows.append(("K6", towers["K6"], "torch", patched()))
        rows += [("control: tower attention in f64", towers["f64"], "torch",
                  patched()),
                 ("K10+K11", e_p, "auto", patched()),
                 ("K10", e_p, "auto", patched(
                     (llama, "decode_attention", plain_only))),
                 ("K11", e_p, "auto", patched(
                     (llama, "chunk_attention", plain_only))),
                 ("all", towers["all"], "auto", patched()),
                 ("control: decoder attention in f64", e_p, "torch", patched(
                     (llama, "chunk_attention", lambda _: cache_attention_f64),
                     (llama, "decode_attention",
                      lambda _: cache_attention_f64)))]
        for kv in (None, torch.int8):
            combo = f"{weights} weights + {'int8' if kv else 'bf16'} KV"
            t0 = time.perf_counter()
            lp, tp, mp, _ = trace(e_p, kv, "torch")
            for piece, emb, attn, ctx in rows:
                emb_d = float((emb.float() - e_p.float()).abs().max())
                if attn == "torch" and emb_d == 0.0 and \
                        not ctx.patches:
                    # the plain route itself: nothing to trace
                    logit_d, gap, same = 0.0, 0.0, tp.numel()
                else:
                    with ctx:
                        lr, tr, _, _ = trace(emb, kv, attn)
                    _, tf, _, gaps = trace(e_p, kv, "torch", forced=tr)
                    logit_d = float((lr - lp).abs().max())
                    gap, same = float(gaps.max()), int((tf == tr).sum())
                row = {"combo": combo, "piece": piece, "embeds_d": emb_d,
                       "logits_d": logit_d, "gap": gap, "same": same,
                       "steps": tp.numel()}
                out_rows.append(row)
                print(f"probe {combo}, {piece}: image embeds max|d| "
                      f"{emb_d:.4f}, prefill logits max|d| {logit_d:.4f}, "
                      f"gap {gap:.4f}, same token at {same} of {tp.numel()} "
                      f"steps", flush=True)
            print(f"probe {combo}: plain route's median top-2 margin "
                  f"{float(mp.median()):.4f}; {time.perf_counter() - t0:.1f} "
                  f"s", flush=True)
        # K2 alone and the f64 control, block by block
        plain = block_taps(model, lambda: embeds(img_p, "torch"))
        routes = {"K2": block_taps(model, lambda: embeds(
            img_p, "torch", "mha_short_seq"))}
        with patched((layers, "mha_short_seq", lambda _: mha_f64)):
            routes["f64"] = block_taps(model, lambda: embeds(img_p, "torch"))
        for name, taps in routes.items():
            for i in BLOCKS:
                d = float((taps[i][2].float() - plain[i][2].float()).abs()
                          .max())
                row = {"weights": weights, "route": name, "block": i,
                       "out_d": d}
                msg = (f"probe tower attention {name}, {weights} tower "
                       f"block {i}: output max|d| {d:.4f}")
                if weights == "int8":
                    moved = [float((quantize_act(a)[0] != quantize_act(b)[0])
                                   .float().mean())
                             for a, b in zip(taps[i][:2], plain[i][:2])]
                    row["codes_moved"] = moved
                    msg += (f", int8 codes moved: ln1 {moved[0]:.2e}, ln2 "
                            f"{moved[1]:.2e}")
                amp.append(row)
                print(msg, flush=True)
    return amp


def main(argv) -> int:
    if "--tree" in argv:
        tree = os.path.abspath(argv[argv.index("--tree") + 1])
        if not os.path.exists(INPUTS):
            print(f"no {INPUTS}: run the probe without --tree first")
            return 2
    else:
        tree = ROOT
    sys.path.insert(0, tree)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    sm = load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rows = []
    amp = probe(sm, dev, rows, saved=tree != ROOT)
    print(json.dumps({"tree": tree, "rows": rows, "k2_blocks": amp,
                      "seconds": time.perf_counter() - t0}))
    print(sm.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
