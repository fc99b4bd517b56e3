"""Cascade verifier traffic: packs of gate survivors through the VLM verifier.

The window drives the verifier as `CascadePipeline.run_streaming`
(`cascade/pipeline.py`) dispatches survivors: packs of `verify_batch`
image files through `verify_batch_async(paths, category,
fixed_batch=verify_batch)`, at most `pipeline_depth` packs in flight, the
oldest collected (`collect`: fetched and parsed) once more are queued; a
closed loop, pack after pack until the window ends, then the packs in
flight are collected. The rate counts every answered image over the
whole time, the last collect included. Each pack asks one category,
drawn with the seed from the traffic's list (every category once in each
cycle, in a seeded order); its images are a seeded run of the pool's
files, lossless PNGs written under TMPDIR in set-up and decoded by the
verifier itself.

The configuration names its verifier's kind; the kind's plain reference
(`reference/<kind>.py`: `weight_shapes`, `prompt_ids`, `logits`) and
its builder (`builders/<kind>.py`: `build`, `replay`) are found by that
name under the benchmark's root, so a new verifier joins with those two
files, a configuration and entries.

Traffic parameters: verify_batch, pipeline_depth, pool_images, png_level,
max_new_tokens, early_stop, question (with {category}), categories,
sample_packs (packs held against the reference), sample_rows (rows of
each sampled pack the reference runs), idle_label.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import data, system, vlm, weights
from benchmark.reference import no_tf32
from benchmark.reference.sentencepiece import SentencePieceBpe
from benchmark.run import load_module

CYCLES = 64     # category cycles drawn; packs past them repeat the order


def kind_module(run, folder: str):
    """benchmark/<folder>/<kind>.py under the run's benchmark root."""
    kind = run.cfg["verifier"]["kind"]
    return load_module(os.path.join(run.manifest.bench, folder, f"{kind}.py"),
                       f"benchmark.{folder}.{kind}")


def prompt_lengths(run) -> Dict[str, int]:
    """Sequence length of each category's prompt (text and image tokens),
    by the reference's tokenizer."""
    tok = SentencePieceBpe(run.vocab)
    image = run.cfg["verifier"]["image_tokens"]
    out = {}
    for cat in run.traffic["categories"]:
        pre, post = run.ref.prompt_ids(
            run.cfg, tok, run.traffic["question"].format(category=cat))
        out[cat] = len(pre) + image + len(post)
    return out


def pack(run, i: int) -> Tuple[List[int], str]:
    """Pool images and category of the window's pack i."""
    b = run.traffic["verify_batch"]
    a = (i * b) % len(run.order)
    return (run.order[a:a + b].tolist(),
            run.traffic["categories"][run.cats[i % len(run.cats)]])


def setup(run) -> None:
    cfg, tr = run.cfg, run.traffic
    run.ref = kind_module(run, "reference")
    run.builder = kind_module(run, "builders")
    run.mark("imports")
    if tr["pool_images"] < tr["verify_batch"]:
        raise ValueError(f"packs of {tr['verify_batch']} need a pool of as "
                         f"many images, not {tr['pool_images']}")
    lm = cfg["language_model"]
    run.vocab = vlm.sentencepiece_vocab(
        lm["vocab_size"], [cfg["verifier"]["conversation"]["system"],
                           tr["question"]] + tr["categories"])
    run.lengths = prompt_lengths(run)
    longest = max(run.lengths.values()) + tr["max_new_tokens"]
    if longest > lm["sliding_window"]:
        raise ValueError(f"{longest} positions reach the sliding window "
                         f"({lm['sliding_window']}), which the reference "
                         f"does not apply")
    w = weights.draw(run.ref.weight_shapes(cfg), run.seed, run.device)
    run.verifier = run.builder.build(cfg, tr, w, run.vocab, run.device,
                                     control=run.control)
    del w
    run.mark("verifier")
    size = cfg["vision_tower"]["image_size"]
    run.pool = data.image_pool(tr["pool_images"], size, run.seed, run.device)
    folder = tempfile.mkdtemp(prefix="bench-verify-")
    run.cleanup.append(folder)
    run.paths = vlm.write_pngs(run.pool, folder, tr["png_level"])
    run.mark("images")
    b = tr["verify_batch"]
    run.order = data.stream_ids(tr["pool_images"], b, run.seed)
    r = data.rng(run.seed)
    n_cat = len(tr["categories"])
    run.cats = np.concatenate([r.permutation(n_cat) for _ in range(CYCLES)])
    # every shape of the window: one pack at each prompt length
    warmed = set()
    for cat in tr["categories"]:
        if run.lengths[cat] not in warmed:
            warmed.add(run.lengths[cat])
            paths = [run.paths[j] for j in run.order[:b]]
            run.verifier.collect(run.verifier.verify_batch_async(
                paths, cat, fixed_batch=b))
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.mark("warm-up")


def window(run) -> None:
    tr, v = run.traffic, run.verifier
    b, depth = tr["verify_batch"], tr["pipeline_depth"]
    # the benchmark's spans around the verifier's calls (breakdown labels)
    v._load_image = run.spans.wrap("load_image", v._load_image)
    v._generate = run.spans.wrap("generate", v._generate)
    dispatch = run.spans.wrap("verify_batch_async", v.verify_batch_async)
    collect = run.spans.wrap("collect", v.collect)
    run.tokens: Dict[int, torch.Tensor] = {}
    run.prompts: List[int] = []
    in_flight: List[Tuple[int, tuple]] = []

    def drain_one() -> None:
        i, handle = in_flight.pop(0)
        answers = collect(handle)
        run.items += len(answers)
        run.tokens[i] = handle[0]
        run.prompts.append(run.lengths[pack(run, i)[1]])

    start = run.start_window()
    deadline = start + run.seconds
    i = 0
    while time.perf_counter() < deadline:
        run.tick()
        ids, cat = pack(run, i)
        handle = dispatch([run.paths[j] for j in ids], cat, fixed_batch=b)
        in_flight.append((i, handle))
        run.attempted += len(ids)
        i += 1
        while len(in_flight) > depth:
            drain_one()
    while in_flight:
        drain_one()
    run.elapsed = time.perf_counter() - start
    run.packs = i


def release(run) -> None:
    """Pick the rows held against the reference (seeded rows of the first
    pack, the last, the first with the longest prompt and seeded others),
    have the port replay those packs at their timed size for the logits
    of their answers, then free the system."""
    tr = run.traffic
    b = tr["verify_batch"]
    done = sorted(run.tokens)
    longest = max(done, key=lambda i: run.lengths[pack(run, i)[1]])
    packs = {done[0], done[-1], longest}
    r = data.rng(run.seed + 1)
    rest = [i for i in done if i not in packs]
    packs |= set(r.choice(rest, size=min(max(tr["sample_packs"] - len(packs),
                                             0), len(rest)),
                          replace=False).tolist())
    run.sample = {i: np.sort(r.choice(b, min(tr["sample_rows"], b),
                                      replace=False)) for i in sorted(packs)}
    run.port_logits = {}
    for i, rows in run.sample.items():
        ids, cat = pack(run, i)
        tokens = run.tokens[i].cpu()
        run.tokens[i] = tokens[rows]
        run.port_logits[i] = run.builder.replay(
            run.verifier, [run.paths[j] for j in ids], cat,
            tokens)[rows].cpu()
    run.verifier = None
    system.free_device()


def answer_gaps(ref: torch.Tensor, tokens: torch.Tensor, eos: int
                ) -> torch.Tensor:
    """Per answer token, how far its logit lies below the reference's best
    ([B, n]; 0 where it is the reference's argmax). Positions after a
    row's end of sequence hold padding and read 0."""
    served = ref.gather(-1, tokens.long()[..., None])[..., 0]
    gaps = ref.max(-1).values - served
    ended = torch.zeros_like(tokens, dtype=torch.bool)
    ended[:, 1:] = (tokens[:, :-1] == eos).cumsum(1) > 0
    return gaps.masked_fill(ended, 0.0)


def check(run):
    """Over the sampled rows, against the float32 reference (TF32 off,
    weights made again from the seed) run over each prompt with the
    tokens the timed path answered: rows lost (dispatched and never
    answered); the widest gap by which an answered token's logit lies
    below the reference's best; and the 90th percentile of the relative
    L2 gap between the logits the port took each token from and the
    reference's."""
    cfg, tr = run.cfg, run.traffic
    run.failed = run.attempted - run.items
    no_tf32()
    w = weights.draw(run.ref.weight_shapes(cfg), run.seed, run.device)
    tok = SentencePieceBpe(run.vocab)
    eos = cfg["language_model"]["eos_token_id"]
    widest, rel = 0.0, []
    for i, rows in run.sample.items():
        ids, cat = pack(run, i)
        pre, post = run.ref.prompt_ids(
            cfg, tok, tr["question"].format(category=cat))
        images = torch.from_numpy(run.pool[np.asarray(ids)[rows]]).to(
            run.device)
        tokens = run.tokens[i]
        ref = run.ref.logits(w, cfg, images, pre, post, tokens).cpu()
        widest = max(widest, float(answer_gaps(ref, tokens, eos).max()))
        port = run.port_logits[i]
        rel.append(((port - ref).norm(dim=-1)
                    / ref.norm(dim=-1)).reshape(-1))
    p90 = float(torch.quantile(torch.cat(rel), 0.9)) if rel else 0.0
    return [("rows_lost", float(run.failed)),
            ("token_gap_max", widest), ("logit_gap_p90", p90)]
