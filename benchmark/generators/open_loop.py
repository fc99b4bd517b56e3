"""Open-loop text search traffic against `serve.SearchService`.

Requests are due on a Poisson schedule at the mix's fixed rate, whatever
the system's state; a pool of sender threads sends each one when it is
due, as independent users would, through
`SearchService.search_texts([text], k)`: the micro-batched device worker
that `mmrs-torch serve` runs, without HTTP. A request's latency runs from
when it was due to its answer, so a stall counts against every request it
delays; how late the senders ran is reported beside it.

Each query is a text drawn from a pool made from the seed. The gallery is
clustered and holds, for every pool text, rows planted at seeded places
near its reference embedding, from near to far, so that every query has
answers to find.

Traffic parameters: min_units / max_units / length_tail (query lengths
in words, or in characters for a WordPiece tower), pool_texts, rate_qps,
k, logit_scale, senders, max_batch and batch_window (the service's, as
`serve`'s defaults), planted (rows a pool text), sample_requests
(answers held against the reference), reference_block, idle_label.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import List

import numpy as np
import torch

from benchmark import data, system, weights
from benchmark.reference import no_tf32, scan, tokenizers
from mmrs_tpu_torch.config import SearchConfig
from mmrs_tpu_torch.index.gallery import GalleryIndex
from mmrs_tpu_torch.search.engine import SearchEngine
from mmrs_tpu_torch.serve import SearchService


def vocabulary(cfg):
    """(vocabulary for the tokenizers, the units texts are made of, the
    separator between units)."""
    spec = cfg["text_tower"]
    if spec["kind"] == "clip_text":
        merges, words = data.clip_merges(spec["vocab_size"] - 514)
        return merges, words, " "
    vocab, chars = data.wordpiece_vocab(spec["vocab_size"])
    return vocab, chars, ""


def reference_tokenizer(cfg, vocab):
    spec = cfg["text_tower"]
    if spec["kind"] == "clip_text":
        return tokenizers.ClipBpe(vocab, spec["context_length"])
    return tokenizers.WordPiece(vocab, spec["max_length"])


def reference_embed(cfg, w, tok, texts: List[str], device, block: int,
                    int8: bool = False) -> torch.Tensor:
    """The reference text tower's L2-normalized embeddings, in blocks of
    texts cut to the block's longest row."""
    import importlib

    spec = cfg["text_tower"]
    ref = importlib.import_module(f"benchmark.reference.{spec['kind']}")
    out = []
    for a in range(0, len(texts), block):
        ids, mask = tok(texts[a:a + block])
        t = int(mask.sum(1).max())
        if spec["kind"] == "clip_text":
            t = ids.shape[1]
        ids = torch.from_numpy(ids[:, :t]).to(device)
        mask = torch.from_numpy(mask[:, :t]).to(device)
        out.append(ref.encode(w, spec, ids, mask, int8=int8))
    return torch.cat(out)


def setup(run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    run.mark("imports")
    vocab, units, sep = vocabulary(cfg)
    run.ref_tok = reference_tokenizer(cfg, vocab)
    run.weights = weights.make(cfg, run.seed, dev)
    run.towers = system.towers(cfg, run.weights, system.tokenizer(cfg, vocab),
                               dev)
    run.mark("vocabularies and towers")
    run.texts = data.texts(tr["pool_texts"], units, tr["min_units"],
                           tr["max_units"], tr["length_tail"], sep, run.seed)
    run.tokens = dict(zip(run.texts, run.ref_tok(run.texts)[1].sum(1)))
    no_tf32()
    with torch.inference_mode():
        anchors = reference_embed(cfg, run.weights, run.ref_tok, run.texts,
                                  dev, tr["reference_block"])
    g = cfg["gallery"]
    run.gallery, run.planted = data.gallery(
        g["rows"], g["dim"], g["clusters"], g["spread"], anchors,
        tr["planted"], run.seed, dev)
    del anchors
    run.mark("texts, anchors and gallery")
    index = GalleryIndex(embeddings=run.gallery,
                         paths=data.RowNames(g["rows"]),
                         classes=data.RowNames(g["rows"], "gallery"))
    run.engine = SearchEngine(index, SearchConfig(
        top_k=tr["k"], logit_scale=tr["logit_scale"]), device=dev)
    run.mark("engine")
    for n in range(tr["max_batch"], 0, -1):     # every dispatch size
        run.engine.query_text(run.towers.text_encode(run.texts[:n]),
                              top_k=tr["k"])
    # the tokenizer's per-word cache holds the pool's words, as a server's
    # does for the words its users send
    run.towers.tokenizer(run.texts)
    run.mark("warm-up")
    run.towers.text_encode = run.spans.wrap(
        "text_encode", run.towers.text_encode,
        lambda texts: [int(run.tokens[t]) for t in texts])
    run.engine.query_text = run.spans.wrap(
        "query", run.engine.query_text, lambda vecs, *a, **k: len(vecs))
    run.service = SearchService(run.engine, run.towers,
                                max_batch=tr["max_batch"],
                                batch_window=tr["batch_window"])
    run.service.search_texts([run.texts[0]], tr["k"])   # start its worker
    run.spans.records.clear()
    run.stats0 = run.service.stats.as_dict()


def window(run) -> None:
    tr = run.traffic
    due = data.arrivals(tr["rate_qps"], run.seconds, run.seed)
    n, k = len(due), tr["k"]
    pick = data.rng(run.seed + 1).permutation(
        np.resize(np.arange(len(run.texts)), n))
    run.requests = pick
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    # answers kept as arrays, so that the window leaves no Python objects
    # behind for the collector to scan: rows (-1: no hit), scores as served
    rows = np.full((n, k), -1, np.int64)
    scores = np.zeros((n, k), np.float32)
    errors: list = []
    todo: "queue.SimpleQueue" = queue.SimpleQueue()
    service = run.service

    def sender():
        while True:
            j = todo.get()
            if j is None:
                return
            sent[j] = time.perf_counter()
            try:
                hits = service.search_texts([run.texts[pick[j]]], k)[0]
                done[j] = time.perf_counter()
                for h in hits[:k]:
                    rows[j, h["rank"]] = int(h["path"][1:])
                    scores[j, h["rank"]] = h["score"]
            except Exception as e:  # noqa: BLE001 - a failed request
                errors.append(repr(e))

    threads = [threading.Thread(target=sender, daemon=True,
                                name=f"bench-sender-{i}")
               for i in range(tr["senders"])]
    for t in threads:
        t.start()
    start = run.start_window()
    for j in range(n):
        run.tick()
        wait = start + due[j] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put(j)
    for _ in threads:
        todo.put(None)
    limit = time.perf_counter() + 60.0      # late answers count as late
    for t in threads:
        t.join(max(0.0, limit - time.perf_counter()))
    run.elapsed = time.perf_counter() - start
    # an unanswered request waited to the end
    run.latency = np.where(np.isnan(done), start + run.elapsed, done) \
        - (start + due)
    run.lag = sent - (start + due)
    run.answered = ~np.isnan(done)
    run.rows, run.scores = rows, scores / tr["logit_scale"]
    for e in errors[:3]:
        print(f"a request failed: {e}", file=sys.stderr)
    run.attempted = n
    run.failed = int(n - run.answered.sum())
    run.items = n - run.failed
    run.stats1 = run.service.stats.as_dict()


def release(run) -> None:
    run.service.close()
    run.service = run.engine = run.towers = run.weights = None
    system.free_device()


def sample(run) -> np.ndarray:
    """Requests held against the reference: a seeded sample of the
    answered ones, with the longest queries among them."""
    answered = np.flatnonzero(run.answered)
    longest = sorted(answered, key=lambda j: -len(run.texts[
        run.requests[j]]))[:8]
    take = min(run.traffic["sample_requests"], len(answered))
    picked = data.rng(run.seed + 2).choice(answered, take, replace=False)
    return np.unique(np.concatenate([picked, longest]).astype(int))


def compare(run, queries: torch.Tensor, rows: np.ndarray, scores: np.ndarray):
    """The numbers compared for a set of answers: (bad answers, widest
    score gap, widest rank gap) against the reference's query embeddings
    and exact top-k over the same gallery."""
    k = run.traffic["k"]
    bad = int(sum((r < 0).any() or len(set(r.tolist())) < k for r in rows))
    safe = np.where(rows < 0, 0, rows)
    ref_of_rows = scan.scores_of(queries, run.gallery, safe).cpu().numpy()
    best, _ = scan.topk(queries, run.gallery, k)
    best = best.cpu().numpy()
    score_gap = float(np.abs(scores - ref_of_rows).max())
    rank_gap = float(np.maximum(best - ref_of_rows, 0).max())
    return bad, score_gap, rank_gap


def check(run):
    """Unanswered requests; among a sample of the answered: answers that
    are not k distinct rows, the widest gap between a served score and the
    reference's cosine of that row, and the widest gap between the
    reference's j-th best cosine and the cosine of the j-th row served."""
    reqs = sample(run)
    rows, scores = run.rows[reqs], run.scores[reqs]
    no_tf32()
    w = weights.make(run.cfg, run.seed, run.device)
    texts = [run.texts[run.requests[j]] for j in reqs]
    block = run.traffic["reference_block"]
    with torch.inference_mode():
        q = reference_embed(run.cfg, w, run.ref_tok, texts, run.device, block)
        if run.control:
            # the control: the reference in the system's place, its text
            # tower and scan on int8 codes
            qc = reference_embed(run.cfg, w, run.ref_tok, texts, run.device,
                                 block, int8=True)
            v, i = scan.topk(qc, run.gallery, run.traffic["k"], int8=True)
            rows, scores = i.cpu().numpy(), v.cpu().numpy()
        bad, score_gap, rank_gap = compare(run, q, rows, scores)
    return [("unanswered", float(run.failed)), ("bad_answers", float(bad)),
            ("score_gap", score_gap), ("rank_gap", rank_gap)]
