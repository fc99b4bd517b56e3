#!/usr/bin/env python3
"""Drive the PyTorch port's search main path once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each printed on its own line; any failure ends the run with a
nonzero exit and no result line:
  1. environment: torch/CUDA versions, the card's name and power limit;
     whether PIL, yaml and regex import here;
  2. build: the CUDA kernels (nvcc, sm_90a) and the Triton kernel, from
     the sources in mmrs_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at main-path shapes;
  4. end to end through the port's public path at ViT-B/32 width (random
     weights from a seed): build_towers -> build_index over 4096 seeded
     synthetic images -> SearchEngine image / prototype / text queries ->
     sweep_class; then a 1,048,576 x 512 gallery queried at Q=8;
  5. launch counts: every kernel ran during phase 4;
  6. times (CUDA events, after warm-up), kernel and plain version in turns.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEED = 0
GALLERY_ROWS = 1 << 20        # 1M x 512 bf16: 1 GiB resident
DIM = 512                     # ViT-B/32 embed_dim
EMBED_BATCH = 224             # serving batch for the embed throughput
SMOKE_IMAGES = 4096
SMOKE_CLASSES = 8


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_pair(kernel_fn, plain_fn, iters: int = 10, warmup: int = 3):
    """(kernel ms, plain ms) per call: CUDA events over `iters` calls after
    `warmup`, in the order plain, kernel, kernel, plain."""
    def one(fn):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    p1, k1, k2, p2 = one(plain_fn), one(kernel_fn), one(kernel_fn), \
        one(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def launched(kernels, call, what: str):
    """call(), checking that it launched every one of `kernels`."""
    before = [fn.launches for fn in kernels]
    out = call()
    for fn, n in zip(kernels, before):
        check(fn.launches > n, f"{what} did not launch {fn.__name__}")
    return out


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in units of b's bf16 spacing (8 significand bits)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(b)
    ulp = torch.ldexp(torch.ones_like(b), e - 8).clamp_min(2.0 ** -133)
    return float(((a - b).abs() / ulp).max())


def topk_agree(vals, ids, ref_vals, ref_ids, tol: float = 1e-3,
               gap: float = 1e-4) -> float:
    """Values within `tol`; ids equal wherever the reference's neighbours
    (ref has k+1 columns) are more than `gap` apart. Returns max |dv|."""
    k = vals.shape[1]
    err = float((vals - ref_vals[:, :k]).abs().max())
    check(err <= tol, f"top-k values differ by {err}")
    rv = ref_vals.double()
    left = torch.cat([torch.full_like(rv[:, :1], float("inf")),
                      rv[:, :-1] - rv[:, 1:]], dim=1)[:, :k]
    right = (rv[:, :-1] - rv[:, 1:])[:, :k]
    clear = (left > gap) & (right > gap)
    bad = clear & (ids != ref_ids[:, :k])
    check(not bool(bad.any()),
          f"top-k ids differ at {int(bad.sum())} well-separated places")
    return err


@dataclasses.dataclass
class SyntheticImages:
    """FolderDataset's batches() interface over seeded in-memory images:
    an image is its class's coarse pattern, its own coarse pattern and
    fine noise. No files and no PIL."""

    samples: list
    seed: int = SEED
    image_size: int = 224
    stack: str = "openai"
    num_workers: int = 0

    def image(self, name: str, cls: str) -> np.ndarray:
        s = self.image_size

        def coarse(*key):
            g = np.random.default_rng([self.seed, *key])
            cells = g.uniform(0, 255, (7, 7, 3))
            return np.repeat(np.repeat(cells, s // 7 + 1, 0), s // 7 + 1,
                             1)[:s, :s]

        idx = int(name.rsplit("/", 1)[1])
        noise = np.random.default_rng([self.seed, 1, idx]).uniform(
            -12, 12, (s, s, 3))
        img = 0.6 * coarse(0, int(cls[1:])) + 0.4 * coarse(2, idx) + noise
        return np.clip(img, 0, 255).astype(np.uint8)

    def batches(self, batch_size: int):
        from mmrs_tpu_torch.io.dataset import Batch

        for a in range(0, len(self.samples), batch_size):
            chunk = self.samples[a:a + batch_size]
            yield Batch(pixels=np.stack([self.image(*s) for s in chunk]),
                        labels=[c for _, c in chunk],
                        paths=[p for p, _ in chunk],
                        ok=np.ones(len(chunk), bool))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmrs_tpu_torch.config import Config, ModelConfig, SearchConfig
    from mmrs_tpu_torch.index.gallery import GalleryIndex, build_index
    from mmrs_tpu_torch.models import clip
    from mmrs_tpu_torch.ops import _cuda
    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.normalize import l2_normalize
    from mmrs_tpu_torch.ops.preprocess import normalize_images
    from mmrs_tpu_torch.ops.topk import cosine_topk
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.search import calibrate
    from mmrs_tpu_torch.search.engine import SearchEngine

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card = card_line()

    # ---- 1. environment --------------------------------------------------
    have = {}
    for mod in ("PIL", "yaml", "regex"):
        try:
            importlib.import_module(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    say(f"phase 1 environment: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" imports {json.dumps(have)}")
    say(card)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    nvcc_s = _cuda.build()
    _cuda.library()
    log = _cuda.library_path()[:-3] + ".log"
    if os.path.exists(log):
        with open(log, encoding="utf-8") as f:
            for line in f:
                if "Used" in line or "spill" in line:
                    say("  ptxas:", line.strip())
    t1 = time.perf_counter()
    normalize_images(torch.zeros((1, 224, 224, 3), dtype=torch.uint8,
                                 device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t1
    say(f"phase 2 build: nvcc {nvcc_s:.2f} s (0 = already built), triton "
        f"{triton_s:.2f} s, total {time.perf_counter() - t0:.2f} s")

    # ---- 3. kernels against their plain versions ---------------------------
    errs = {}
    with torch.inference_mode():
        px = torch.randint(0, 256, (EMBED_BATCH, 224, 224, 3), device=dev,
                           dtype=torch.uint8, generator=gen)
        ulps = bf16_ulps(normalize_images(px), normalize_images(px,
                                                                impl="torch"))
        check(ulps <= 1.0, f"normalize_images off by {ulps} bf16 ulp")
        errs["normalize_images"] = float(
            (normalize_images(px).float()
             - normalize_images(px, impl="torch").float()).abs().max())
        say(f"phase 3 K3 normalize_images [224,224,224,3] u8->bf16: max "
            f"{ulps} ulp, max|d| {errs['normalize_images']:.3e}")

        errs["mha_short_seq"] = 0.0
        for b, t, w, h in ((EMBED_BATCH, 50, 768, 12), (32, 257, 1024, 16)):
            q, k, v = (torch.randn((b, t, w), device=dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            q = q * (w // h) ** -0.5
            d = float((mha_short_seq(q, k, v, h).float()
                       - mha_short_seq(q, k, v, h, impl="torch").float())
                      .abs().max())
            check(d <= 2e-2, f"mha_short_seq [{b},{t},{w}]/{h}: max|d| {d}")
            errs["mha_short_seq"] = max(errs["mha_short_seq"], d)
            say(f"phase 3 K2 mha_short_seq [{b},{t},{w}]/{h} bf16: max|d| "
                f"{d:.3e}")

        g = torch.randn((GALLERY_ROWS, DIM), device=dev, generator=gen)
        g = (g / g.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        errs["cosine_topk"] = 0.0
        for nq in (1, 8, 64):
            rows = torch.randint(0, GALLERY_ROWS, (nq,), device=dev,
                                 generator=gen)
            qv = g[rows].float() + 0.05 * torch.randn((nq, DIM), device=dev,
                                                      generator=gen)
            qv = (qv / qv.norm(dim=1, keepdim=True)).to(torch.bfloat16)
            for k in (10, 100):
                vals, ids = cosine_topk(qv, g, k)
                rv, ri = cosine_topk(qv, g, k + 1, impl="torch")
                e = topk_agree(vals, ids, rv, ri)
                check(bool((ids[:, 0] == rows.int()).all()),
                      "top-1 is not the query's source row")
                errs["cosine_topk"] = max(errs["cosine_topk"], e)
                say(f"phase 3 K1 cosine_topk N={GALLERY_ROWS} D={DIM} Q={nq}"
                    f" k={k}: max|dv| {e:.3e}, ids agree")
        tie = torch.randn((1000, DIM), device=dev, generator=gen)
        tie[500] = tie[20]
        tie[900] = tie[20]
        tie = (tie / tie.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        vals, ids = cosine_topk(tie[20:21], tie, 5)
        rv, ri = cosine_topk(tie[20:21], tie, 5, impl="torch")
        check(ids[0, :3].tolist() == [20, 500, 900] and torch.equal(ids, ri),
              f"tie rule: kernel {ids.tolist()} plain {ri.tolist()}")
        say(f"phase 3 K1 tie case: ids {ids[0].tolist()} (lowest row first)")
        del g, px

    # ---- 4. end to end -----------------------------------------------------
    cfg = Config(model=ModelConfig(image_tower="vit_b32", dtype="bfloat16"),
                 seed=SEED)
    towers = build_towers(cfg, device=dev)
    model = towers.params
    for fn in (normalize_images, mha_short_seq, cosine_topk):
        fn.launches = 0
    t0 = time.perf_counter()
    samples = [(f"synthetic/c{i % SMOKE_CLASSES}/{i:05d}",
                f"c{i % SMOKE_CLASSES}") for i in range(SMOKE_IMAGES)]
    ds = SyntheticImages(samples)
    with tempfile.TemporaryDirectory() as tmp:
        idx = launched(
            (normalize_images, mha_short_seq),
            lambda: build_index(ds, towers.image_encode,
                                os.path.join(tmp, "idx"),
                                batch_size=cfg.gallery.batch_size),
            "build_index")
        check(len(idx) == SMOKE_IMAGES and idx.dim == DIM,
              f"index has {len(idx)} rows of dim {idx.dim}")
        check(bool(np.isfinite(idx.embeddings).all()), "non-finite rows")
        engine = SearchEngine(idx, SearchConfig(), device=dev)

        picks = list(range(0, SMOKE_IMAGES, SMOKE_IMAGES // 8))
        qpx = np.stack([ds.image(*samples[i]) for i in picks])
        qvec = launched((normalize_images, mha_short_seq),
                        lambda: towers.image_encode(qpx), "image_encode")
        hits = launched((cosine_topk,),
                        lambda: engine.query_image(qvec, top_k=10),
                        "query_image")
        for i, h in zip(picks, hits):
            check(len(h) == 10 and samples[i][0] in [x.path for x in h[:3]],
                  f"image query {i}: own path not in the top 3")
        self_top1 = sum(h[0].path == samples[i][0]
                        for i, h in zip(picks, hits))
        shots = idx.embeddings[[i for i in range(40) if i % 8 == 0]]
        proto_hits = launched(
            (cosine_topk,), lambda: engine.query_prototype(shots, top_k=10),
            "query_prototype")[0]
        same = sum(h.cls == "c0" for h in proto_hits)

        ids = np.random.default_rng(SEED).integers(1, 49406, (4, 77))
        lengths = [5, 9, 12, 20]
        tokens = np.zeros((4, 77), np.int64)
        for r, n in enumerate(lengths):
            tokens[r, 0] = 49406
            tokens[r, 1:n + 1] = ids[r, :n]
            tokens[r, n + 1] = 49407      # EOT: the max id
        tvec = clip.encode_text(model, torch.from_numpy(tokens).to(dev))
        check(bool(torch.isfinite(tvec).all()), "non-finite text embeds")
        text_hits = launched((cosine_topk,),
                             lambda: engine.query_text(tvec, top_k=10),
                             "query_text")
        check(all(len(h) == 10 and np.isfinite([x.score for x in h]).all()
                  for h in text_hits), "text query hits")

        labels = np.asarray([c == "c0" for c in idx.classes])
        proto = torch.from_numpy(
            np.asarray(idx.embeddings[np.flatnonzero(labels)[:10]])).mean(0)
        res = engine.sweep_class(proto, labels)
        host = calibrate.sweep(
            engine.device_similarities(proto[None])[0].cpu().numpy()
            * engine.config.logit_scale, labels)
        check(0.0 <= res.best_f1 <= 1.0 and np.isfinite(res.best_threshold),
              "sweep_class result")
        check(abs(res.best_threshold - host.best_threshold) <= 1e-3
              and abs(res.best_f1 - host.best_f1) <= 1e-9,
              f"device sweep {res.best_threshold}/{res.best_f1} vs host "
              f"{host.best_threshold}/{host.best_f1}")
    say(f"phase 4 e2e ViT-B/32 bf16: index {len(idx)}x{idx.dim}, image "
        f"self-top1 {self_top1}/8, prototype c0 precision@10 {same}/10, text "
        f"hits ok, calibrate c0 thr {res.best_threshold:.4f} f1 "
        f"{res.best_f1:.4f} (= host sweep), "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    emb = np.empty((GALLERY_ROWS, DIM), np.float16)
    for a in range(0, GALLERY_ROWS, 131072):
        x = rng.standard_normal((min(131072, GALLERY_ROWS - a), DIM),
                                dtype=np.float32)
        emb[a:a + len(x)] = x / np.linalg.norm(x, axis=1, keepdims=True)
    big = GalleryIndex(emb, [f"row/{i}" for i in range(GALLERY_ROWS)],
                       ["c"] * GALLERY_ROWS)
    big_engine = SearchEngine(big, SearchConfig(), device=dev)
    src = np.arange(8) * (GALLERY_ROWS // 9) + 17
    qbig = emb[src].astype(np.float32) + 0.05 * rng.standard_normal(
        (8, DIM), dtype=np.float32)
    big_hits = launched((cosine_topk,),
                        lambda: big_engine.query_vectors(qbig, top_k=10),
                        "1M query_vectors")
    check(all(h[0].path == f"row/{s}" for s, h in zip(src, big_hits)),
          "1M query: top-1 is not the source row")
    say(f"phase 4 e2e 1M x 512 gallery (f16 host -> bf16 device), Q=8: "
        f"top-1 = source row for 8/8, {time.perf_counter() - t0:.1f} s")

    # ---- 5. launch counts --------------------------------------------------
    # read before any comparison below launches a kernel outside the path
    launches = {fn.__name__: fn.launches
                for fn in (cosine_topk, mha_short_seq, normalize_images)}
    say(f"phase 5 launches during phase 4: {json.dumps(launches)}")
    check(all(n > 0 for n in launches.values()), "a kernel never launched")

    # phase 4's answers against the plain versions on the same inputs
    with torch.inference_mode():
        for vec in (qvec, tvec):
            q = l2_normalize(torch.as_tensor(vec, device=dev).float())
            q = q.to(torch.bfloat16)
            vals, kid = cosine_topk(q, engine.gallery, 10)
            rv, ri = cosine_topk(q, engine.gallery, 11, impl="torch")
            topk_agree(vals, kid, rv, ri)
        ref = clip.encode_image(
            model, normalize_images(torch.from_numpy(qpx).to(dev),
                                    impl="torch"), attn_impl="torch")
        cos = float((torch.from_numpy(qvec).to(dev) * ref).sum(1).min())
        check(cos >= 0.999, f"kernel-path embed cosine to plain {cos}")
    say(f"phase 5 checks: engine top-10 = plain top-10 (image, text "
        f"queries); image embed cosine to plain path >= {cos:.6f}")

    # ---- 6. times ----------------------------------------------------------
    times = {}
    with torch.inference_mode():
        px = torch.randint(0, 256, (EMBED_BATCH, 224, 224, 3), device=dev,
                           dtype=torch.uint8, generator=gen)
        times["normalize_images"] = time_pair(
            lambda: normalize_images(px),
            lambda: normalize_images(px, impl="torch"), iters=20)
        q, k, v = (torch.randn((EMBED_BATCH, 50, 768), device=dev,
                               generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        times["mha_short_seq"] = time_pair(
            lambda: mha_short_seq(q, k, v, 12),
            lambda: mha_short_seq(q, k, v, 12, impl="torch"), iters=20)
        qb = big_engine.gallery[torch.arange(8, device=dev) * 997]
        times["cosine_topk"] = time_pair(
            lambda: cosine_topk(qb, big_engine.gallery, 10),
            lambda: cosine_topk(qb, big_engine.gallery, 10, impl="torch"))
        embed_ms, embed_plain_ms = time_pair(
            lambda: towers.encode_fn(px),
            lambda: clip.encode_image(
                model, normalize_images(px, impl="torch"),
                attn_impl="torch"), iters=5, warmup=2)
    say(f"phase 6 times on {card}:")
    for name, (kms, pms) in times.items():
        say(f"  {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms")
    say(f"  ViT-B/32 embed batch {EMBED_BATCH}: kernels "
        f"{EMBED_BATCH / embed_ms * 1e3:.1f} img/s ({embed_ms:.3f} ms), "
        f"plain {EMBED_BATCH / embed_plain_ms * 1e3:.1f} img/s "
        f"({embed_plain_ms:.3f} ms)")
    say(f"  top-10 over {GALLERY_ROWS}x{DIM} bf16 at Q=8: kernel "
        f"{times['cosine_topk'][0]:.4f} ms, plain "
        f"{times['cosine_topk'][1]:.4f} ms")

    meta = {
        "cosine_topk": ("cuda", "mmrs_tpu_torch/csrc/cosine_topk.cu",
                        "mmrs_tpu/ops/topk.py:94"),
        "mha_short_seq": ("cuda", "mmrs_tpu_torch/csrc/mha_short_seq.cu",
                          "mmrs_tpu/ops/attention.py:134"),
        "normalize_images": ("triton",
                             "mmrs_tpu_torch/csrc/normalize_triton.py",
                             "mmrs_tpu/ops/preprocess.py:84"),
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": where,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (route, source, where) in meta.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
