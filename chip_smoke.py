#!/usr/bin/env python3
"""Drive the PyTorch port's search and governance paths once on one NVIDIA GPU.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each printed on its own line; any failure ends the run with a
nonzero exit and no result line:
  1. environment: torch/CUDA versions, the card's name and power limit;
     whether PIL, yaml and regex import here;
  2. build: the CUDA kernels (one nvcc per source, all at once, sm_90a;
     each kernel's registers, shared memory and spills) and the Triton
     kernel, from the sources in mmrs_tpu_torch/csrc;
  3. each kernel against its plain PyTorch version at main-path shapes:
     K1-K3 as before, K4/K5 (int8/int4 top-k over a 1,048,576 x 512
     gallery, ids and values equal), K6 (fused int8 MLP at the ViT-B/32
     serving shape, nonzero biases, equal in every element), K7/K8 (the
     IVF bucket probes over bf16 / int8 / int4 buckets of a clustered
     1,048,576 x 512 gallery at C = 1024, built on the card: K8 equal,
     K7 values within 1e-5 and ids equal where scores are separated), K9
     (all-pairs first match over 131,072 x 512 planted rows, f32 and bf16:
     keep-first, cross set, ring halves with row offsets, ragged N; every
     id equal);
  4. end to end through the port's public paths at ViT-B/32 width (random
     weights from a seed), each with the kernel launch counts set to 0
     just before it and read just after:
     a. bf16: build_towers -> build_index over 4096 seeded synthetic images
        -> SearchEngine image / prototype / text queries -> sweep_class;
        then a 1,048,576 x 512 gallery queried at Q=8;
     b. quantized: build_towers(dtype int8) -> build_index over the same
        images -> SearchEngine(quantize int8 / int4) image and prototype
        queries (hits equal to the plain top-k) -> sweep_class; then the
        1M gallery behind int8 and int4 engines at Q=8;
     c. IVF: SearchEngine(ann="ivf") over phase 4a's index for bf16, int8
        and int4 buckets, image and prototype (mean, cluster, robust_mean)
        queries (hits = the plain IVF top-k), the saved sidecar loaded by a
        second engine with k-means disabled (same hits), ann_target_recall
        0.95; then the clustered 1M gallery: nprobe = C against flat K1
        (bf16) and K5 (int4), recall@10 at nprobe = 128, sidecar load;
     d. governance: `mmrs-torch dedup --mode embedding` over a 131,072 x
        512 f16 index of planted rows (DUP lines = the planted pairs = the
        plain report); over phase 4a's index with 64 exact image copies
        appended by update_index (every copy found, = plain); the hash
        modes, leakage, convert, clean, rename, merge and dataset make on
        a small image tree (dry runs), naming the native library that ran;
  5. launch counts: every kernel of each path ran during its phase 4 run;
     phase 4's answers against the plain versions on the same inputs;
  6. times (CUDA events, after warm-up), kernel and plain version in turns,
     K9 in Gpairs/s as bench.py counts them; each kernel's bound (the
     larger of its bytes over 3.35 TB/s and its operations over the peak
     rate of their type) and, for K2, PyTorch's fused attention as a
     yardstick.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import importlib
import json
import math
import os
import re
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
# largest |quantized score - exact cosine| tolerated: mmrs_tpu's bounds
# (tests/test_quant.py, tests/test_quant4.py)
QUANT_SCORE_ERR = {"int8": 0.02, "int4": 0.04}
# least c0 prototype precision@10 on every gallery; chance is 10/8 = 1.25
PROTO_MIN = 6
# IVF over the clustered 1M gallery: auto_clusters(1M) and auto_nprobe(1024)
IVF_CLUSTERS = 1024
IVF_NPROBE = 128
IVF_CHUNK = 65536             # build streaming rows
IVF_ANCHORS = 8192            # bench_ivf.py's clustered data
IVF_DUPS = (77, 500_000, 1_000_000)   # the last two are copies of the first
IVF_RUNGS = {"": "bf16", "int8": "int8", "int4": "int4"}
# governance dedup: the JAX bench's size (bench.py:bench_dedup)
DEDUP_ROWS = 131_072
DEDUP_TEST_ROWS = 16_384
DEDUP_TAU = 0.99
DEDUP_PLANTS = 1024           # noisy copies; near misses and chains: 256 each
DEDUP_COPIES = 64             # exact image copies added to phase 4a's index
# the card's peaks (NVIDIA H100 SXM data sheet, dense): bytes/s, FLOP/s
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


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


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """ms per call of fn: CUDA events over `iters` calls after `warmup`."""
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


def time_pair(kernel_fn, plain_fn, iters: int = 10, warmup: int = 3):
    """(kernel ms, plain ms) per call, timed in the order plain, kernel,
    kernel, plain."""
    p1, k1, k2, p2 = (time_ms(fn, iters, warmup) for fn in
                      (plain_fn, kernel_fn, kernel_fn, plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def least_ms(nbytes: float, ops: float, kind: str):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the peak rate of
    their type."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def ptxas_lines(log_path: str):
    """(kernel, usage) per compiled kernel from nvcc's -Xptxas -v output."""
    name = "?"
    with open(log_path, encoding="utf-8") as f:
        for line in f:
            if "Compiling entry function" in line:
                # drop the anonymous namespace's mangled prefix
                line = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                              line)
                m = re.search(r"(\w+?_kernel)(?:I(?:Li(\d+)E|Lb(\d)E|(f)|"
                              r"13__nv_(bfloat16)))?", line)
                name = m.group(1) + "".join(
                    f"<{a}>" for a in m.groups()[1:] if a) if m else "?"
            elif "Used" in line:
                yield name, line.split(":", 1)[1].strip()
            elif "spill" in line and "0 bytes spill stores" not in line:
                yield name, line.strip()


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


def clustered_gallery(dev, seed: int) -> torch.Tensor:
    """[GALLERY_ROWS, DIM] bf16 unit rows clustered like bench_ivf.py's:
    IVF_ANCHORS unit anchors plus noise of sigma 0.9 / sqrt(D) per
    coordinate (same-anchor pairs at cosine ~0.55), made on the card from
    a seed. Rows IVF_DUPS[1:] are copies of row IVF_DUPS[0]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    anchors = torch.randn((IVF_ANCHORS, DIM), device=dev, generator=g)
    anchors /= anchors.norm(dim=1, keepdim=True)
    out = torch.empty((GALLERY_ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for a in range(0, GALLERY_ROWS, IVF_CHUNK):
        which = torch.randint(0, IVF_ANCHORS, (IVF_CHUNK,), device=dev,
                              generator=g)
        x = anchors[which] + 0.9 / DIM ** 0.5 * torch.randn(
            (IVF_CHUNK, DIM), device=dev, generator=g)
        out[a:a + IVF_CHUNK] = (x / x.norm(dim=1, keepdim=True)).to(
            torch.bfloat16)
    out[list(IVF_DUPS[1:])] = out[IVF_DUPS[0]].clone()
    return out


def probe_call(ivf, queries, probe):
    """(wrapper, its arguments before k) of the bucket probe for an index's
    rung: K8 takes the int8 query codes, K7 the bf16 queries."""
    from mmrs_tpu_torch.index.ivf import probe_buckets, probe_buckets_q4
    from mmrs_tpu_torch.ops.quant4 import prep_queries

    if ivf.quant == "int4":
        return probe_buckets_q4, (*prep_queries(queries.float()), probe,
                                  ivf.buckets, ivf.bucket_ids,
                                  ivf.bucket_scales)
    return probe_buckets, (queries.to(torch.bfloat16), probe, ivf.buckets,
                           ivf.bucket_ids, ivf.bucket_scales)


def recall_at(ids: torch.Tensor, exact: torch.Tensor) -> float:
    got, want = ids.tolist(), exact.tolist()
    return sum(len(set(a) & set(b)) for a, b in zip(got, want)) / float(
        len(want) * len(want[0]))


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
    cache: dict = dataclasses.field(default_factory=dict)  # name -> pixels

    def image(self, name: str, cls: str) -> np.ndarray:
        if name not in self.cache:
            self.cache[name] = self._draw(name, cls)
        return self.cache[name]

    def _draw(self, name: str, cls: str) -> np.ndarray:
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


def near_rows(x: torch.Tensor, cos: float, g) -> torch.Tensor:
    """Unit rows at exactly `cos` to the unit rows x (a random direction
    orthogonal to each row)."""
    z = torch.randn(x.shape, device=x.device, generator=g)
    z -= (z * x).sum(1, keepdim=True) * x
    z /= z.norm(dim=1, keepdim=True)
    return cos * x + (1.0 - cos * cos) ** 0.5 * z


def planted_dedup_rows(dev, seed: int):
    """[DEDUP_ROWS, DIM] f32 unit rows made on the card, with planted pairs
    around DEDUP_TAU: DEDUP_PLANTS noisy copies at cosine 0.995, a quarter
    as many near misses at 0.985 and chains A~B, B~C (0.995 a step, A~C
    0.980). Returns (rows, the keep-first first-match vector they must
    give, int64 on the host). Random pairs of 512-d rows stay below ~0.3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((DEDUP_ROWS, DIM), device=dev, generator=g)
    x /= x.norm(dim=1, keepdim=True)
    perm = torch.randperm(DEDUP_ROWS, device=dev, generator=g)
    p, q = DEDUP_PLANTS, DEDUP_PLANTS // 4
    src, dup = perm[:p], perm[p:2 * p]
    x[dup] = near_rows(x[src], 0.995, g)
    x[perm[2 * p + q:2 * p + 2 * q]] = near_rows(x[perm[2 * p:2 * p + q]],
                                                 0.985, g)
    o = 2 * p + 2 * q
    a, b, c = perm[o:o + q], perm[o + q:o + 2 * q], perm[o + 2 * q:o + 3 * q]
    e1 = near_rows(x[a], 0.0, g)
    t = math.acos(0.995)
    x[b] = math.cos(t) * x[a] + math.sin(t) * e1
    x[c] = math.cos(2 * t) * x[a] + math.sin(2 * t) * e1
    first = np.full(DEDUP_ROWS, -1, np.int64)
    for s, d in zip(src.tolist(), dup.tolist()):
        first[max(s, d)] = min(s, d)
    for ra, rb, rc in zip(a.tolist(), b.tolist(), c.tolist()):
        edges = {ra: (rb,), rb: (ra, rc), rc: (rb,)}
        for r, nb in edges.items():
            earlier = [e for e in nb if e < r]
            if earlier:
                first[r] = min(earlier)
    return x, first


def keeper_pairs(first, paths):
    """embedding_dedup's (dup, keeper) report from a first-match vector."""
    out = []
    for i, j in enumerate(first):
        if j >= 0:
            k = int(j)
            while first[k] >= 0:
                k = int(first[k])
            out.append((paths[i], paths[k]))
    return out


def run_cli(argv):
    """`mmrs-torch <argv>` in this process: (exit code, stdout lines)."""
    import contextlib
    import io

    from mmrs_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


def dup_lines(lines):
    """(dup, keeper) pairs from `dedup` DUP lines."""
    out = []
    for ln in lines:
        if ln.startswith("DUP\t"):
            _, dup, keeper = ln.split("\t")
            out.append((dup, keeper.removeprefix("-> keeper ")))
    return out


def governance_tree(root: str) -> None:
    """A small image tree for the hash modes and the dataset commands:
    exact and recompressed copies, a train/test leak, convertible formats,
    class folders to rename and merge, and VQA class folders."""
    from PIL import Image

    def grad(seed, size=(64, 64)):
        rng = np.random.default_rng(seed)
        return Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)
                               ).resize(size, Image.BILINEAR)

    dirs = ("ref", "tgt", "train", "test", "mixed/sub", "classes/cat",
            "classes/kitty", "vqa/cat", "vqa/dog", "vqa/lynx",
            "vqa/ez_negative", "vqa/cat_negative")
    for d in dirs:
        os.makedirs(os.path.join(root, d))
    j = lambda *p: os.path.join(root, *p)  # noqa: E731
    grad(10).save(j("ref", "a.png"))
    grad(10).save(j("tgt", "a_copy.png"))
    grad(11).save(j("tgt", "b.png"))
    grad(20, (128, 128)).save(j("tgt", "big.jpg"), quality=98)
    grad(20, (128, 128)).save(j("tgt", "small.jpg"), quality=40)
    grad(30).save(j("test", "t1.png"))
    grad(30).save(j("train", "leaked.png"))
    grad(31).save(j("train", "clean.png"))
    grad(1).save(j("mixed", "keep.jpg"))
    grad(2).save(j("mixed", "t.png"))
    grad(3).save(j("mixed", "sub", "drop.bmp"))
    for cls, n in (("cat", 3), ("kitty", 2)):
        for i in range(n):
            grad(40 + i).save(j("classes", cls, f"w_{i}.jpg"))
    for cls, n in (("cat", 6), ("dog", 4), ("lynx", 3), ("ez_negative", 12),
                   ("cat_negative", 4)):
        for i in range(n):
            open(j("vqa", cls, f"{cls}{i}.jpg"), "wb").close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmrs_tpu_torch.config import Config, ModelConfig, SearchConfig
    from mmrs_tpu_torch.index import ivf as ivf_mod
    from mmrs_tpu_torch.govern import native as gov_native
    from mmrs_tpu_torch.govern.dedup import embedding_dedup
    from mmrs_tpu_torch.index import gallery as gallery_mod
    from mmrs_tpu_torch.index.gallery import (GalleryIndex, build_index,
                                              update_index)
    from mmrs_tpu_torch.index.ivf import probe_buckets, probe_buckets_q4
    from mmrs_tpu_torch.models import clip
    from mmrs_tpu_torch.models.layers import QLinear
    from mmrs_tpu_torch.ops import _cuda
    from mmrs_tpu_torch.ops.allpairs import first_match
    from mmrs_tpu_torch.ops.attention import mha_short_seq
    from mmrs_tpu_torch.ops.mlp_int8 import mlp_int8_fused
    from mmrs_tpu_torch.ops.normalize import l2_normalize
    from mmrs_tpu_torch.ops.preprocess import normalize_images
    from mmrs_tpu_torch.ops.quant import cosine_topk_quantized, quantize_rows
    from mmrs_tpu_torch.ops.quant4 import cosine_topk_int4, quantize_rows_int4
    from mmrs_tpu_torch.ops.topk import cosine_topk
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.search import calibrate
    from mmrs_tpu_torch.search.engine import SearchEngine
    from mmrs_tpu_torch.search.prototypes import build_prototype

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    card = card_line()
    kernels = (cosine_topk, mha_short_seq, normalize_images,
               cosine_topk_quantized, cosine_topk_int4, mlp_int8_fused,
               probe_buckets, probe_buckets_q4, first_match)
    quant_topk = {"int8": (cosine_topk_quantized, quantize_rows),
                  "int4": (cosine_topk_int4, quantize_rows_int4)}

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
        for name, usage in ptxas_lines(log):
            say(f"  ptxas {name}: {usage}")
    t1 = time.perf_counter()
    normalize_images(torch.zeros((1, 224, 224, 3), dtype=torch.uint8,
                                 device=dev))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t1
    say(f"phase 2 build: nvcc {nvcc_s:.2f} s for {len(_cuda.CUDA_SOURCES)} "
        f"sources in parallel (0 = already built), triton {triton_s:.2f} s, "
        f"total {time.perf_counter() - t0:.2f} s")

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
        packed = {mode: quant(g.float())
                  for mode, (_, quant) in quant_topk.items()}
        errs["cosine_topk"] = 0.0
        # K4 / K5 must equal their plain versions exactly, or the run stops
        errs["cosine_topk_quantized"] = errs["cosine_topk_int4"] = 0.0
        for nq in (1, 8, 64):
            rows = torch.randint(0, GALLERY_ROWS, (nq,), device=dev,
                                 generator=gen)
            qv = g[rows].float() + 0.05 * torch.randn((nq, DIM), device=dev,
                                                      generator=gen)
            qv = qv / qv.norm(dim=1, keepdim=True)
            for k in (10, 100):
                vals, ids = cosine_topk(qv.to(torch.bfloat16), g, k)
                rv, ri = cosine_topk(qv.to(torch.bfloat16), g, k + 1,
                                     impl="torch")
                e = topk_agree(vals, ids, rv, ri)
                check(bool((ids[:, 0] == rows.int()).all()),
                      "top-1 is not the query's source row")
                errs["cosine_topk"] = max(errs["cosine_topk"], e)
                say(f"phase 3 K1 cosine_topk N={GALLERY_ROWS} D={DIM} Q={nq}"
                    f" k={k}: max|dv| {e:.3e}, ids agree")
                for mode, (fn, _) in quant_topk.items():
                    vals, ids = fn(qv, *packed[mode], k)
                    rv, ri = fn(qv, *packed[mode], k, impl="torch")
                    check(torch.equal(ids, ri) and torch.equal(vals, rv),
                          f"{fn.__name__} Q={nq} k={k}: kernel != plain "
                          f"(ids differ at {int((ids != ri).sum())}, max|dv|"
                          f" {float((vals - rv).abs().max())})")
                    check(bool((ids[:, 0] == rows.int()).all()),
                          f"{fn.__name__}: top-1 is not the source row")
                    say(f"phase 3 {'K4' if mode == 'int8' else 'K5'} "
                        f"{fn.__name__} {mode} N={GALLERY_ROWS} D={DIM} "
                        f"Q={nq} k={k}: ids and values equal to plain")
        tie = torch.randn((1000, DIM), device=dev, generator=gen)
        tie[500] = tie[20]
        tie[900] = tie[20]
        tie = (tie / tie.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        vals, ids = cosine_topk(tie[20:21], tie, 5)
        rv, ri = cosine_topk(tie[20:21], tie, 5, impl="torch")
        check(ids[0, :3].tolist() == [20, 500, 900] and torch.equal(ids, ri),
              f"tie rule: kernel {ids.tolist()} plain {ri.tolist()}")
        say(f"phase 3 K1 tie case: ids {ids[0].tolist()} (lowest row first)")
        for mode, (fn, quant) in quant_topk.items():
            tp = quant(tie.float())
            vals, ids = fn(tie[20:21].float(), *tp, 5)
            rv, ri = fn(tie[20:21].float(), *tp, 5, impl="torch")
            check(ids[0, :3].tolist() == [20, 500, 900]
                  and torch.equal(ids, ri) and torch.equal(vals, rv),
                  f"{mode} tie rule: kernel {ids.tolist()} plain "
                  f"{ri.tolist()}")
            say(f"phase 3 {fn.__name__} tie case: ids {ids[0].tolist()}, "
                f"values {vals[0, :3].tolist()} (lowest row first)")

        towers8 = build_towers(Config(model=ModelConfig(
            image_tower="vit_b32", dtype="int8"), seed=SEED), device=dev)
        check(isinstance(towers8.params.visual.blocks[0].mlp.w1, QLinear),
              "dtype int8 did not quantize the vision tower")
        # K6 on the tower's int8 weights with seeded nonzero biases (the
        # random tower's are zero) and two rows of exact ties (max |x| = 127
        # makes the row scale 1.0, so x.5 codes test rounding half to even).
        # Kernel and plain run the same f32 operations in the same order, so
        # they must be equal: a kernel that drops a bias, rounds h to bf16
        # or rounds half away from zero differs in whole rows.
        mlp = towers8.params.visual.blocks[0].mlp
        x = torch.randn((EMBED_BATCH * 50, 768), device=dev, generator=gen)
        ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5],
                            device=dev).repeat(768 // 8)
        x[0], x[1] = ties, -ties
        x = x.to(torch.bfloat16)
        b1, b2 = (0.3 * torch.randn(lin.bias.shape, device=dev, generator=gen)
                  for lin in (mlp.w1, mlp.w2))
        errs["mlp_int8_fused"] = 0.0
        for act in ("quick_gelu", "gelu"):
            args = (x, mlp.w1.q, mlp.w1.s, b1, mlp.w2.q, mlp.w2.s, b2)
            out = mlp_int8_fused(*args, act=act).float()
            ref = mlp_int8_fused(*args, act=act, impl="torch").float()
            d = float((out - ref).abs().max())
            check(torch.equal(out, ref),
                  f"mlp_int8_fused {act}: kernel != plain in "
                  f"{int((out != ref).sum())} elements, max|d| {d}")
            errs["mlp_int8_fused"] = max(errs["mlp_int8_fused"], d)
            say(f"phase 3 K6 mlp_int8_fused {act} [{x.shape[0]},768]->3072 "
                f"bf16, biases N(0, 0.3), tie rows: equal to plain in every "
                f"element")
        del g, px, packed, x

        # K7 / K8: the IVF bucket probes over a clustered 1M x 512 gallery,
        # indexed at C = 1024 for every rung from one set of centroids
        t0 = time.perf_counter()
        ivf_gal = clustered_gallery(dev, SEED)

        def ivf_chunks():
            return (ivf_gal[a:a + IVF_CHUNK]
                    for a in range(0, GALLERY_ROWS, IVF_CHUNK))

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cents = ivf_mod.train_centroids(ivf_gal[::4], IVF_CLUSTERS,
                                        device=dev)
        torch.cuda.synchronize()
        ivf_build_s = {"train": time.perf_counter() - t1}
        ivfs = {}
        for mode in IVF_RUNGS:
            ivfs[mode] = ivf_mod.build_ivf_streaming(
                ivf_chunks, GALLERY_ROWS, DIM, n_clusters=IVF_CLUSTERS,
                chunk=IVF_CHUNK, centroids=cents, quantize=mode, device=dev)
            ivf_build_s[mode] = ivfs[mode].build_seconds
        say(f"phase 3 IVF index {GALLERY_ROWS}x{DIM} C={IVF_CLUSTERS}: cap "
            + ", ".join(f"{IVF_RUNGS[m]} {v.bucket_cap} (spill "
                        f"{int((v.spill_ids >= 0).sum())})"
                        for m, v in ivfs.items())
            + f", {time.perf_counter() - t0:.1f} s")
        errs["probe_buckets"] = errs["probe_buckets_q4"] = 0.0
        for nq in (1, 8, 64):
            rows = torch.randint(0, GALLERY_ROWS, (nq,), device=dev,
                                 generator=gen)
            qv = ivf_gal[rows].float() + 0.02 * torch.randn(
                (nq, DIM), device=dev, generator=gen)
            qv = qv / qv.norm(dim=1, keepdim=True)
            for nprobe in (IVF_NPROBE, IVF_CLUSTERS):
                for mode, ivf in ivfs.items():
                    fn, args = probe_call(
                        ivf, qv, ivf_mod.probe_lists(qv, ivf, nprobe))
                    # the plain top-(k+1) begins with the plain top-k
                    rv, ri = fn(*args, 101, impl="torch")
                    for k in (10, 100):
                        vals, ids = fn(*args, k)
                        if mode == "int4":
                            check(torch.equal(ids, ri[:, :k])
                                  and torch.equal(vals, rv[:, :k]),
                                  f"K8 Q={nq} nprobe={nprobe} k={k}: kernel "
                                  f"!= plain (ids differ at "
                                  f"{int((ids != ri[:, :k]).sum())})")
                        else:
                            errs["probe_buckets"] = max(
                                errs["probe_buckets"],
                                topk_agree(vals, ids, rv, ri, tol=1e-5))
                say(f"phase 3 K7 probe_buckets (bf16, int8) / K8 "
                    f"probe_buckets_q4 C={IVF_CLUSTERS} Q={nq} "
                    f"nprobe={nprobe} k=10,100: K7 max|dv| "
                    f"{errs['probe_buckets']:.3e}, ids agree where "
                    f"separated; K8 ids and values equal to plain")
        # equal scores: rows IVF_DUPS share row 77's bucket and come back
        # in slot order, after an earlier-probed bucket
        for mode, ivf in ivfs.items():
            home = int((ivf.bucket_ids == IVF_DUPS[0]).nonzero()[0, 0])
            in_home = [r for r in IVF_DUPS
                       if bool((ivf.bucket_ids[home] == r).any())]
            check(len(in_home) >= 2, f"{mode}: duplicated rows spilled")
            probe = torch.tensor([[(home + 1) % IVF_CLUSTERS, home]],
                                 dtype=torch.int32, device=dev)
            fn, args = probe_call(ivf, ivf_gal[IVF_DUPS[0]:IVF_DUPS[0] + 1],
                                  probe)
            vals, ids = fn(*args, 8)
            rv, ri = fn(*args, 9, impl="torch")
            check(ids[0, :len(in_home)].tolist() == in_home
                  and ri[0, :len(in_home)].tolist() == in_home,
                  f"{mode} probe tie rule: kernel {ids.tolist()} plain "
                  f"{ri.tolist()}")
            if mode == "int4":
                check(torch.equal(ids, ri[:, :8])
                      and torch.equal(vals, rv[:, :8]), "K8 tie case")
            else:
                topk_agree(vals, ids, rv, ri, tol=1e-5)
            say(f"phase 3 {fn.__name__} {IVF_RUNGS[mode]} tie case: ids "
                f"{ids[0].tolist()} (equal rows in slot order)")

        # K9: all-pairs first match at the dedup bench's size, planted pairs
        # at 0.995 / 0.985 around tau 0.99; every id equal to plain
        t0 = time.perf_counter()
        dedup_x, dedup_first = planted_dedup_rows(dev, SEED)
        want_first = torch.from_numpy(dedup_first).to(dev, torch.int32)
        half = DEDUP_ROWS // 2

        def k9_equal(a, b, what, **kw):
            got = first_match(a, b, DEDUP_TAU, **kw)
            ref = first_match(a, b, DEDUP_TAU, impl="torch", **kw)
            check(torch.equal(got, ref),
                  f"K9 {what}: kernel != plain at {int((got != ref).sum())} "
                  f"rows")
            return got

        k9_report = []
        for dtype in (torch.float32, torch.bfloat16):
            x = dedup_x.to(dtype)
            name = "f32" if dtype == torch.float32 else "bf16"
            whole = k9_equal(x, x, f"{name} intra", intra=True)
            check(torch.equal(whole, want_first),
                  f"K9 {name} intra != the planted pairs at "
                  f"{int((whole != want_first).sum())} rows")
            ragged = k9_equal(x[:-1], x[:-1], f"{name} ragged", intra=True)
            check(torch.equal(ragged, whole[:-1]), f"K9 {name} N-1 rows")
            h1 = k9_equal(x[half:], x[:half], f"{name} ring block",
                          intra=True, row_offset=half)
            h2 = k9_equal(x[half:], x[half:], f"{name} ring diagonal",
                          intra=True, row_offset=half, col_offset=half)
            ring = torch.where(h1 >= 0, h1,
                               torch.where(h2 >= 0, h2 + half, -1))
            check(torch.equal(ring, whole[half:]),
                  f"K9 {name}: the ring's halves != the whole set")
            k9_report.append(f"{name} intra {int((whole >= 0).sum())} rows "
                             f"matched = planted, N-1 ragged, ring halves "
                             f"at row_offset {half} = whole")
        # no pair lies within 1e-3 of tau: tau +- 1e-3 give the same answer
        for tau in (DEDUP_TAU - 1e-3, DEDUP_TAU + 1e-3):
            check(torch.equal(first_match(dedup_x, dedup_x, tau, intra=True),
                              want_first), f"K9 at tau {tau} differs")
        # cross set: DEDUP_ROWS train rows against DEDUP_TEST_ROWS test rows
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        test_rows = torch.randn((DEDUP_TEST_ROWS, DIM), device=dev,
                                generator=g)
        test_rows /= test_rows.norm(dim=1, keepdim=True)
        train = dedup_x.clone()
        pick = torch.randperm(DEDUP_ROWS, device=dev, generator=g)[:768]
        leak_to = torch.randperm(DEDUP_TEST_ROWS, device=dev,
                                 generator=g)[:768]
        train[pick[:512]] = near_rows(test_rows[leak_to[:512]], 0.995, g)
        train[pick[512:]] = near_rows(test_rows[leak_to[512:]], 0.985, g)
        # one train row leaks to two test rows: its first match is the lower
        twin = int(leak_to[512 + 255])        # a near-miss target, now reused
        test_rows[twin] = near_rows(train[pick[0]:pick[0] + 1], 0.995, g)[0]
        want_cross = torch.full((DEDUP_ROWS,), -1, dtype=torch.int32,
                                device=dev)
        want_cross[pick[:512]] = leak_to[:512].int()
        want_cross[pick[0]] = min(int(leak_to[0]), twin)
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            got = k9_equal(train.to(dtype), test_rows.to(dtype),
                           f"{name} cross set")
            check(torch.equal(got, want_cross),
                  f"K9 {name} cross set != the planted leaks at "
                  f"{int((got != want_cross).sum())} rows")
        del train, test_rows
        errs["first_match"] = 0.0       # ids: equal in every element
        say(f"phase 3 K9 first_match {DEDUP_ROWS}x{DIM} tau {DEDUP_TAU} "
            f"({DEDUP_PLANTS} copies at 0.995, {DEDUP_PLANTS // 4} near "
            f"misses at 0.985, {DEDUP_PLANTS // 4} chains): "
            + "; ".join(k9_report) + f"; cross {DEDUP_ROWS} x "
            f"{DEDUP_TEST_ROWS}: 512 leaks found (one to two test rows, "
            f"lowest taken), 256 near misses not; tau +- 1e-3 same answer; "
            f"every id equal to plain, {time.perf_counter() - t0:.1f} s")

    # ---- 4a. end to end: bf16 ---------------------------------------------
    cfg = Config(model=ModelConfig(image_tower="vit_b32", dtype="bfloat16"),
                 seed=SEED)
    towers = build_towers(cfg, device=dev)
    model = towers.params
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    samples = [(f"synthetic/c{i % SMOKE_CLASSES}/{i:05d}",
                f"c{i % SMOKE_CLASSES}") for i in range(SMOKE_IMAGES)]
    ds = SyntheticImages(samples)
    picks = list(range(0, SMOKE_IMAGES, SMOKE_IMAGES // 8))
    qpx = np.stack([ds.image(*samples[i]) for i in picks])
    tmp = tempfile.TemporaryDirectory()
    idx = launched(
        (normalize_images, mha_short_seq),
        lambda: build_index(ds, towers.image_encode,
                            os.path.join(tmp.name, "idx"),
                            batch_size=cfg.gallery.batch_size),
        "build_index")
    check(len(idx) == SMOKE_IMAGES and idx.dim == DIM,
          f"index has {len(idx)} rows of dim {idx.dim}")
    check(bool(np.isfinite(idx.embeddings).all()), "non-finite rows")
    engine = SearchEngine(idx, SearchConfig(), device=dev)

    qvec = launched((normalize_images, mha_short_seq),
                    lambda: towers.image_encode(qpx), "image_encode")
    hits = launched((cosine_topk,),
                    lambda: engine.query_image(qvec, top_k=10),
                    "query_image")
    for i, h in zip(picks, hits):
        check(len(h) == 10 and samples[i][0] in [x.path for x in h[:3]],
              f"image query {i}: own path not in the top 3")
    self_top1 = sum(h[0].path == samples[i][0] for i, h in zip(picks, hits))
    shots = idx.embeddings[[i for i in range(40) if i % 8 == 0]]
    proto_hits = launched(
        (cosine_topk,), lambda: engine.query_prototype(shots, top_k=10),
        "query_prototype")[0]
    same = sum(h.cls == "c0" for h in proto_hits)
    check(same >= PROTO_MIN, f"prototype c0 precision@10 {same}/10")

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

    def sweep_equals_host(eng, what):
        labels = np.asarray([c == "c0" for c in eng.index.classes])
        proto = torch.from_numpy(np.asarray(
            eng.index.embeddings[np.flatnonzero(labels)[:10]])).mean(0)
        res = eng.sweep_class(proto, labels)
        host = calibrate.sweep(
            eng.device_similarities(proto[None])[0].cpu().numpy()
            * eng.config.logit_scale, labels)
        check(0.0 <= res.best_f1 <= 1.0 and np.isfinite(res.best_threshold),
              f"{what} sweep_class result")
        check(abs(res.best_threshold - host.best_threshold) <= 1e-3
              and abs(res.best_f1 - host.best_f1) <= 1e-9,
              f"{what} device sweep {res.best_threshold}/{res.best_f1} vs "
              f"host {host.best_threshold}/{host.best_f1}")
        return res

    def hits_equal_plain(eng, fn, hits, q, what):
        """A quantized engine's hits equal fn's plain version on the same
        gallery and queries (q as query_vectors receives them): the same
        rows in the same order with the same scores."""
        with torch.inference_mode():
            rv, ri = fn(l2_normalize(q), eng.gallery, eng.gallery_scales,
                        len(hits[0]), impl="torch")
        rv, scale = rv.cpu().numpy(), eng.config.logit_scale
        want = [[(eng.index.paths[r], float(rv[i, j] * scale))
                 for j, r in enumerate(row)]
                for i, row in enumerate(ri.tolist())]
        check([[(x.path, x.score) for x in h] for h in hits] == want,
              f"{what}: engine hits != the plain top-k")

    res = sweep_equals_host(engine, "bf16")
    say(f"phase 4a e2e ViT-B/32 bf16: index {len(idx)}x{idx.dim}, image "
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
    say(f"phase 4a e2e 1M x 512 gallery (f16 host -> bf16 device), Q=8: "
        f"top-1 = source row for 8/8, {time.perf_counter() - t0:.1f} s")
    # read before anything else launches a kernel
    launches_bf16 = {fn.__name__: fn.launches for fn in kernels}

    # ---- 4b. end to end: int8 tower, int8 / int4 galleries ----------------
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    idx8 = launched(
        (normalize_images, mha_short_seq, mlp_int8_fused),
        lambda: build_index(ds, towers8.image_encode,
                            os.path.join(tmp.name, "idx8"),
                            batch_size=cfg.gallery.batch_size),
        "int8 build_index")
    check(len(idx8) == SMOKE_IMAGES and idx8.dim == DIM
          and bool(np.isfinite(idx8.embeddings).all()), "int8 index rows")
    e8 = np.asarray(idx8.embeddings, np.float32)
    e16 = np.asarray(idx.embeddings, np.float32)
    tower_cos = float((e8 * e16).sum(1).min())
    qvec8 = launched((normalize_images, mha_short_seq, mlp_int8_fused),
                     lambda: towers8.image_encode(qpx), "int8 image_encode")
    quant_report = []
    row_of = {p: r for r, p in enumerate(idx8.paths)}
    for mode, (fn, _) in quant_topk.items():
        eng = SearchEngine(idx8, SearchConfig(), quantize=mode, device=dev)
        hits = launched((fn,), lambda: eng.query_image(qvec8, top_k=10),
                        f"{mode} query_image")
        hits_equal_plain(eng, fn, hits, torch.from_numpy(qvec8).to(dev),
                         f"{mode} query_image")
        # random towers map every image near one direction (nearest other
        # image at cosine ~0.998): int8's score error stays below that gap,
        # int4's (rms ~0.006) does not. Every query's hits must be the best
        # rows up to the mode's error bound (mmrs_tpu's: 0.02 int8, 0.04
        # int4); int8 must also find the query image in its top 3
        bound = QUANT_SCORE_ERR[mode]
        ranks = []
        for i, qv8, h in zip(picks, qvec8, hits):
            check(len(h) == 10, f"{mode} image query {i}: {len(h)} hits")
            exact = e8[[row_of[x.path] for x in h]] @ qv8
            err = float(np.abs(np.asarray([x.score for x in h])
                               / eng.config.logit_scale - exact).max())
            check(err <= bound and exact[0] >= float(e8[i] @ qv8) - bound,
                  f"{mode} image query {i}: hit scores off the exact "
                  f"cosines by {err}, top-1 exact {exact[0]}")
            paths = [x.path for x in h]
            ranks.append(paths.index(samples[i][0]) if samples[i][0] in paths
                         else ">9")
            check(mode != "int8" or samples[i][0] in paths[:3],
                  f"int8 image query {i}: own path not in the top 3")
        top1 = sum(r == 0 for r in ranks)
        shots8 = idx8.embeddings[[i for i in range(40) if i % 8 == 0]]
        proto_hits = launched(
            (fn,), lambda: eng.query_prototype(shots8, top_k=10),
            f"{mode} query_prototype")
        proto = build_prototype(torch.from_numpy(np.asarray(shots8)).to(dev),
                                strategy=eng.config.prototype)
        hits_equal_plain(eng, fn, proto_hits, proto[None, :],
                         f"{mode} query_prototype")
        prec = sum(h.cls == "c0" for h in proto_hits[0])
        check(prec >= PROTO_MIN,
              f"{mode} prototype c0 precision@10 {prec}/10")
        res8 = sweep_equals_host(eng, mode)
        quant_report.append(
            f"{mode} gallery: image and prototype hits = plain top-10, image "
            f"self-rank {ranks} (top-1 {top1}/8; hit scores within {bound} "
            f"of exact), prototype c0 "
            f"precision@10 {prec}/10, calibrate c0 thr "
            f"{res8.best_threshold:.4f} f1 {res8.best_f1:.4f} (= host sweep)")
    say(f"phase 4b e2e ViT-B/32 int8 tower: index {len(idx8)}x{idx8.dim}, "
        f"embed cosine to the bf16 tower min {tower_cos:.6f}; "
        + "; ".join(quant_report) + f"; {time.perf_counter() - t0:.1f} s")
    check(tower_cos >= 0.99,
          f"int8 tower embed cosine to bf16 {tower_cos} < 0.99")

    t0 = time.perf_counter()
    big_quant = {}
    for mode, (fn, _) in quant_topk.items():
        eng = SearchEngine(big, SearchConfig(), quantize=mode, device=dev)
        hits = launched((fn,), lambda: eng.query_vectors(qbig, top_k=10),
                        f"1M {mode} query_vectors")
        check(all(h[0].path == f"row/{s}" for s, h in zip(src, hits)),
              f"1M {mode} query: top-1 is not the source row")
        big_quant[mode] = eng
    say(f"phase 4b e2e 1M x 512 gallery behind int8 ("
        f"{big_quant['int8'].gallery.nbytes / 2 ** 20:.0f} MiB) and int4 ("
        f"{big_quant['int4'].gallery.nbytes / 2 ** 20:.0f} MiB) engines, "
        f"Q=8: top-1 = source row for 8/8 each, "
        f"{time.perf_counter() - t0:.1f} s")
    launches_quant = {fn.__name__: fn.launches for fn in kernels}

    # ---- 4c. end to end: IVF ------------------------------------------------
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    row_of = {p: r for r, p in enumerate(idx.paths)}

    def ivf_hits_equal_plain(eng, hits, q, what):
        """An IVF engine's hits against the plain IVF top-k on the same
        index and queries (q as query_vectors receives them): int4 the same
        rows, order and scores; bf16 / int8 (f32 sums in another order)
        scores within 1e-5 and rows equal where scores are separated."""
        k, scale = len(hits[0]), eng.config.logit_scale
        check(all(len(h) == k for h in hits), f"{what}: short hit lists")
        with torch.inference_mode():
            rv, ri = ivf_mod.ivf_topk(l2_normalize(q.float()), eng.ivf,
                                      k=k + 1, nprobe=eng.config.ann_nprobe,
                                      impl="torch")
        if eng.ivf.quant == "int4":
            rvn = rv.cpu().numpy()
            want = [[(eng.index.paths[r], float(rvn[i, j] * scale))
                     for j, r in enumerate(row[:k])]
                    for i, row in enumerate(ri.tolist())]
            check([[(x.path, x.score) for x in h] for h in hits] == want,
                  f"{what}: engine hits != the plain IVF top-k")
            return
        vals = torch.tensor([[x.score / scale for x in h] for h in hits],
                            device=dev)
        ids = torch.tensor([[row_of[x.path] for x in h] for h in hits],
                           dtype=torch.int32, device=dev)
        topk_agree(vals, ids, rv, ri, tol=1e-5)

    def refuse(*args, **kwargs):
        raise RuntimeError("the saved sidecar was not used")

    sidecar = os.path.join(idx.directory, "ivf")
    shots_t = torch.from_numpy(np.asarray(shots)).to(dev)
    ivf_report = []
    for mode in IVF_RUNGS:
        fn = probe_buckets_q4 if mode == "int4" else probe_buckets
        eng = SearchEngine(idx, SearchConfig(ann="ivf"), quantize=mode,
                           device=dev)
        check(eng.ivf.quant == mode and eng.gallery is None
              and ivf_mod.sidecar_meta(sidecar)["quant"] == mode,
              f"{IVF_RUNGS[mode]} IVF engine / sidecar")
        hits = launched((fn,), lambda: eng.query_image(qvec, top_k=10),
                        f"IVF {mode} query_image")
        ivf_hits_equal_plain(eng, hits, torch.from_numpy(qvec).to(dev),
                             f"IVF {mode} query_image")
        self1 = sum(h[0].path == samples[i][0] for i, h in zip(picks, hits))
        precs = []
        for strategy in ("mean", "cluster", "robust_mean"):
            ph = launched((fn,), lambda: eng.query_prototype(
                shots, strategy=strategy, top_k=10),
                f"IVF {mode} {strategy} query_prototype")
            c = eng.config
            proto = build_prototype(shots_t, strategy=strategy,
                                    cluster_k=c.cluster_k,
                                    balance_ratio=c.cluster_balance_ratio,
                                    outlier_percentile=c.outlier_percentile)
            ivf_hits_equal_plain(eng, ph, proto[None, :],
                                 f"IVF {mode} {strategy} query_prototype")
            precs.append(sum(h.cls == "c0" for h in ph[0]))
        # a second engine loads the saved sidecar: no k-means, same hits
        train = ivf_mod.train_centroids
        ivf_mod.train_centroids = refuse
        try:
            eng2 = SearchEngine(idx, SearchConfig(ann="ivf"), quantize=mode,
                                device=dev)
        finally:
            ivf_mod.train_centroids = train
        hits2 = eng2.query_image(qvec, top_k=10)
        check([[(x.path, x.score) for x in h] for h in hits2]
              == [[(x.path, x.score) for x in h] for h in hits],
              f"IVF {mode}: the loaded sidecar serves other hits")
        ivf_report.append(
            f"{IVF_RUNGS[mode]} (C={eng.ivf.n_clusters} cap "
            f"{eng.ivf.bucket_cap} nprobe {eng.config.ann_nprobe or 'auto'}):"
            f" image and prototype hits = plain IVF top-10, image self-top1 "
            f"{self1}/8, prototype c0 precision@10 mean/cluster/robust_mean "
            f"{precs}, sidecar load = build")
    eng_t = SearchEngine(idx, SearchConfig(ann="ivf", ann_target_recall=0.95),
                         device=dev)
    tuned = ivf_mod.sidecar_meta(sidecar)["tuned"]
    check(tuned["nprobe"] == eng_t.config.ann_nprobe
          and (tuned["recall"] >= 0.95
               or tuned["nprobe"] == eng_t.ivf.n_clusters),
          f"ann_target_recall: {tuned}")
    say(f"phase 4c e2e IVF over the ViT-B/32 index {len(idx)}x{idx.dim}: "
        + "; ".join(ivf_report) + f"; ann_target_recall 0.95 -> nprobe "
        f"{tuned['nprobe']} (recall {tuned['recall']:.4f}, curve "
        f"{tuned['curve']}), {time.perf_counter() - t0:.1f} s")

    # the clustered 1M gallery: nprobe = C is the flat scan; recall at 128
    t0 = time.perf_counter()
    with torch.inference_mode():
        flat16 = torch.cat([l2_normalize(c.float()).to(torch.bfloat16)
                            for c in ivf_chunks()])
        flat4 = [quantize_rows_int4(l2_normalize(c.float()))
                 for c in ivf_chunks()]
        flat4 = (torch.cat([p for p, _ in flat4]),
                 torch.cat([s for _, s in flat4]))
        rows = torch.randint(0, GALLERY_ROWS, (64,), device=dev,
                             generator=gen)
        qc = ivf_gal[rows].float() + 0.02 * torch.randn((64, DIM), device=dev,
                                                        generator=gen)
        qc = qc / qc.norm(dim=1, keepdim=True)
        ev, ei = cosine_topk(qc.to(torch.bfloat16), flat16, 11)
        recall = {}
        for mode, ivf in ivfs.items():
            fn = probe_buckets_q4 if mode == "int4" else probe_buckets
            vals, ids = launched((fn,), lambda: ivf_mod.ivf_topk(
                qc, ivf, k=10, nprobe=IVF_CLUSTERS), f"1M IVF {mode} nprobe=C")
            if mode == "":
                topk_agree(vals, ids, ev, ei, tol=1e-5)
            elif mode == "int4":
                fv, fi = cosine_topk_int4(qc, *flat4, 10)
                check(torch.equal(ids, fi) and torch.equal(vals, fv),
                      f"1M IVF int4 at nprobe=C != flat K5 (ids differ at "
                      f"{int((ids != fi).sum())})")
            full = recall_at(ids, ei[:, :10])
            _, ids = launched((fn,), lambda: ivf_mod.ivf_topk(
                qc, ivf, k=10, nprobe=IVF_NPROBE), f"1M IVF {mode}")
            recall[IVF_RUNGS[mode]] = (recall_at(ids, ei[:, :10]), full)
        side = os.path.join(tmp.name, "ivf1m")
        ivf_mod.save_ivf(side, ivfs[""])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loaded = ivf_mod.load_ivf(side, make_chunks=ivf_chunks,
                                  n=GALLERY_ROWS, d=DIM, chunk=IVF_CHUNK,
                                  device=dev)
        torch.cuda.synchronize()
        ivf_load_s = time.perf_counter() - t1
        check(torch.equal(loaded.buckets, ivfs[""].buckets)
              and torch.equal(loaded.bucket_ids, ivfs[""].bucket_ids)
              and torch.equal(loaded.spill, ivfs[""].spill),
              "1M sidecar load != build")
        del loaded
    say(f"phase 4c e2e clustered 1M x 512, C={IVF_CLUSTERS}, Q=64: nprobe=C "
        f"ids = flat K1 where separated (bf16), = flat K5 exactly (int4); "
        f"recall@10 vs the exact bf16 scan at nprobe={IVF_NPROBE} (and at "
        f"C): {json.dumps(recall)}; sidecar save + load = build "
        f"({ivf_load_s:.2f} s load), {time.perf_counter() - t0:.1f} s")
    launches_ivf = {fn.__name__: fn.launches for fn in kernels}

    # ---- 4d. end to end: governance ------------------------------------------
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    # (i) the planted rows as an on-disk index (f16 rows, two shards), then
    # `mmrs-torch dedup --mode embedding` as a user runs it
    dedup_dir = os.path.join(tmp.name, "dedup_index")
    os.makedirs(dedup_dir)
    dedup_paths = [f"dedup/{i:06d}.jpg" for i in range(DEDUP_ROWS)]
    rows16 = dedup_x.to(torch.float16).cpu().numpy()
    shards = [gallery_mod._write_shard(
        dedup_dir, s, rows16[a:a + 65536],
        [(p, "c") for p in dedup_paths[a:a + 65536]])
        for s, a in enumerate(range(0, DEDUP_ROWS, 65536))]
    gallery_mod._write_manifest(dedup_dir, shards, DIM)
    del rows16
    t1 = time.perf_counter()
    code, lines = launched((first_match,), lambda: run_cli(
        ["dedup", "--mode", "embedding", "--index", dedup_dir, "--tau",
         str(DEDUP_TAU)]), "dedup --mode embedding")
    cli_s = time.perf_counter() - t1
    planted = keeper_pairs(dedup_first, dedup_paths)
    check(code == 0 and dup_lines(lines) == planted
          and lines[0].startswith(f"{len(planted)} duplicates, 0 errors"),
          f"dedup --mode embedding: exit {code}, {len(dup_lines(lines))} DUP "
          f"lines, {len(planted)} planted")
    idx_d = GalleryIndex.load(dedup_dir)
    plain_rep = embedding_dedup(np.asarray(idx_d.embeddings, np.float32),
                                idx_d.paths, tau=DEDUP_TAU, impl="torch")
    check(plain_rep.duplicates == planted, "plain embedding_dedup report")
    say(f"phase 4d e2e governance (i): mmrs-torch dedup --mode embedding "
        f"over a {DEDUP_ROWS}x{DIM} f16 index: exit 0, {lines[0]!r}, DUP "
        f"lines = the planted pairs (chains to their first keeper) = the "
        f"plain report, {cli_s:.2f} s for the command")

    # (ii) phase 4a's ViT-B/32 index with exact copies of 64 of its images
    # appended (`index update`), deduplicated at a tau between the largest
    # distinct-image cosine and the smallest copy cosine (random towers put
    # distinct images within ~0.002 of each other)
    sources = list(range(0, SMOKE_IMAGES, SMOKE_IMAGES // DEDUP_COPIES))
    copies = [(f"synthetic/{samples[s][1]}/{SMOKE_IMAGES + i:05d}",
               samples[s][1]) for i, s in enumerate(sources)]
    for (name, _), s in zip(copies, sources):
        ds.cache[name] = ds.image(*samples[s])
    ds_copies = dataclasses.replace(ds, samples=samples + copies)
    idx2 = update_index(ds_copies, towers.image_encode, idx.directory,
                        batch_size=cfg.gallery.batch_size)
    check(len(idx2) == SMOKE_IMAGES + DEDUP_COPIES, "index update rows")
    with torch.inference_mode():
        e2 = torch.tensor(np.asarray(idx2.embeddings, np.float32), device=dev)
        sims = e2 @ e2.T
        copy_rows = torch.arange(SMOKE_IMAGES, len(idx2), device=dev)
        src_rows = torch.tensor(sources, device=dev)
        copy_min = float(sims[copy_rows, src_rows].min())
        sims[copy_rows, src_rows] = -2.0
        sims[src_rows, copy_rows] = -2.0
        sims.fill_diagonal_(-2.0)
        distinct_max = float(sims.max())
        del sims, e2
    check(copy_min > distinct_max,
          f"copies (min cosine {copy_min}) not above distinct images (max "
          f"{distinct_max})")
    tau2 = float(np.float32((copy_min + distinct_max) / 2))
    code, lines = launched((first_match,), lambda: run_cli(
        ["dedup", "--mode", "embedding", "--index", idx.directory, "--tau",
         repr(tau2)]), "dedup over the ViT-B/32 index")
    want = [(idx2.paths[SMOKE_IMAGES + i], idx2.paths[s])
            for i, s in enumerate(sources)]
    plain_rep = embedding_dedup(np.asarray(idx2.embeddings, np.float32),
                                idx2.paths, tau=tau2, impl="torch")
    check(code == 0 and dup_lines(lines) == plain_rep.duplicates == want,
          f"dedup over the ViT-B/32 index: {len(dup_lines(lines))} DUP lines,"
          f" plain {len(plain_rep.duplicates)}, {DEDUP_COPIES} copies")
    say(f"phase 4d e2e governance (ii): 4a's index + {DEDUP_COPIES} exact "
        f"image copies (index update, {len(idx2)} rows): copy cosines >= "
        f"{copy_min:.7f}, distinct images <= {distinct_max:.7f}, tau "
        f"{tau2:.7f} (midway): {lines[0]!r}, every copy -> its source, = "
        f"the plain report")

    # (iii) the host-side governance commands, dry runs, on a small tree
    gov = os.path.join(tmp.name, "gov")
    governance_tree(gov)
    g_ = lambda *p: os.path.join(gov, *p)  # noqa: E731
    expect = {
        ("dedup", "--mode", "exact", "--reference", g_("ref"), "--target",
         g_("tgt")): ["1 duplicates, 0 errors, 0 removed (dry_run=True)",
                      f"DUP\t{g_('tgt', 'a_copy.png')}\t-> keeper "
                      f"{g_('ref', 'a.png')}"],
        ("dedup", "--mode", "perceptual", "--target", g_("tgt")):
            f"DUP\t{g_('tgt', 'small.jpg')}\t-> keeper "
            f"{g_('tgt', 'big.jpg')}",
        ("leakage", "--train", g_("train"), "--test", g_("test")):
            ["1 duplicates, 0 errors, 0 removed (dry_run=True)",
             f"LEAK\t{g_('train', 'leaked.png')}\t(matches test "
             f"{g_('test', 't1.png')})"],
        ("convert", "--root", g_("mixed")):
            ["2 converted, 0 errors (dry_run=True)"],
        ("clean", "--root", g_("mixed")): ["2 deleted (dry_run=True)"],
        ("rename", "--root", g_("classes")): ["5 renamed (dry_run=True)"],
        ("merge", "--root", g_("classes"), "--map", "kitty=cat"):
            ["2 moved (dry_run=True)"],
    }
    for variant, n in (("v1", 13), ("v2", 26), ("v3", 13 + 6 + 6),
                       ("v5", 6 + 3 + 4)):
        out = g_(f"{variant}.json")
        expect[("dataset", "make", "--variant", variant, "--root", g_("vqa"),
                "--out", out)] = [json.dumps({"records": n, "out": out})]
    expect[("dataset", "make", "--variant", "v4", "--root", g_("vqa"),
            "--out", g_("v4"))] = [json.dumps(
                {"positives": 9, "with_cross": 12, "with_simple": 15,
                 "with_hard": 15})]
    for argv, want_lines in expect.items():
        code, lines = run_cli(list(argv))
        ok = (want_lines in lines if isinstance(want_lines, str)
              else lines == want_lines)
        check(code == 0 and ok, f"mmrs-torch {' '.join(argv[:3])}: exit "
              f"{code}, {lines}")
    lib = gov_native.load_library()
    say(f"phase 4d e2e governance (iii): dedup exact / perceptual, leakage, "
        f"convert, clean, rename, merge, dataset make v1-v5 (dry runs) on a "
        f"small image tree: the expected lines; hashing scans ran on "
        + (f"the native library {os.path.basename(lib._name)} (g++)" if lib
           else "the numpy fallback (no g++)")
        + f"; {time.perf_counter() - t0:.1f} s for 4d")
    launches_gov = {fn.__name__: fn.launches for fn in kernels}
    tmp.cleanup()

    # ---- 5. launch counts --------------------------------------------------
    say(f"phase 5 launches during phase 4a (bf16): "
        f"{json.dumps(launches_bf16)}")
    say(f"phase 5 launches during phase 4b (quantized): "
        f"{json.dumps(launches_quant)}")
    for fn in (cosine_topk, mha_short_seq, normalize_images):
        check(launches_bf16[fn.__name__] > 0,
              f"{fn.__name__} never launched in phase 4a")
    for fn in (mha_short_seq, normalize_images, cosine_topk_quantized,
               cosine_topk_int4, mlp_int8_fused):
        check(launches_quant[fn.__name__] > 0,
              f"{fn.__name__} never launched in phase 4b")
    say(f"phase 5 launches during phase 4c (IVF): {json.dumps(launches_ivf)}")
    for fn in (probe_buckets, probe_buckets_q4):
        check(launches_ivf[fn.__name__] > 0,
              f"{fn.__name__} never launched in phase 4c")
    launches = {name: launches_bf16[name] for name in
                ("cosine_topk", "mha_short_seq", "normalize_images")}
    launches.update({name: launches_quant[name] for name in
                     ("cosine_topk_quantized", "cosine_topk_int4",
                      "mlp_int8_fused")})
    launches.update({name: launches_ivf[name] for name in
                     ("probe_buckets", "probe_buckets_q4")})
    say(f"phase 5 launches during phase 4d (governance): "
        f"{json.dumps(launches_gov)}")
    check(launches_gov["first_match"] > 0,
          "first_match never launched in phase 4d")
    launches["first_match"] = launches_gov["first_match"]

    # phase 4's answers against the plain versions on the same inputs
    with torch.inference_mode():
        for vec in (qvec, tvec):
            q = l2_normalize(torch.as_tensor(vec, device=dev).float())
            vals, kid = cosine_topk(q.to(torch.bfloat16), engine.gallery, 10)
            rv, ri = cosine_topk(q.to(torch.bfloat16), engine.gallery, 11,
                                 impl="torch")
            topk_agree(vals, kid, rv, ri)
            for mode, (fn, _) in quant_topk.items():
                eng = big_quant[mode]
                vals, kid = fn(q, eng.gallery, eng.gallery_scales, 10)
                rv, ri = fn(q, eng.gallery, eng.gallery_scales, 10,
                            impl="torch")
                check(torch.equal(kid, ri) and torch.equal(vals, rv),
                      f"1M {mode} engine top-10 != plain")
        ref = clip.encode_image(
            model, normalize_images(torch.from_numpy(qpx).to(dev),
                                    impl="torch"), attn_impl="torch")
        cos = float((torch.from_numpy(qvec).to(dev) * ref).sum(1).min())
        check(cos >= 0.999, f"kernel-path embed cosine to plain {cos}")
        ref8 = clip.encode_image(
            towers8.params, normalize_images(torch.from_numpy(qpx).to(dev),
                                             impl="torch"),
            attn_impl="torch", mlp_impl="torch")
        cos8 = float((torch.from_numpy(qvec8).to(dev) * ref8).sum(1).min())
        check(cos8 >= 0.999, f"int8 kernel-path embed cosine to plain {cos8}")
    say(f"phase 5 checks: engine top-10 = plain top-10 (image, text "
        f"queries; bf16 ids where separated, int8/int4 exactly); image "
        f"embed cosine to plain path: bf16 >= {cos:.6f}, int8 >= {cos8:.6f}")

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
        for mode, (fn, _) in quant_topk.items():
            eng = big_quant[mode]
            times[fn.__name__] = time_pair(
                lambda: fn(qb.float(), eng.gallery, eng.gallery_scales, 10),
                lambda: fn(qb.float(), eng.gallery, eng.gallery_scales, 10,
                           impl="torch"))
        mlp = towers8.params.visual.blocks[0].mlp
        x = torch.randn((EMBED_BATCH * 50, 768), device=dev,
                        generator=gen).to(torch.bfloat16)
        args = (x, mlp.w1.q, mlp.w1.s, mlp.w1.bias, mlp.w2.q, mlp.w2.s,
                mlp.w2.bias)
        times["mlp_int8_fused"] = time_pair(
            lambda: mlp_int8_fused(*args),
            lambda: mlp_int8_fused(*args, impl="torch"), iters=20)
        embed = {}
        for name, tw in (("bf16", towers), ("int8", towers8)):
            embed[name] = time_pair(
                lambda: tw.encode_fn(px),
                lambda: clip.encode_image(
                    tw.params, normalize_images(px, impl="torch"),
                    attn_impl="torch", mlp_impl="torch"), iters=5, warmup=2)
        # the bucket probes alone at Q=8, nprobe=128, k=10; then IVF top-10
        # end to end (centroid scores, probe, spill, merge) beside flat K1
        probe_ms, probe_bound = {}, {}
        for mode, ivf in ivfs.items():
            plist = ivf_mod.probe_lists(qc[:8], ivf, IVF_NPROBE)
            fn, args = probe_call(ivf, qc[:8], plist)
            probe_ms[IVF_RUNGS[mode]] = time_pair(
                lambda: fn(*args, 10), lambda: fn(*args, 10, impl="torch"))
            # the live rows of the distinct probed buckets, read once, and
            # their slot ids; each query scores its own buckets' live rows
            live = (ivf.bucket_ids >= 0).sum(1)
            distinct = torch.unique(plist)
            row_bytes = {"": DIM * 2, "int8": DIM + 4, "int4": DIM // 2 + 4}
            probe_bound[IVF_RUNGS[mode]] = least_ms(
                int(live[distinct].sum()) * row_bytes[mode]
                + distinct.numel() * ivf.bucket_cap * 4 + 8 * DIM * 2
                + 8 * 10 * 8,
                2 * DIM * int(live[plist.long()].sum()),
                "bf16" if mode == "" else "int8")
        times["probe_buckets"] = probe_ms["bf16"]
        times["probe_buckets_q4"] = probe_ms["int4"]
        # K9 at the dedup bench's shape, both input types; the plain
        # version scores the full square in ~1 GiB row blocks
        k9_ms = {}
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            xk = dedup_x.to(dtype)
            k9_ms[name] = time_pair(
                lambda: first_match(xk, xk, DEDUP_TAU, intra=True),
                lambda: first_match(xk, xk, DEDUP_TAU, intra=True,
                                    impl="torch"), iters=2, warmup=1)
        times["first_match"] = k9_ms["f32"]
        # the yardstick for K2: PyTorch's fused attention on the same
        # [B, H, T, hd] inputs (scale 1: q is pre-scaled); the port never
        # calls it
        qh, kh, vh = (t.view(EMBED_BATCH, 50, 12, 64).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = {"mha_short_seq": time_ms(
            lambda: sdpa(qh, kh, vh, scale=1.0), iters=20)}
        ivf_ms = {}
        for nq in (1, 8):
            for mode, ivf in ivfs.items():
                ivf_ms[(IVF_RUNGS[mode], nq)] = time_pair(
                    lambda: ivf_mod.ivf_topk(qc[:nq], ivf, k=10,
                                             nprobe=IVF_NPROBE),
                    lambda: cosine_topk(qc[:nq].to(torch.bfloat16), flat16,
                                        10))
    say(f"phase 6 times on {card}:")
    for name, (kms, pms) in times.items():
        say(f"  {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms")
    for name, (kms, pms) in embed.items():
        say(f"  ViT-B/32 {name} embed batch {EMBED_BATCH}: kernels "
            f"{EMBED_BATCH / kms * 1e3:.1f} img/s ({kms:.3f} ms), plain "
            f"{EMBED_BATCH / pms * 1e3:.1f} img/s ({pms:.3f} ms)")
    say(f"  top-10 over {GALLERY_ROWS}x{DIM} at Q=8: bf16 kernel "
        f"{times['cosine_topk'][0]:.4f} ms, int8 kernel "
        f"{times['cosine_topk_quantized'][0]:.4f} ms, int4 kernel "
        f"{times['cosine_topk_int4'][0]:.4f} ms")
    for rung, (kms, pms) in probe_ms.items():
        say(f"  IVF bucket probe {rung} ({'K8' if rung == 'int4' else 'K7'})"
            f" Q=8 nprobe={IVF_NPROBE} k=10, clustered 1M x 512 C="
            f"{IVF_CLUSTERS}: kernel {kms:.4f} ms, plain {pms:.4f} ms")
    for (rung, nq), (ims, fms) in ivf_ms.items():
        say(f"  IVF top-10 {rung} Q={nq} nprobe={IVF_NPROBE}: {ims:.4f} ms "
            f"(kernel path, end to end); flat K1 bf16 top-10 over the same "
            f"1M rows: {fms:.4f} ms")
    say(f"  IVF build 1M x 512 C={IVF_CLUSTERS}: train_centroids "
        f"{ivf_build_s['train']:.3f} s (262,144-row sample, 10 iterations); "
        + "; ".join(f"{IVF_RUNGS[m]} assign {ivf_build_s[m]['assign']:.3f} "
                    f"s, fill {ivf_build_s[m]['fill']:.3f} s"
                    for m in IVF_RUNGS)
        + f"; sidecar load (bf16, device chunks) {ivf_load_s:.3f} s")
    say("  IVF residency: " + "; ".join(
        f"{IVF_RUNGS[m]} {v.hbm_bytes() / 2 ** 20:.1f} MiB (buckets "
        f"{v.buckets.nbytes / 2 ** 20:.1f} MiB, cap {v.bucket_cap}, spill "
        f"{v.spill.nbytes / 2 ** 20:.1f} MiB)" for m, v in ivfs.items()))

    pairs = DEDUP_ROWS * (DEDUP_ROWS - 1) // 2      # the intra triangle
    for name, (kms, pms) in k9_ms.items():
        say(f"  K9 first_match {name} {DEDUP_ROWS}x{DIM} intra tau "
            f"{DEDUP_TAU}: kernel {kms:.4f} ms "
            f"({DEDUP_ROWS ** 2 / kms / 1e6:.1f} Gpairs/s as bench.py counts"
            f" N^2), plain {pms:.4f} ms ({DEDUP_ROWS ** 2 / pms / 1e6:.1f} "
            f"Gpairs/s)")
    say(f"  K2 yardstick: scaled_dot_product_attention [{EMBED_BATCH}, 12, "
        f"50, 64] bf16 {library_ms['mha_short_seq']:.4f} ms")
    w_mlp = 768 * 3072
    bounds = {   # (bytes each input read once + each output written, ops, type)
        "normalize_images": least_ms(EMBED_BATCH * 224 * 224 * 3 * 3,
                                     EMBED_BATCH * 224 * 224 * 3 * 2, "f32"),
        "mha_short_seq": least_ms(4 * EMBED_BATCH * 50 * 768 * 2,
                                  4 * EMBED_BATCH * 12 * 50 * 50 * 64, "bf16"),
        "cosine_topk": least_ms(
            GALLERY_ROWS * DIM * 2 + 8 * DIM * 2 + 8 * 80,
            2 * 8 * GALLERY_ROWS * DIM, "bf16"),
        "cosine_topk_quantized": least_ms(
            GALLERY_ROWS * (DIM + 4) + 8 * DIM * 4 + 8 * 80,
            2 * 8 * GALLERY_ROWS * DIM, "int8"),
        "cosine_topk_int4": least_ms(
            GALLERY_ROWS * (DIM // 2 + 4) + 8 * DIM * 4 + 8 * 80,
            2 * 8 * GALLERY_ROWS * DIM, "int8"),
        "mlp_int8_fused": least_ms(
            2 * EMBED_BATCH * 50 * 768 * 2 + 2 * w_mlp + (3072 + 768) * 8,
            2 * 2 * EMBED_BATCH * 50 * w_mlp, "int8"),
        "probe_buckets": probe_bound["bf16"],
        "probe_buckets_q4": probe_bound["int4"],
        "first_match": least_ms(DEDUP_ROWS * DIM * 4 + DEDUP_ROWS * 4,
                                2 * DIM * pairs, "f32"),
    }
    k9_bf16_bound = least_ms(DEDUP_ROWS * DIM * 2 + DEDUP_ROWS * 4,
                             2 * DIM * pairs, "bf16")
    other_rung = {"first_match": ("bf16", k9_bf16_bound),
                  "probe_buckets": ("int8", probe_bound["int8"])}
    for name, (ms, by) in bounds.items():
        rung, (oms, oby) = other_rung.get(name, ("", (0.0, "")))
        say(f"  bound {name}: {ms:.4f} ms ({by})"
            + (f"; {rung} {oms:.4f} ms ({oby})" if rung else ""))

    meta = {
        "cosine_topk": ("cuda", "mmrs_tpu_torch/csrc/cosine_topk.cu",
                        "mmrs_tpu/ops/topk.py:94"),
        "mha_short_seq": ("cuda", "mmrs_tpu_torch/csrc/mha_short_seq.cu",
                          "mmrs_tpu/ops/attention.py:134"),
        "normalize_images": ("triton",
                             "mmrs_tpu_torch/csrc/normalize_triton.py",
                             "mmrs_tpu/ops/preprocess.py:84"),
        "cosine_topk_quantized": ("cuda", "mmrs_tpu_torch/csrc/quant_topk.cu",
                                  "mmrs_tpu/ops/quant.py:93"),
        "cosine_topk_int4": ("cuda", "mmrs_tpu_torch/csrc/quant_topk.cu",
                             "mmrs_tpu/ops/quant4.py:149"),
        "mlp_int8_fused": ("cuda", "mmrs_tpu_torch/csrc/mlp_int8.cu",
                           "mmrs_tpu/ops/mlp_int8.py:62"),
        "probe_buckets": ("cuda", "mmrs_tpu_torch/csrc/ivf_probe.cu",
                          "mmrs_tpu/index/ivf.py:623"),
        "probe_buckets_q4": ("cuda", "mmrs_tpu_torch/csrc/ivf_probe.cu",
                             "mmrs_tpu/index/ivf.py:812"),
        "first_match": ("cuda", "mmrs_tpu_torch/csrc/first_match.cu",
                        "mmrs_tpu/ops/allpairs.py:74"),
    }
    extra = {"first_match": {   # ms/plain_ms/bound_ms above are f32's
        "bf16_ms": k9_ms["bf16"][0], "bf16_plain_ms": k9_ms["bf16"][1],
        "bf16_bound_ms": k9_bf16_bound[0],
        "gpairs_s": {n: DEDUP_ROWS ** 2 / t[0] / 1e6
                     for n, t in k9_ms.items()}}}
    say(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": where,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": library_ms.get(name), **extra.get(name, {})}
        for name, (route, source, where) in meta.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
