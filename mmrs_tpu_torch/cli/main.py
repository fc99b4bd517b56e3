"""`mmrs-torch` CLI — the search path of `mmrs`, on the PyTorch port.

  mmrs-torch index build   --root DIR --out DIR [--config cfg.yaml]
                           [--sharded]
  mmrs-torch index update  --root DIR --index DIR [--config cfg.yaml]
  mmrs-torch index compact --index DIR [--drop-class C...] [--keep-missing]
  mmrs-torch search        --index DIR (--image PATH... | --text "query"
                           --merges FILE) [-k 10] [--prototype mean]
                           [--gallery-shards N] [--gallery-quant int8|int4]
                           [--ann-nprobe N | --ann-target-recall R]
                           [--ann-clusters C] [--ann-cover F]
                           [--ann-slots-frac F]
  mmrs-torch calibrate     --index DIR --positive-class NAME [--shots 10]
                           [--gallery-shards N] [--gallery-quant int8|int4]
  mmrs-torch ann build     --index DIR [--clusters C] [--bucket-cap N]
                           [--cover F] [--slots-frac F]
                           [--target-recall R] [--gallery-quant int8|int4]
  mmrs-torch dedup         --mode exact|perceptual|embedding
                           [--reference DIR] [--target DIR] [--index DIR]
                           [--hamming 5] [--tau 0.96] [--workers 0]
                           [--gallery-shards N]
  mmrs-torch leakage       --train DIR --test DIR [--tolerance 0]
  mmrs-torch convert       --root DIR [--quality 95]   (format -> JPEG)
  mmrs-torch clean         --root DIR          (delete non-jpeg images)
  mmrs-torch rename        --root DIR          (canonical two-phase rename)
  mmrs-torch merge         --root DIR --map 'src=dst' ...
  mmrs-torch dataset make  --variant v1..v5 --root DIR --out PATH [--seed 0]
  mmrs-torch cascade       --root DIR --positive-class NAME --threshold T
                           (--class-embed FILE | --prompt P --merges FILE)
                           [--verifier none|stub|llava]
                           [--llava-checkpoint FILE --tokenizer-model FILE]
                           [--verifier-int8] [--simple-decode]
                           [--draft-checkpoint FILE] [--draft-tokens 4]
                           [--verify-batch 8] [--chunk-size N]
                           [--journal FILE] [--out CSV]
  mmrs-torch union         --root DIR --positive-class NAME --out DIR
                           (--en-embed FILE | --prompt P --merges FILE)
                           (--cn-embed FILE | --cn-prompt P --vocab FILE)
                           [--cn-checkpoint NPZ] [--cn-image-tower vit_l14]
                           [--en-threshold T] [--cn-threshold T]
  mmrs-torch weights convert --source hf_clip|openai_clip|taiyi|hf_llava
                           --arch b32|l14|7b|1b --input PATH --out NPZ
                           [--int8]
  mmrs-torch serve         --index DIR [--host H] [--port 8080]
                           [--merges FILE | --vocab FILE]
                           [--batch-window S] [--max-batch N]
                           [--concurrent-fetch] [--watch-index SEC]
                           [--gallery-shards N] [--gallery-quant ...]
                           [--ann-* ...]
                           [--verifier none|stub|llava ...]
  mmrs-torch search        --server URL (--image PATH... | --text "query")
                           [-k 10]
  mmrs-torch adapter train (--root DIR | --features NPZ) [--shots 4]
                           [--augment-epochs 5] [--epochs 20] [--lr 1e-3]
                           [--alpha 1] [--beta 1] [--search-hp]
                           [--merges FILE] [--checkpoint NPZ] [--out NPZ]
  mmrs-torch lifecycle     --root DIR --out DIR --positive-class NAME
                           [--shots 5] [--test-root DIR] [--dedup-tau T]
                           [--seed 0] [--config cfg.yaml]
  mmrs-torch parity        [--rank-gate [--rows N --queries Q --k K]]
                           [--int8-tower vit_b32|vit_l14|vit_tiny]
                           [--release DIR [--image PNG] [--llava-smoke]]
                           [--checkpoint NPZ (--merges F | --vocab F)
                            [--image PNG] [--pos-dir D --neg-dir D
                            --prompt P [--golden en|cn]]]
  mmrs-torch plan          --rows N --dim D [--chips 1] [--hbm-gb G]
                           [--nprobe 32] [--clusters C] [--slots-frac F]
                           [--spill-frac F] [--target-ms T]

The flags and output lines are those of the same `mmrs` subcommands
(mmrs_tpu/cli/main.py): the flat gallery, bf16 or quantized
(`--gallery-quant`; `--gallery-int8` is the older spelling of
`--gallery-quant int8`), or the IVF index (`--ann-*`, whose sidecar is
cached under `<index>/ivf` and prebuilt by `ann build`), on one device or
split over the first N local devices (`--gallery-shards N`: gallery rows
or IVF slot strips; for `dedup --mode embedding` the ring; `index build
--sharded` embeds over the config's mesh). Destructive
governance commands are dry runs unless given --no-dry-run. `cascade`
gates a folder with the CLIP tower and verifies the survivors with
LLaVA-v1.5-7B (`--verifier llava`: a converted npz and its
tokenizer.model; `--tp N | DxT` hosts its decoder tensor-parallel over
N local devices, or D data rows of T). `union` is
the bilingual report: an EN CLIP pair and the CN Taiyi pair score one
folder (`--cn-checkpoint`: the npz of {"visual", "text", "logit_scale"}).
`weights convert` turns a released state dict (.pt / .bin / .safetensors
or an HF model directory) into the npz both packages load, without JAX;
it checks its flags before it reads a byte of weights. `serve` puts the
engine and the towers (and a verifier) behind the JSON API of
mmrs_tpu_torch/serve.py; `search --server` is its thin HTTP client.
`adapter train` is the Tip-Adapter(-F) few-shot workflow, from an image
folder through the towers or from a features npz. `lifecycle` runs the
whole reference workflow over a labeled tree (mmrs_tpu_torch/
lifecycle.py); `parity` is the real-weight and rank-parity gate
(eval/parity.py); `plan` predicts every residency rung's device memory
and Q=1 latency before a gallery is built (plan.py, constants fitted on
an H100). The towers,
the gallery, the embedding dedup and the verifier run on the GPU (the
kernels build there on first use); MMRS_TORCH_DEVICE=cpu puts them on the
CPU, and without a GPU nothing else does.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def _load_config(path: Optional[str]):
    from mmrs_tpu_torch import config as config_mod

    return config_mod.load(path) if path else config_mod.Config()


def _make_tokenizer(args, cfg):
    """Optional tokenizer from CLI file flags (--merges / --vocab)."""
    if getattr(args, "merges", None):
        from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer

        return CLIPTokenizer.from_file(args.merges)
    if getattr(args, "vocab", None):
        from mmrs_tpu_torch.models.tokenizer import BertWordPieceTokenizer

        return BertWordPieceTokenizer.from_vocab_file(args.vocab)
    return None


def _quant_mode(args) -> str:
    """--gallery-quant (preferred) / --gallery-int8 (back-compat) -> the
    SearchEngine quantize mode."""
    mode = getattr(args, "gallery_quant", "") or ""
    if not mode and getattr(args, "gallery_int8", False):
        mode = "int8"
    return mode


def _add_quant_flags(parser) -> None:
    parser.add_argument("--gallery-int8", action="store_true",
                        help="int8 gallery rows + per-row scales: half the "
                             "device memory (same as --gallery-quant int8)")
    parser.add_argument("--gallery-quant", choices=("int8", "int4"),
                        default="",
                        help="gallery residency ladder: int8 (2x rows per "
                             "device) or int4 (4x rows, packed nibbles); "
                             "supersedes --gallery-int8")


def _add_ann_flags(parser) -> None:
    parser.add_argument("--ann-nprobe", type=int, default=0,
                        help="enable IVF ANN search probing N clusters "
                             "per query (sub-linear; nprobe == clusters "
                             "is exact; 0 = exact scan)")
    parser.add_argument("--ann-target-recall", type=float, default=0.0,
                        help="measure recall on a gallery sample at start "
                             "and pick the smallest nprobe reaching this "
                             "(tuned value persists in the IVF sidecar); "
                             "mutually exclusive with --ann-nprobe")
    parser.add_argument("--ann-cover", type=float, default=0.98,
                        help="IVF auto-cap slot budget: fraction of rows "
                             "held in buckets (the rest spill to the exact "
                             "scan)")
    parser.add_argument("--ann-slots-frac", type=float, default=1.3,
                        help="IVF total-slots ceiling (x rows)")
    parser.add_argument("--ann-clusters", type=int, default=0,
                        help="IVF cluster count (0 = auto, pow2 near "
                             "sqrt(rows)); implies IVF when set")


def _add_shards_flag(parser, what: str = "gallery rows") -> None:
    parser.add_argument("--gallery-shards", type=int, default=1,
                        help=f"shard {what} over the first N local "
                             "devices (on the CPU: N CPU entries)")


def _gallery_mesh(args):
    """The data mesh of --gallery-shards N over the first N local devices
    (parallel/mesh.py): None for N = 1, 2 (the exit code) on a usage
    error."""
    shards = getattr(args, "gallery_shards", 1)
    if shards < 1:
        print(f"--gallery-shards must be >= 1, got {shards}",
              file=sys.stderr)
        return 2
    if shards == 1:
        return None
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.parallel.mesh import local_devices, make_mesh

    devices = local_devices(shards)
    if len(devices) < shards:
        print(f"--gallery-shards {shards} needs {shards} local "
              f"devices; {len(devices)} available", file=sys.stderr)
        return 2
    return make_mesh(MeshConfig(data_size=shards, model_size=1),
                     devices[:shards])


def _make_engine(args, cfg, idx):
    """SearchEngine from the --gallery-shards, --gallery-quant and --ann-*
    flags: rows (or IVF slot strips) over a data mesh of the first N
    local devices; 2 (the exit code) on a usage error."""
    import dataclasses

    from mmrs_tpu_torch.search.engine import SearchEngine

    mesh = _gallery_mesh(args)
    if mesh == 2:
        return 2
    nprobe = getattr(args, "ann_nprobe", 0)
    clusters = getattr(args, "ann_clusters", 0)
    target = getattr(args, "ann_target_recall", 0.0)
    if target and nprobe:
        print("--ann-target-recall and --ann-nprobe are mutually "
              "exclusive (the target MEASURES an nprobe)", file=sys.stderr)
        return 2
    search_cfg = cfg.search
    if nprobe or clusters or target:
        search_cfg = dataclasses.replace(
            cfg.search, ann="ivf",
            ann_clusters=max(clusters, 0),
            ann_nprobe=max(nprobe, 0),
            ann_target_recall=max(target, 0.0),
            ann_cover=getattr(args, "ann_cover", 0.98),
            ann_slots_frac=getattr(args, "ann_slots_frac", 1.3))
    return SearchEngine(idx, search_cfg, mesh=mesh,
                        quantize=_quant_mode(args))


def cmd_index_build(args) -> int:
    from mmrs_tpu_torch.index.gallery import build_index
    from mmrs_tpu_torch.io.dataset import FolderDataset
    from mmrs_tpu_torch.pipeline import build_towers

    cfg = _load_config(args.config)
    towers = build_towers(cfg)
    encode = towers.image_encode
    if args.sharded:
        from mmrs_tpu_torch.parallel import make_mesh
        from mmrs_tpu_torch.parallel.embed import make_sharded_encoder
        from mmrs_tpu_torch.parallel.mesh import local_devices

        model = max(1, cfg.mesh.model_size)
        devices = local_devices(cfg.mesh.data_size * model
                                if cfg.mesh.data_size > 0 else None)
        if len(devices) > 1:
            mesh = make_mesh(cfg.mesh, devices)
            encode = make_sharded_encoder(towers.params_encode_fn,
                                          towers.params, mesh,
                                          cfg.gallery.batch_size)
        else:
            print("--sharded requested but only one device; using it",
                  file=sys.stderr)
    vision = towers.clip_config.vision
    ds = FolderDataset.from_root(args.root, num_workers=args.workers,
                                 image_size=vision.image_size,
                                 stack=vision.stack)
    idx = build_index(ds, encode, args.out,
                      batch_size=cfg.gallery.batch_size,
                      shard_rows=cfg.gallery.shard_rows,
                      resume=not args.no_resume)
    print(json.dumps({"entries": len(idx), "dim": idx.dim, "out": args.out}))
    return 0


def cmd_index_update(args) -> int:
    """Incremental index update: embed only new images, append shards."""
    from mmrs_tpu_torch.index.gallery import update_index
    from mmrs_tpu_torch.io.dataset import FolderDataset
    from mmrs_tpu_torch.pipeline import build_towers

    cfg = _load_config(args.config)
    towers = build_towers(cfg)
    vision = towers.clip_config.vision
    ds = FolderDataset.from_root(args.root, num_workers=args.workers,
                                 image_size=vision.image_size,
                                 stack=vision.stack)
    idx = update_index(ds, towers.image_encode, args.index,
                       batch_size=cfg.gallery.batch_size,
                       shard_rows=cfg.gallery.shard_rows)
    print(f"index now has {len(idx)} rows")
    return 0


def cmd_index_compact(args) -> int:
    """Drop rows for deleted files (and/or whole classes) from an index."""
    from mmrs_tpu_torch.index.gallery import compact_index

    drop = set(args.drop_class)
    keep = (lambda p, c: c not in drop) if drop else None
    idx = compact_index(args.index, keep=keep,
                        drop_missing=not args.keep_missing)
    print(f"index now has {len(idx)} rows")
    return 0


def cmd_ann_build(args) -> int:
    """Prebuild (or refresh) the IVF sidecar so the first engine start
    loads it instead of running k-means; prints the cluster / capacity /
    spill figures, and with --target-recall tunes nprobe and keeps it."""
    import dataclasses
    import os

    from mmrs_tpu_torch.index import ivf as ivf_mod
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.search.engine import SearchEngine

    cfg = _load_config(args.config)
    idx = GalleryIndex.load(args.index)
    search_cfg = dataclasses.replace(
        cfg.search, ann="ivf",
        ann_clusters=max(args.clusters, 0),
        ann_bucket_cap=max(args.bucket_cap, 0),
        ann_cover=args.cover, ann_slots_frac=args.slots_frac,
        ann_target_recall=max(args.target_recall, 0.0),
        ann_nprobe=0)
    # the engine's load-or-extend-or-build-and-save path IS the build
    eng = SearchEngine(idx, search_cfg, quantize=_quant_mode(args))
    ivf = eng.ivf
    spill = int((ivf.spill_ids >= 0).sum())
    out = {
        "index": args.index,
        "rows": ivf.n_total,
        "clusters": ivf.n_clusters,
        "bucket_cap": ivf.bucket_cap,
        "spill_rows": spill,
        "spill_frac": round(spill / max(ivf.n_total, 1), 4),
        "quant": ivf.quant or "bf16",
        "hbm_gb": round(ivf.hbm_bytes() / 1e9, 3),
        "sidecar": (ivf_mod.sidecar_meta(
            os.path.join(idx.directory, "ivf")) is not None
            if idx.directory else False),
    }
    if args.target_recall > 0:
        out["tuned_nprobe"] = eng.config.ann_nprobe
    print(json.dumps(out))
    if out["spill_frac"] > 0.05:
        print(f"note: {out['spill_frac']:.1%} of rows spill — small-Q "
              "latency pays an exact scan of them every query; consider "
              f"--slots-frac above {args.slots_frac} (needs int8/int4 "
              "device-memory headroom)", file=sys.stderr)
    return 0


def _search_via_server(args) -> int:
    """Thin HTTP client for a running `mmrs-torch serve` (or `mmrs serve`):
    no towers and no gallery upload per invocation; the queries take the
    server's micro-batched path like any other client."""
    import base64
    import urllib.error
    import urllib.request

    url = args.server.rstrip("/") + "/v1/search"
    if args.image:
        blobs = []
        for p in args.image:
            with open(p, "rb") as f:
                blobs.append(base64.b64encode(f.read()).decode())
        body = {"images_b64": blobs, "k": args.k}
    elif args.text:
        body = {"text": args.text, "k": args.k}
    else:
        print("need --image or --text", file=sys.stderr)
        return 2
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
    except urllib.error.URLError as e:
        print(f"server {args.server} unreachable: {e}", file=sys.stderr)
        return 2
    results = out.get("hits", out)
    for qi, qhits in enumerate(results):
        for h in qhits:
            print(f"{qi}\t{h['rank']}\t{h['score']:.4f}\t{h['cls']}\t"
                  f"{h['path']}")
    return 0


def cmd_search(args) -> int:
    if args.server:
        return _search_via_server(args)
    if not args.index:
        print("need --index (local engine) or --server URL",
              file=sys.stderr)
        return 2
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.io.images import load_image
    from mmrs_tpu_torch.pipeline import build_towers

    cfg = _load_config(args.config)
    idx = GalleryIndex.load(args.index)
    engine = _make_engine(args, cfg, idx)
    if engine == 2:
        return 2
    towers = build_towers(cfg, tokenizer=_make_tokenizer(args, cfg))

    if args.image:
        vision = towers.clip_config.vision
        loaded = [load_image(p, vision.image_size, vision.stack)
                  for p in args.image]
        bad = [p for p, r in zip(args.image, loaded) if not r.ok]
        if bad:
            print("could not decode query image(s): " + ", ".join(bad),
                  file=sys.stderr)
            return 2
        vecs = towers.image_encode(np.stack([r.pixels for r in loaded]))
        if args.prototype and len(args.image) > 1:
            hits = engine.query_prototype(vecs, strategy=args.prototype,
                                          top_k=args.k)
        else:
            hits = engine.query_image(vecs, top_k=args.k)
    elif args.text:
        if towers.text_encode is None:
            print("text search needs a tokenizer (--merges/--vocab)",
                  file=sys.stderr)
            return 2
        hits = engine.query_text(towers.text_encode([args.text]),
                                 top_k=args.k)
    else:
        print("need --image or --text", file=sys.stderr)
        return 2

    for qi, qhits in enumerate(hits):
        for h in qhits:
            print(f"{qi}\t{h.rank}\t{h.score:.4f}\t{h.cls}\t{h.path}")
    return 0


def cmd_calibrate(args) -> int:
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.search.prototypes import build_prototype

    cfg = _load_config(args.config)
    if getattr(args, "ann_nprobe", 0) or getattr(args, "ann_clusters", 0):
        # sweep_class needs full similarity rows; ANN only keeps buckets
        print("calibration scans every row; rerun without "
              "--ann-nprobe/--ann-clusters", file=sys.stderr)
        return 2
    idx = GalleryIndex.load(args.index)
    engine = _make_engine(args, cfg, idx)
    if engine == 2:
        return 2
    labels = np.asarray([c == args.positive_class for c in idx.classes])
    if not labels.any():
        print(f"no rows of class {args.positive_class!r}", file=sys.stderr)
        return 2
    # only the k shot rows leave the memmap; sims + sweep stay on device
    shot_rows = np.flatnonzero(labels)[: args.shots]
    shots = np.asarray(idx.embeddings[shot_rows], np.float32)
    proto = build_prototype(shots, strategy=args.prototype)
    res = engine.sweep_class(proto, labels, calib_config=cfg.calibration)
    print(json.dumps({
        "class": args.positive_class,
        "best_threshold": res.best_threshold,
        "best_f1": res.best_f1,
        "precision": res.best_precision,
        "recall": res.best_recall,
    }))
    return 0


def _collect(root: str) -> List[str]:
    from mmrs_tpu_torch.io.dataset import scan_folder

    return [p for p, _ in scan_folder(root)]


def cmd_dedup(args) -> int:
    from mmrs_tpu_torch.govern import dedup as dd

    need = {"exact": ("reference", "target"), "perceptual": ("target",),
            "embedding": ("index",)}.get(args.mode, ())
    missing = [f"--{n}" for n in need if not getattr(args, n, None)]
    if missing:
        print(f"dedup --mode {args.mode} needs {' and '.join(missing)}",
              file=sys.stderr)
        return 2
    dry = not args.no_dry_run
    if args.mode == "exact":
        rep = dd.exact_dedup(_collect(args.reference), _collect(args.target),
                             dry_run=dry, workers=args.workers)
    elif args.mode == "perceptual":
        rep = dd.perceptual_dedup(_collect(args.target),
                                  threshold=args.hamming, dry_run=dry,
                                  workers=args.workers)
    else:
        from mmrs_tpu_torch.index.gallery import GalleryIndex

        idx = GalleryIndex.load(args.index)
        # --gallery-shards > 1: the O(N^2) scan rides the ring (parallel/
        # dedup.py), one [N/S, D] visiting block resident a device
        mesh = _gallery_mesh(args) if args.gallery_shards > 1 else None
        if mesh == 2:
            return 2
        rep = dd.embedding_dedup(np.asarray(idx.embeddings, np.float32),
                                 idx.paths, tau=args.tau, dry_run=dry,
                                 mesh=mesh)
    print(rep.summary())
    for dup, keeper in rep.duplicates:
        print(f"DUP\t{dup}\t-> keeper {keeper}")
    return 0


def cmd_leakage(args) -> int:
    from mmrs_tpu_torch.govern.dedup import leakage_removal

    rep = leakage_removal(_collect(args.train), _collect(args.test),
                          tolerance=args.tolerance,
                          dry_run=not args.no_dry_run)
    print(rep.summary())
    for dup, src in rep.duplicates:
        print(f"LEAK\t{dup}\t(matches test {src})")
    return 0


def cmd_convert(args) -> int:
    from mmrs_tpu_torch.govern.normalize import convert_to_jpeg

    rep = convert_to_jpeg(args.root, quality=args.quality,
                          dry_run=not args.no_dry_run)
    print(f"{len(rep.converted)} converted, {len(rep.errors)} errors "
          f"(dry_run={rep.dry_run})")
    return 0


def cmd_clean(args) -> int:
    from mmrs_tpu_torch.govern.normalize import delete_non_jpeg

    rep = delete_non_jpeg(args.root, dry_run=not args.no_dry_run)
    print(f"{len(rep.deleted)} deleted (dry_run={rep.dry_run})")
    return 0


def cmd_rename(args) -> int:
    from mmrs_tpu_torch.govern.manifest import canonical_rename

    rep = canonical_rename(args.root, dry_run=not args.no_dry_run)
    print(f"{len(rep.renamed)} renamed (dry_run={rep.dry_run})")
    return 0


def cmd_merge(args) -> int:
    from mmrs_tpu_torch.govern.manifest import merge_folders

    mapping = dict(kv.split("=", 1) for kv in args.map)
    rep = merge_folders(args.root, mapping, dry_run=not args.no_dry_run)
    print(f"{len(rep.moved)} moved (dry_run={rep.dry_run})")
    return 0


def cmd_dataset_make(args) -> int:
    from mmrs_tpu_torch.govern import vqa
    from mmrs_tpu_torch.io.dataset import scan_folder

    by_class: dict = {}
    for p, c in scan_folder(args.root):
        by_class.setdefault(c, []).append(p)
    easy = by_class.pop("ez_negative", [])
    hard = {c[: -len("_negative")]: v for c, v in list(by_class.items())
            if c.endswith("_negative")}
    for c in list(by_class):
        if c.endswith("_negative"):
            del by_class[c]

    if args.variant == "v1":
        recs = vqa.build_v1(by_class, args.out, seed=args.seed)
    elif args.variant == "v2":
        recs = vqa.build_v2(by_class, args.out, seed=args.seed)
    elif args.variant == "v3":
        recs = vqa.build_v3(by_class, easy, args.out, seed=args.seed)
    elif args.variant == "v4":
        out = vqa.build_v4(by_class, easy, hard, out_dir=args.out,
                           seed=args.seed)
        print(json.dumps({k: len(getattr(out, k)) for k in
                          ("positives", "with_cross", "with_simple",
                           "with_hard")}))
        return 0
    else:
        recs = vqa.build_v5(by_class, out_path=args.out, seed=args.seed)
    print(json.dumps({"records": len(recs), "out": args.out}))
    return 0


def cmd_union(args) -> int:
    """Bilingual union governance report (CLIP/union_dataset.py flow)."""
    import dataclasses

    from mmrs_tpu_torch import config as config_mod
    from mmrs_tpu_torch.govern.bilingual import bilingual_union
    from mmrs_tpu_torch.pipeline import build_towers

    cfg = _load_config(args.config)

    en_tok = cn_tok = None
    if args.merges:
        from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer

        en_tok = CLIPTokenizer.from_file(args.merges)
    if args.vocab:
        from mmrs_tpu_torch.models.tokenizer import BertWordPieceTokenizer

        cn_tok = BertWordPieceTokenizer.from_vocab_file(args.vocab)

    en_towers = build_towers(cfg, tokenizer=en_tok)
    cn_cfg = dataclasses.replace(cfg, model=config_mod.ModelConfig(
        image_tower=args.cn_image_tower, text_tower="taiyi_roberta",
        dtype=cfg.model.dtype,
        checkpoint_path=args.cn_checkpoint,
    ))
    cn_towers = build_towers(cn_cfg, tokenizer=cn_tok)

    def _template(template: str) -> str:
        return (template.format(args.positive_class)
                if "{}" in template else template)

    def _class_embed(npy_path, prompt, towers, which):
        """Class text embedding: --*-embed npy, or computed on the spot
        from --prompt/--cn-prompt (or config.prompts) through the text
        tower — the CLIP/union_dataset.py:263-425 ergonomics."""
        if npy_path:
            return np.load(npy_path)
        tpl = prompt or cfg.prompts.get(args.positive_class)
        if tpl is None or towers.text_encode is None:
            print(f"{which}: need --{which}-embed, or a prompt "
                  f"(--prompt/--cn-prompt or config.prompts) plus a "
                  f"tokenizer (--merges/--vocab)", file=sys.stderr)
            raise SystemExit(2)
        return towers.text_encode([_template(tpl)])[0]

    en_embed = _class_embed(args.en_embed, args.prompt, en_towers, "en")
    cn_embed = _class_embed(args.cn_embed, args.cn_prompt, cn_towers, "cn")

    res = bilingual_union(
        args.root, args.positive_class,
        en_encode=en_towers.image_encode, en_text_embed=en_embed,
        cn_encode=cn_towers.image_encode, cn_text_embed=cn_embed,
        out_root=args.out,
        en_threshold=args.en_threshold, cn_threshold=args.cn_threshold,
    )
    print(json.dumps({
        "class": res.cls,
        "en_threshold": res.en_threshold, "cn_threshold": res.cn_threshold,
        "union_pass": res.report.union_pass if res.report else None,
        "f1": res.report.metrics.f1 if res.report else None,
    }))
    return 0


def _load_torch_state_dict(path: str):
    """A single .pt/.bin/.safetensors file, or an HF model directory
    (models/release.py's loaders: index-json shard merges, TorchScript
    archives, BF16 safetensors)."""
    import os

    from mmrs_tpu_torch.models import release

    if os.path.isdir(path):
        return release.load_model_dir_state(path)
    if path.endswith(".safetensors"):
        return release.read_safetensors(path)
    return release.load_torch_state(path)


def cmd_weights_convert(args) -> int:
    from mmrs_tpu_torch.models import checkpoint, convert
    from mmrs_tpu_torch.models.configs import (CLIP_TEXT_B32, CLIP_TEXT_L14,
                                               TAIYI_ROBERTA_LARGE, VIT_B32,
                                               VIT_L14, VIT_L14_336)
    from mmrs_tpu_torch.models import quantize

    # flag validation BEFORE the (potentially multi-GB) state-dict load
    if args.source == "hf_llava" and args.arch not in ("7b", "1b"):
        print("--source hf_llava needs --arch 7b or 1b", file=sys.stderr)
        return 2
    if args.source != "hf_llava" and args.arch not in ("b32", "l14"):
        print(f"--source {args.source} needs --arch b32 or l14",
              file=sys.stderr)
        return 2
    if args.int8 and args.source == "taiyi":
        print("--int8 applies to clip/llava sources only", file=sys.stderr)
        return 2

    sd = convert.state_dict_to_numpy(_load_torch_state_dict(args.input))
    if args.source == "hf_llava":
        from mmrs_tpu_torch.models.llama import LLAMA2_7B, LLAMA_1B
        from mmrs_tpu_torch.models.llava import LLaVAConfig

        lm = LLAMA2_7B if args.arch == "7b" else LLAMA_1B
        params = convert.hf_llava(sd, LLaVAConfig(vision=VIT_L14_336, lm=lm))
        if args.int8:
            params = quantize.quantize_llava_tree(params)
    else:
        vision = VIT_B32 if args.arch == "b32" else VIT_L14
        text = CLIP_TEXT_B32 if args.arch == "b32" else CLIP_TEXT_L14
        if args.source == "hf_clip":
            params = convert.hf_clip(sd, vision, text)
        elif args.source == "openai_clip":
            params = convert.openai_clip(sd, vision, text)
        elif args.source == "taiyi":
            params = convert.hf_bert_classifier(sd, TAIYI_ROBERTA_LARGE)
        else:
            print(f"unknown source {args.source}", file=sys.stderr)
            return 2
        if args.int8:
            params = quantize.quantize_clip_visual_tree(params)
    checkpoint.save_npz(params, args.out)
    print(json.dumps({"out": args.out, "int8": bool(args.int8)}))
    return 0


def cmd_cascade(args) -> int:
    """OR-gate cascade over a folder (code/union_clip_llava2.py flow):
    each image's score is its tower embedding's similarity to a class
    embedding; the verifier (default none: gate only) confirms the
    survivors."""
    from mmrs_tpu_torch.cascade import CascadePipeline
    from mmrs_tpu_torch.cascade.verifier import speculative_stats_of
    from mmrs_tpu_torch.io.dataset import FolderDataset
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.utils.logging import get_logger

    cfg = _load_config(args.config)
    towers = build_towers(cfg, tokenizer=_make_tokenizer(args, cfg))
    ds = FolderDataset.from_root(args.root)
    paths = [p for p, _ in ds.samples]
    labels = [c == args.positive_class for _, c in ds.samples]

    if args.class_embed:
        embed = np.load(args.class_embed)
    else:
        tpl = args.prompt or cfg.prompts.get(args.positive_class)
        if tpl is None or towers.text_encode is None:
            print("need --class-embed, or --prompt/config.prompts plus a "
                  "tokenizer (--merges/--vocab)", file=sys.stderr)
            return 2
        if "{}" in tpl:
            tpl = tpl.format(args.positive_class)
        embed = towers.text_encode([tpl])[0]
    embed = embed / np.linalg.norm(embed)
    log = get_logger("cli")

    def scorer(ps):
        sub = FolderDataset([(p, "") for p in ps])
        sims = []
        for batch in sub.batches(128):
            e = towers.image_encode(batch.pixels)
            e = e / np.linalg.norm(e, axis=1, keepdims=True)
            s = np.asarray((e @ embed) * cfg.search.logit_scale, np.float32)
            # quarantined (corrupt) images decode to zero pixels: score
            # them -inf so they can never pass the gate
            if not batch.ok.all():
                for p, o in zip(batch.paths, batch.ok):
                    if not o:
                        log.warning("corrupt image excluded from cascade "
                                    "gate: %s", p)
                s = np.where(batch.ok, s, -np.inf)
            sims.extend(s)
        return sims

    verifier = _make_verifier(args)
    if verifier == 2:
        return 2
    pipe = CascadePipeline(en_scorer=scorer, en_threshold=args.threshold,
                           verifier=verifier)
    if args.chunk_size or args.journal:
        # bounded-memory streaming, verify packs of --verify-batch in
        # flight while the next chunk is gated; --journal makes the run
        # crash-resumable
        res = pipe.run_streaming(paths, args.positive_class, labels=labels,
                                 chunk_size=args.chunk_size or 224,
                                 verify_batch=args.verify_batch,
                                 journal=args.journal)
    else:
        res = pipe.run(paths, args.positive_class, labels=labels)
    print(res.summary())
    spec = speculative_stats_of(verifier)
    if spec is not None:
        print(f"speculative: {spec['tokens']} tokens in {spec['rounds']} "
              f"rounds, slot utilization {spec['utilization']:.2f}")
    if args.out:
        res.write_csv(args.out)
        print(f"audit csv: {args.out}")
    return 0


def _add_verifier_flags(parser) -> None:
    """The cascade verifier's flags (mmrs_tpu's `_add_verifier_flags`)."""
    parser.add_argument("--verifier", default="none",
                        choices=["none", "stub", "llava"])
    parser.add_argument("--llava-checkpoint",
                        help="converted llava npz (mmrs_tpu's format)")
    parser.add_argument("--tokenizer-model",
                        help="SentencePiece tokenizer.model for the verifier")
    parser.add_argument("--verify-batch", type=int, default=8,
                        help="fixed batch of the VLM verify packs")
    parser.add_argument("--simple-decode", action="store_true",
                        help="no chunked prefill and a bf16 KV cache")
    parser.add_argument("--verifier-int8", action="store_true",
                        help="int8 serving weights for the verifier, with "
                             "an int8 KV cache (the reference's load_8bit)")
    parser.add_argument("--draft-checkpoint",
                        help="converted 1.1B-class draft VLM npz (the same "
                             "336/14 vision grid and llama tokenizer): "
                             "speculative decode with the 7B verifier's "
                             "greedy output")
    parser.add_argument("--draft-tokens", type=int, default=4,
                        help="draft tokens proposed per speculation round")
    parser.add_argument("--tp", default="1",
                        help="verifier mesh: N (decoder tensor-parallel over "
                             "N devices) or DxT (batch-DP x decoder-TP)")


def _verifier_mesh(args):
    """The verifier's mesh from --tp N | DxT (N = 1xN, decoder TP only;
    DxT = batch-DP x decoder-TP over D*T local devices): None for one
    device, or the int 2 after the message. The device count and the
    Megatron divisibility of the 7B decoder are checked here, before any
    checkpoint is read."""
    spec = str(getattr(args, "tp", "1")).lower()
    try:
        dp, tp = spec.split("x", 1) if "x" in spec else (1, spec)
        dp, tp = int(dp), int(tp)
    except ValueError:
        print(f"--tp must be N or DxT, got {spec!r}", file=sys.stderr)
        return 2
    if dp < 1 or tp < 1:
        print(f"--tp sizes must be >= 1, got {spec!r}", file=sys.stderr)
        return 2
    if dp * tp == 1:
        return None
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.models.llama import LLAMA2_7B
    from mmrs_tpu_torch.parallel.mesh import local_devices, make_mesh
    from mmrs_tpu_torch.parallel.vlm import draft_tp_divisible

    devices = local_devices(dp * tp)     # this process's cards only
    if len(devices) < dp * tp:
        print(f"--tp {spec} needs {dp * tp} local devices; "
              f"{len(devices)} available", file=sys.stderr)
        return 2
    mesh = make_mesh(MeshConfig(data_size=dp, model_size=tp),
                     devices[:dp * tp])
    if not draft_tp_divisible(LLAMA2_7B, mesh):
        print(f"--tp {spec} does not divide the 7B decoder's "
              f"heads/kv-heads/mlp/vocab ({LLAMA2_7B.heads}/"
              f"{LLAMA2_7B.kv_heads}/{LLAMA2_7B.mlp_dim}/"
              f"{LLAMA2_7B.vocab_size})", file=sys.stderr)
        return 2
    return mesh


def _make_verifier(args):
    """The cascade verifier from CLI flags: None, a verifier, or the int 2
    (the exit code) on a usage error."""
    kind = getattr(args, "verifier", "none")
    if kind == "stub":
        from mmrs_tpu_torch.cascade import StubVerifier

        return StubVerifier()
    if kind != "llava":
        return None
    if not (args.llava_checkpoint and args.tokenizer_model):
        print("--verifier llava needs --llava-checkpoint and "
              "--tokenizer-model", file=sys.stderr)
        return 2
    mesh = _verifier_mesh(args)
    if isinstance(mesh, int):
        return mesh
    import torch

    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.models import checkpoint, convert_jax
    from mmrs_tpu_torch.models.configs import VIT_L14_336
    from mmrs_tpu_torch.models.llama import LLAMA2_7B, LLAMA_1B
    from mmrs_tpu_torch.models.llava import LLaVAConfig
    from mmrs_tpu_torch.models.quantize import quantize_llava
    from mmrs_tpu_torch.models.sentencepiece import SentencePieceBPE
    from mmrs_tpu_torch.pipeline import default_device

    dev = default_device()

    def load(path, lm):
        model = convert_jax.from_jax_llava(
            checkpoint.load_npz(path), LLaVAConfig(vision=VIT_L14_336, lm=lm),
            device=dev)
        return quantize_llava(model) if args.verifier_int8 else model

    if mesh is None:
        vparams = load(args.llava_checkpoint, LLAMA2_7B)
    else:
        # stream the checkpoint straight into its TP placement: the host
        # holds one array at a time, never the whole 7B
        from mmrs_tpu_torch.parallel.vlm import (llava_checkpoint_placement,
                                                 llava_from_placed,
                                                 quantize_mesh_llava)

        vparams = llava_from_placed(
            checkpoint.load_npz(args.llava_checkpoint,
                                placement=llava_checkpoint_placement(mesh)),
            LLaVAConfig(vision=VIT_L14_336, lm=LLAMA2_7B), mesh)
        if args.verifier_int8:
            quantize_mesh_llava(vparams)
    dparams = dcfg = None
    if args.draft_checkpoint:
        dparams = load(args.draft_checkpoint, LLAMA_1B)
        dcfg = dparams.cfg
    tok = SentencePieceBPE.from_file(args.tokenizer_model)
    # the serving config: chunked prefill (64-token chunks through K10),
    # int8 KV with int8 weights, early stop; --simple-decode opts out
    fast = not args.simple_decode
    return LLaVAVerifier(
        vparams, vparams.cfg, tok,
        kv_dtype=(torch.int8 if args.verifier_int8 and fast else None),
        prefill_chunk=64 if fast else None,
        draft_params=dparams, draft_cfg=dcfg,
        draft_tokens=args.draft_tokens, device=dev, mesh=mesh)


def cmd_serve(args) -> int:
    """Serve the query engine over HTTP (mmrs_tpu_torch/serve.py)."""
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.serve import SearchService, make_server

    cfg = _load_config(args.config)
    idx = GalleryIndex.load(args.index)
    engine = _make_engine(args, cfg, idx)
    if engine == 2:
        return 2
    towers = build_towers(cfg, tokenizer=_make_tokenizer(args, cfg))
    verifier = _make_verifier(args)
    if verifier == 2:
        return 2
    engine_factory = None
    if args.watch_index > 0:
        def engine_factory():
            e = _make_engine(args, cfg, GalleryIndex.load(args.index))
            if e == 2:
                raise RuntimeError("engine rebuild failed")
            return e

    service = SearchService(engine, towers, verifier=verifier,
                            verify_batch=args.verify_batch,
                            logit_scale=cfg.search.logit_scale,
                            max_batch=args.max_batch,
                            batch_window=args.batch_window,
                            serialize_fetch=not args.concurrent_fetch,
                            engine_factory=engine_factory,
                            watch_interval=args.watch_index)
    server = make_server(service, host=args.host, port=args.port)
    print(f"serving {len(idx)} rows on http://{args.host}:{args.port} "
          f"(POST /v1/search, POST /v1/verify, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


def cmd_plan(args) -> int:
    """Residency/latency planner over the quant x flat/IVF ladder:
    capacity math before a gallery is built, in place of the reference's
    discover-OOM-at-load workflow (code/search_image.py:142-165)."""
    from mmrs_tpu_torch.plan import plan

    report = plan(args.rows, args.dim, chips=args.chips, hbm_gb=args.hbm_gb,
                  nprobe=args.nprobe, clusters=args.clusters,
                  slots_frac=args.slots_frac, spill_frac=args.spill_frac,
                  target_ms=args.target_ms)
    print(report.render())
    return 0 if report.recommended is not None else 1


def cmd_lifecycle(args) -> int:
    """The whole reference workflow in one run (mmrs_tpu_torch/
    lifecycle.py): normalize-report -> index -> calibrate -> union ->
    cascade(journal) -> dedup/leakage -> VQA v4. Destructive stages stay
    dry-run."""
    from mmrs_tpu_torch.lifecycle import run_lifecycle

    cfg = _load_config(args.config)
    manifest = run_lifecycle(
        args.root, args.out, args.positive_class, cfg=cfg,
        shots=args.shots, test_root=args.test_root,
        dedup_tau=args.dedup_tau, seed=args.seed)
    print(json.dumps(manifest["cross_checks"] | {
        "out": args.out,
        "index_rows": manifest["index"]["rows"],
        "best_threshold": manifest["calibrate"]["best_threshold"],
        "union_pass": manifest["union"]["union_pass"],
        "gate_passed": manifest["cascade"]["gate_passed"],
        "duplicates": manifest["dedup"]["duplicates"],
        "vqa_positives": manifest["vqa"]["positives"],
    }))
    return 0


def cmd_parity(args) -> int:
    """Real-weight parity gate.

    Independent checks; run whichever the available inputs allow:
      --release DIR [--image]     the drop-in gate over downloaded releases
      --rank-gate                 bf16-vs-f32 top-k rank parity on a
                                  synthetic gallery (no weights needed)
      --int8-tower TOWER          int8-vs-f32 tower geometry gate
      --checkpoint + --image      reproduce code/test_clip.py:18 smoke probs
      --checkpoint + --pos-dir/--neg-dir + --prompt [--golden en|cn]
                                  reproduce the notebook lychee thresholds
    """
    from mmrs_tpu_torch.eval import parity

    report = {}
    ok = True

    if args.release:
        rep = parity.release_gate(
            args.release, image=args.image, pos_dir=args.pos_dir,
            neg_dir=args.neg_dir, prompt=args.prompt, golden=args.golden,
            logit_scale=_load_config(args.config).search.logit_scale,
            llava_smoke=args.llava_smoke)
        report["release"] = rep
        ok &= rep["ok"]

    if args.rank_gate:
        r = parity.rank_parity_report(n=args.rows, queries=args.queries,
                                      k=args.k)
        report["rank_gate"] = {
            "n": r.n, "k": r.k, "exact_queries": r.exact_queries,
            "tie_flips": r.tie_flips, "violations": r.violations,
            "planted_exact": r.planted_exact, "ok": r.ok,
        }
        ok &= r.ok

    if args.int8_tower:
        # int8 serving-tower geometry gate: embedding cosine vs the f32
        # tower and top-1 retrieval agreement, on the device (K6 and K2)
        import torch

        from mmrs_tpu_torch.models import convert_jax
        from mmrs_tpu_torch.models.clip import pair_config
        from mmrs_tpu_torch.pipeline import default_device

        tower = args.int8_tower
        make, ccfg = pair_config(tower, "clip_text")
        ckpt = args.checkpoint or _load_config(
            args.config).model.checkpoint_path
        model = (convert_jax.load_npz(ckpt, ccfg) if ckpt else
                 make(ccfg, generator=torch.Generator().manual_seed(0)))
        model = model.to(default_device()).requires_grad_(False)
        g = parity.int8_geometry_gate(model, ccfg)
        del model
        report["int8_tower"] = {"tower": tower, **g}
        ok &= g["ok"]

    # tokenizer-dependent checkpoint gates (smoke/threshold). When the
    # checkpoint was only feeding --int8-tower, a missing tokenizer must
    # not discard the gate report already computed above.
    if args.checkpoint and (args.image or args.pos_dir or args.neg_dir
                            or not report):
        cfg = _load_config(args.config)
        cfg.model.checkpoint_path = args.checkpoint
        from mmrs_tpu_torch.pipeline import build_towers

        towers = build_towers(cfg, tokenizer=_make_tokenizer(args, cfg))
        if towers.text_encode is None:
            print("parity needs a tokenizer (--merges/--vocab)",
                  file=sys.stderr)
            return 2
        size = towers.clip_config.vision.image_size
        if args.image:
            probs = parity.smoke_probs(towers, args.image, image_size=size)
            s = parity.check_smoke(probs)
            report["smoke"] = {
                "probs": [float(p) for p in s.probs],
                "golden": list(s.golden),
                "max_abs_diff": s.max_abs_diff, "ok": s.ok,
            }
            ok &= s.ok
        if args.pos_dir and args.neg_dir and args.prompt:
            from mmrs_tpu_torch.search.calibrate import find_thresholds

            txt = towers.text_encode([args.prompt])[0]
            txt /= np.linalg.norm(txt)
            pos = parity._embed_folder(towers, args.pos_dir, size)
            neg = parity._embed_folder(towers, args.neg_dir, size)
            scale = cfg.search.logit_scale
            res = find_thresholds(pos @ txt * scale, neg @ txt * scale)
            golden = (parity.GOLDEN_CN_LYCHEE if args.golden == "cn"
                      else parity.GOLDEN_EN_LYCHEE)
            t = parity.threshold_parity(res, golden)
            report["threshold"] = t
            ok &= t["threshold_ok"] and t["f1_ok"]

    if not report:
        print("nothing to check: pass --release, --rank-gate, --int8-tower, "
              "and/or --checkpoint", file=sys.stderr)
        return 2
    report["ok"] = ok
    print(json.dumps(report))
    return 0 if ok else 1


def cmd_adapter_train(args) -> int:
    """Tip-Adapter-F few-shot training: from an image folder (`--root`:
    the augment-epoch cache build through the towers, then training) or
    from precomputed features (`--features`). Prints the JSON line of
    `mmrs adapter train`."""
    from mmrs_tpu_torch.adapt import tip_adapter as tip

    if args.root:
        # end-to-end from an image folder: augment_epoch tower passes build
        # the cache (code/utils.py:99-132), then Tip-Adapter-F training
        from mmrs_tpu_torch.adapt.driver import run_few_shot
        from mmrs_tpu_torch.pipeline import build_towers

        cfg = _load_config(args.config)
        if args.checkpoint:
            cfg.model.checkpoint_path = args.checkpoint
        towers = build_towers(cfg, tokenizer=_make_tokenizer(args, cfg))
        run = run_few_shot(
            towers, args.root, shots=args.shots,
            augment_epoch=args.augment_epochs, lr=args.lr,
            epochs=args.epochs, alpha=args.alpha, beta=args.beta,
            run_search_hp=args.search_hp, seed=args.seed)
        if args.out:
            np.savez(args.out, adapter_keys=run.result.adapter_keys,
                     values=run.values, classes=np.asarray(run.classes))
        print(json.dumps({
            "classes": run.classes,
            "zero_shot_f1": run.zero_shot_f1,
            "tip_f1": run.tip_f1,
            "best_f1": run.result.best_f1,
            "best_epoch": run.result.best_epoch,
            "hp": None if run.result.hp is None else
            {"beta": run.result.hp.beta, "alpha": run.result.hp.alpha,
             "f1": run.result.hp.f1},
        }))
        return 0

    if not args.features:
        print("need --features or --root", file=sys.stderr)
        return 2
    from mmrs_tpu_torch.pipeline import default_device

    dev = default_device()
    data = np.load(args.features)
    keys, values = tip.build_cache(
        np.asarray(data["aug_features"]), np.asarray(data["train_labels"]),
        int(data["num_classes"]))
    res = tip.train_tip_adapter_f(
        data["train_features"], data["train_labels"],
        data["test_features"], data["test_labels"],
        keys, values, data["clip_weights"],
        num_classes=int(data["num_classes"]),
        lr=args.lr, epochs=args.epochs, alpha=args.alpha, beta=args.beta,
        run_search_hp=args.search_hp, device=dev)
    if args.out:
        np.savez(args.out, adapter_keys=res.adapter_keys)
    print(json.dumps({
        "best_f1": res.best_f1, "best_epoch": res.best_epoch,
        "hp": None if res.hp is None else
        {"beta": res.hp.beta, "alpha": res.hp.alpha, "f1": res.hp.f1},
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mmrs-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    ann = sub.add_parser("ann").add_subparsers(dest="subcmd", required=True)
    ab = ann.add_parser("build")
    ab.add_argument("--index", required=True)
    ab.add_argument("--config")
    ab.add_argument("--clusters", type=int, default=0)
    ab.add_argument("--bucket-cap", type=int, default=0)
    ab.add_argument("--cover", type=float, default=0.98)
    ab.add_argument("--slots-frac", type=float, default=1.3)
    ab.add_argument("--target-recall", type=float, default=0.0,
                    help="also run the measured nprobe tuner and persist "
                         "the result in the sidecar")
    _add_quant_flags(ab)
    ab.set_defaults(fn=cmd_ann_build)

    index = sub.add_parser("index").add_subparsers(dest="subcmd",
                                                   required=True)
    b = index.add_parser("build")
    b.add_argument("--root", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--config")
    b.add_argument("--workers", type=int, default=8)
    b.add_argument("--no-resume", action="store_true")
    b.add_argument("--sharded", action="store_true",
                   help="embed batches split over the config's mesh "
                        "(mesh.data_size devices; all cards by default)")
    b.set_defaults(fn=cmd_index_build)

    u = index.add_parser("update")
    u.add_argument("--root", required=True)
    u.add_argument("--index", required=True)
    u.add_argument("--config")
    u.add_argument("--workers", type=int, default=8)
    u.set_defaults(fn=cmd_index_update)

    cp = index.add_parser("compact")
    cp.add_argument("--index", required=True)
    cp.add_argument("--drop-class", nargs="*", default=[],
                    help="drop rows of these classes")
    cp.add_argument("--keep-missing", action="store_true",
                    help="keep rows whose file no longer exists")
    cp.set_defaults(fn=cmd_index_compact)

    s = sub.add_parser("search")
    s.add_argument("--index", help="index dir (omit with --server)")
    s.add_argument("--server",
                   help="query a RUNNING `mmrs-torch serve` over HTTP "
                        "instead of building a local engine")
    s.add_argument("--image", nargs="*")
    s.add_argument("--text")
    s.add_argument("-k", type=int, default=10)
    s.add_argument("--prototype")
    s.add_argument("--config")
    s.add_argument("--merges", help="CLIP BPE merges file for --text")
    s.add_argument("--vocab", help="BERT vocab.txt for --text (Taiyi tower)")
    _add_shards_flag(s)
    _add_quant_flags(s)
    _add_ann_flags(s)
    s.set_defaults(fn=cmd_search)

    c = sub.add_parser("calibrate")
    c.add_argument("--index", required=True)
    c.add_argument("--positive-class", required=True)
    c.add_argument("--shots", type=int, default=10)
    c.add_argument("--prototype", default="mean")
    c.add_argument("--config")
    _add_shards_flag(c)
    _add_quant_flags(c)
    _add_ann_flags(c)
    c.set_defaults(fn=cmd_calibrate)

    def add_dry(sp):
        sp.add_argument("--no-dry-run", action="store_true",
                        help="actually apply destructive changes")

    d = sub.add_parser("dedup")
    d.add_argument("--mode", required=True,
                   choices=["exact", "perceptual", "embedding"])
    d.add_argument("--reference")
    d.add_argument("--target")
    d.add_argument("--index")
    d.add_argument("--hamming", type=int, default=5)
    d.add_argument("--tau", type=float, default=0.96)
    d.add_argument("--workers", type=int, default=0,
                   help="hash thread pool size (0 = one per core)")
    _add_shards_flag(d, "the embedding mode's ring")
    add_dry(d)
    d.set_defaults(fn=cmd_dedup)

    lk = sub.add_parser("leakage")
    lk.add_argument("--train", required=True)
    lk.add_argument("--test", required=True)
    lk.add_argument("--tolerance", type=int, default=0)
    add_dry(lk)
    lk.set_defaults(fn=cmd_leakage)

    cv = sub.add_parser("convert")
    cv.add_argument("--root", required=True)
    cv.add_argument("--quality", type=int, default=95)
    add_dry(cv)
    cv.set_defaults(fn=cmd_convert)

    cl = sub.add_parser("clean")
    cl.add_argument("--root", required=True)
    add_dry(cl)
    cl.set_defaults(fn=cmd_clean)

    rn = sub.add_parser("rename")
    rn.add_argument("--root", required=True)
    add_dry(rn)
    rn.set_defaults(fn=cmd_rename)

    mg = sub.add_parser("merge")
    mg.add_argument("--root", required=True)
    mg.add_argument("--map", nargs="+", required=True,
                    help="src=dst folder mappings")
    add_dry(mg)
    mg.set_defaults(fn=cmd_merge)

    ds = sub.add_parser("dataset").add_subparsers(dest="subcmd",
                                                  required=True)
    mk = ds.add_parser("make")
    mk.add_argument("--variant", required=True,
                    choices=["v1", "v2", "v3", "v4", "v5"])
    mk.add_argument("--root", required=True)
    mk.add_argument("--out", required=True)
    mk.add_argument("--seed", type=int, default=0)
    mk.set_defaults(fn=cmd_dataset_make)

    ca = sub.add_parser("cascade")
    ca.add_argument("--root", required=True)
    ca.add_argument("--positive-class", required=True)
    ca.add_argument("--class-embed", help="npy class embedding (or --prompt)")
    ca.add_argument("--prompt", help='prompt, e.g. "a photo of {}"')
    ca.add_argument("--merges", help="CLIP BPE merges file")
    ca.add_argument("--vocab", help="WordPiece vocab (Taiyi)")
    ca.add_argument("--threshold", type=float, required=True)
    _add_verifier_flags(ca)
    ca.add_argument("--chunk-size", type=int, default=0,
                    help="stream the folder in chunks of this many images "
                         "(bounded memory, pipelined verify); 0 = one pass")
    ca.add_argument("--journal",
                    help="crash-resume journal CSV: finalized rows are "
                         "appended+fsynced as they complete; re-running "
                         "with the same file skips them (implies "
                         "streaming)")
    ca.add_argument("--out", help="write the per-image audit CSV here")
    ca.add_argument("--config")
    ca.set_defaults(fn=cmd_cascade)

    un = sub.add_parser("union")
    un.add_argument("--root", required=True)
    un.add_argument("--positive-class", required=True)
    un.add_argument("--out", required=True)
    un.add_argument("--en-embed", help="npy EN class embedding (or --prompt)")
    un.add_argument("--cn-embed", help="npy CN class embedding (or --cn-prompt)")
    un.add_argument("--prompt",
                    help='EN prompt, e.g. "a photo of lychee" or "a photo '
                         'of {}" ({} = positive class)')
    un.add_argument("--cn-prompt", help='CN prompt, e.g. "一张荔枝的图片"')
    un.add_argument("--merges", help="CLIP BPE merges file (EN text tower)")
    un.add_argument("--vocab", help="WordPiece vocab (CN text tower)")
    un.add_argument("--en-threshold", type=float)
    un.add_argument("--cn-threshold", type=float)
    un.add_argument("--cn-checkpoint")
    un.add_argument("--cn-image-tower", default="vit_l14",
                    choices=["vit_b32", "vit_l14", "vit_tiny"])
    un.add_argument("--config")
    un.set_defaults(fn=cmd_union)

    sv = sub.add_parser("serve")
    sv.add_argument("--index", required=True)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8080)
    sv.add_argument("--merges", help="CLIP BPE merges file (enables text)")
    sv.add_argument("--vocab", help="WordPiece vocab (Taiyi)")
    sv.add_argument("--config")
    sv.add_argument("--batch-window", type=float, default=0.002,
                    help="micro-batcher linger seconds (coalesces "
                         "concurrent requests into one device dispatch)")
    sv.add_argument("--max-batch", type=int, default=64,
                    help="max items per coalesced device dispatch")
    sv.add_argument("--concurrent-fetch", action="store_true",
                    help="allow a search's result fetch while a verify "
                         "pack is being collected (no host fetch lock)")
    sv.add_argument("--watch-index", type=float, default=0.0, metavar="SEC",
                    help="hot-reload: poll the index manifest at most "
                         "every SEC seconds and swap in a rebuilt engine "
                         "when `index update`/`compact` changed it (0 = "
                         "off; the old gallery stays resident during the "
                         "swap)")
    _add_shards_flag(sv)
    _add_quant_flags(sv)
    _add_ann_flags(sv)
    _add_verifier_flags(sv)
    sv.set_defaults(fn=cmd_serve)

    ad = sub.add_parser("adapter").add_subparsers(dest="subcmd", required=True)
    at = ad.add_parser("train")
    at.add_argument("--features",
                    help="npz with aug_features/train_*/test_*/clip_weights")
    at.add_argument("--root",
                    help="image folder: run the full augment-epoch cache "
                         "build + training end-to-end")
    at.add_argument("--shots", type=int, default=4)
    at.add_argument("--augment-epochs", type=int, default=5)
    at.add_argument("--seed", type=int, default=0)
    at.add_argument("--checkpoint", help="converted npz towers checkpoint")
    at.add_argument("--merges", help="CLIP BPE merges file")
    at.add_argument("--vocab", help="WordPiece vocab (Taiyi)")
    at.add_argument("--config")
    at.add_argument("--out")
    at.add_argument("--lr", type=float, default=1e-3)
    at.add_argument("--epochs", type=int, default=20)
    at.add_argument("--alpha", type=float, default=1.0)
    at.add_argument("--beta", type=float, default=1.0)
    at.add_argument("--search-hp", action="store_true")
    at.set_defaults(fn=cmd_adapter_train)

    wt = sub.add_parser("weights").add_subparsers(dest="subcmd", required=True)
    wc = wt.add_parser("convert")
    wc.add_argument("--source", required=True,
                    choices=["hf_clip", "openai_clip", "taiyi", "hf_llava"])
    wc.add_argument("--arch", default="b32",
                    choices=["b32", "l14", "7b", "1b"],
                    help="clip arch for *_clip sources; decoder size for "
                         "hf_llava (7b = llava-v1.5-7b, 1b = a "
                         "TinyLlama-1.1B-class draft VLM)")
    wc.add_argument("--input", required=True,
                    help="a .pt/.bin/.safetensors state dict, or a HF "
                         "model directory of sharded weight files")
    wc.add_argument("--out", required=True)
    wc.add_argument("--int8", action="store_true",
                    help="quantize serving weights at conversion (llava: "
                         "7 GB npz instead of 13.5, loads straight into "
                         "--verifier-int8)")
    wc.set_defaults(fn=cmd_weights_convert)

    lc = sub.add_parser("lifecycle")
    lc.add_argument("--root", required=True,
                    help="labeled image tree (class folders; optional "
                         "ez_negative / <cls>_negative folders feed VQA v4)")
    lc.add_argument("--out", required=True, help="artifact output root")
    lc.add_argument("--positive-class", required=True)
    lc.add_argument("--config")
    lc.add_argument("--shots", type=int, default=5)
    lc.add_argument("--test-root",
                    help="optional held-out tree for the leakage report")
    lc.add_argument("--dedup-tau", type=float, default=0.995)
    lc.add_argument("--seed", type=int, default=0)
    lc.set_defaults(fn=cmd_lifecycle)

    pa = sub.add_parser("parity")
    pa.add_argument("--release", metavar="DIR",
                    help="drop-in gate over a directory of DOWNLOADED "
                         "release artifacts (OpenAI ViT-B-32.pt, HF model "
                         "dirs, llava, tokenizer files) — detects layouts, "
                         "derives configs, runs every check the pack "
                         "allows (see models/release.py)")
    pa.add_argument("--llava-smoke", action="store_true",
                    help="with --release + --image: run a real llava "
                         "greedy decode smoke")
    pa.add_argument("--rank-gate", action="store_true",
                    help="bf16-vs-f32 top-k rank parity (no weights needed)")
    pa.add_argument("--int8-tower", metavar="TOWER",
                    help="int8-vs-f32 tower geometry gate (vit_b32/vit_l14/"
                         "vit_tiny; uses --checkpoint when given)")
    pa.add_argument("--rows", type=int, default=100_000)
    pa.add_argument("--queries", type=int, default=16)
    pa.add_argument("--k", type=int, default=10)
    pa.add_argument("--checkpoint", help="converted npz checkpoint")
    pa.add_argument("--image", help="smoke image (the reference's CLIP.png)")
    pa.add_argument("--merges", help="CLIP BPE merges file")
    pa.add_argument("--vocab", help="WordPiece vocab (Taiyi)")
    pa.add_argument("--pos-dir")
    pa.add_argument("--neg-dir")
    pa.add_argument("--prompt", help='e.g. "a photo of lychee"')
    pa.add_argument("--golden", default="en", choices=["en", "cn"])
    pa.add_argument("--config")
    pa.set_defaults(fn=cmd_parity)

    from mmrs_tpu_torch.plan import HBM_GB_DEFAULT

    pl = sub.add_parser(
        "plan",
        help="capacity planner: predict residency + Q1 latency for every "
             "quant x flat/IVF rung before building (constants fitted on "
             "an H100; see mmrs_tpu_torch/plan.py)")
    pl.add_argument("--rows", type=int, required=True)
    pl.add_argument("--dim", type=int, required=True)
    pl.add_argument("--chips", type=int, default=1)
    pl.add_argument("--hbm-gb", type=float, default=HBM_GB_DEFAULT)
    pl.add_argument("--nprobe", type=int, default=32)
    pl.add_argument("--clusters", type=int, default=0,
                    help="IVF clusters (0 = sqrt-rows power of two)")
    pl.add_argument("--slots-frac", type=float, default=1.3)
    pl.add_argument("--spill-frac", type=float, default=0.05,
                    help="expected spill fraction (corpus skew dependent)")
    pl.add_argument("--target-ms", type=float, default=0.0,
                    help="latency target: recommend the highest-quality "
                         "rung predicted to meet it")
    pl.set_defaults(fn=cmd_plan)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    raise SystemExit(args.fn(args))


if __name__ == "__main__":
    main()
