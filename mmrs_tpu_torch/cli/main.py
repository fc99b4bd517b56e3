"""`mmrs-torch` CLI — the search path of `mmrs`, on the PyTorch port.

  mmrs-torch index build   --root DIR --out DIR [--config cfg.yaml]
  mmrs-torch index update  --root DIR --index DIR [--config cfg.yaml]
  mmrs-torch index compact --index DIR [--drop-class C...] [--keep-missing]
  mmrs-torch search        --index DIR (--image PATH... | --text "query"
                           --merges FILE) [-k 10] [--prototype mean]
                           [--gallery-quant int8|int4]
                           [--ann-nprobe N | --ann-target-recall R]
                           [--ann-clusters C] [--ann-cover F]
                           [--ann-slots-frac F]
  mmrs-torch calibrate     --index DIR --positive-class NAME [--shots 10]
                           [--gallery-quant int8|int4]
  mmrs-torch ann build     --index DIR [--clusters C] [--bucket-cap N]
                           [--cover F] [--slots-frac F]
                           [--target-recall R] [--gallery-quant int8|int4]
  mmrs-torch dedup         --mode exact|perceptual|embedding
                           [--reference DIR] [--target DIR] [--index DIR]
                           [--hamming 5] [--tau 0.96] [--workers 0]
  mmrs-torch leakage       --train DIR --test DIR [--tolerance 0]
  mmrs-torch convert       --root DIR [--quality 95]   (format -> JPEG)
  mmrs-torch clean         --root DIR          (delete non-jpeg images)
  mmrs-torch rename        --root DIR          (canonical two-phase rename)
  mmrs-torch merge         --root DIR --map 'src=dst' ...
  mmrs-torch dataset make  --variant v1..v5 --root DIR --out PATH [--seed 0]

The flags and output lines are those of the same `mmrs` subcommands
(mmrs_tpu/cli/main.py) on one device: the flat gallery, bf16 or
quantized (`--gallery-quant`; `--gallery-int8` is the older spelling of
`--gallery-quant int8`), or the IVF index (`--ann-*`, whose sidecar is
cached under `<index>/ivf` and prebuilt by `ann build`). Destructive
governance commands are dry runs unless given --no-dry-run. The towers,
the gallery and the embedding dedup run on the GPU (the kernels build
there on first use); MMRS_TORCH_DEVICE=cpu puts them on the CPU, and
without a GPU nothing else does.
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


def _make_engine(args, cfg, idx):
    """SearchEngine from the --gallery-quant and --ann-* flags; 2 (the
    exit code) on a usage error."""
    import dataclasses

    from mmrs_tpu_torch.search.engine import SearchEngine

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
    return SearchEngine(idx, search_cfg, quantize=_quant_mode(args))


def cmd_index_build(args) -> int:
    from mmrs_tpu_torch.index.gallery import build_index
    from mmrs_tpu_torch.io.dataset import FolderDataset
    from mmrs_tpu_torch.pipeline import build_towers

    cfg = _load_config(args.config)
    towers = build_towers(cfg)
    ds = FolderDataset.from_root(args.root, num_workers=args.workers)
    idx = build_index(ds, towers.image_encode, args.out,
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
    ds = FolderDataset.from_root(args.root, num_workers=args.workers)
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


def cmd_search(args) -> int:
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.io.images import load_image
    from mmrs_tpu_torch.pipeline import build_towers

    cfg = _load_config(args.config)
    idx = GalleryIndex.load(args.index)
    engine = _make_engine(args, cfg, idx)
    if engine == 2:
        return 2
    tokenizer = None
    if args.merges:
        from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer

        tokenizer = CLIPTokenizer.from_file(args.merges)
    towers = build_towers(cfg, tokenizer=tokenizer)

    if args.image:
        loaded = [load_image(p) for p in args.image]
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
            print("text search needs a tokenizer (--merges)",
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

        if args.gallery_shards > 1:
            print(f"--gallery-shards {args.gallery_shards}: the sharded "
                  "dedup ring is ported with ROADMAP A.12", file=sys.stderr)
            return 2
        idx = GalleryIndex.load(args.index)
        rep = dd.embedding_dedup(np.asarray(idx.embeddings, np.float32),
                                 idx.paths, tau=args.tau, dry_run=dry)
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
    s.add_argument("--index", required=True)
    s.add_argument("--image", nargs="*")
    s.add_argument("--text")
    s.add_argument("-k", type=int, default=10)
    s.add_argument("--prototype")
    s.add_argument("--config")
    s.add_argument("--merges", help="CLIP BPE merges file for --text")
    _add_quant_flags(s)
    _add_ann_flags(s)
    s.set_defaults(fn=cmd_search)

    c = sub.add_parser("calibrate")
    c.add_argument("--index", required=True)
    c.add_argument("--positive-class", required=True)
    c.add_argument("--shots", type=int, default=10)
    c.add_argument("--prototype", default="mean")
    c.add_argument("--config")
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
    d.add_argument("--gallery-shards", type=int, default=1,
                   help="embedding mode: the sharded dedup ring (N > 1 is "
                        "not ported yet)")
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
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    raise SystemExit(args.fn(args))


if __name__ == "__main__":
    main()
