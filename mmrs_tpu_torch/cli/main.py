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

The flags and output lines are those of the same `mmrs` subcommands
(mmrs_tpu/cli/main.py) on one device: the flat gallery, bf16 or
quantized (`--gallery-quant`; `--gallery-int8` is the older spelling of
`--gallery-quant int8`), or the IVF index (`--ann-*`, whose sidecar is
cached under `<index>/ivf` and prebuilt by `ann build`). The towers and
the gallery live on the GPU when there is one; the kernels build there on
first use.
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
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    raise SystemExit(args.fn(args))


if __name__ == "__main__":
    main()
