"""`mmrs-torch` CLI — the search path of `mmrs`, on the PyTorch port.

  mmrs-torch index build --root DIR --out DIR [--config cfg.yaml]
  mmrs-torch search      --index DIR (--image PATH... | --text "query"
                         --merges FILE) [-k 10] [--prototype mean]
                         [--gallery-quant int8|int4]
  mmrs-torch calibrate   --index DIR --positive-class NAME [--shots 10]
                         [--gallery-quant int8|int4]

The flags and output lines are those of the same `mmrs` subcommands
(mmrs_tpu/cli/main.py) for the flat gallery on one device, bf16 or
quantized (`--gallery-quant`; `--gallery-int8` is the older spelling of
`--gallery-quant int8`). The towers and the gallery live on the GPU when
there is one; the kernels build there on first use.
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


def cmd_search(args) -> int:
    from mmrs_tpu_torch.index.gallery import GalleryIndex
    from mmrs_tpu_torch.io.images import load_image
    from mmrs_tpu_torch.pipeline import build_towers
    from mmrs_tpu_torch.search.engine import SearchEngine

    cfg = _load_config(args.config)
    idx = GalleryIndex.load(args.index)
    engine = SearchEngine(idx, cfg.search, quantize=_quant_mode(args))
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
    from mmrs_tpu_torch.search.engine import SearchEngine
    from mmrs_tpu_torch.search.prototypes import build_prototype

    cfg = _load_config(args.config)
    idx = GalleryIndex.load(args.index)
    engine = SearchEngine(idx, cfg.search, quantize=_quant_mode(args))
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

    index = sub.add_parser("index").add_subparsers(dest="subcmd",
                                                   required=True)
    b = index.add_parser("build")
    b.add_argument("--root", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--config")
    b.add_argument("--workers", type=int, default=8)
    b.add_argument("--no-resume", action="store_true")
    b.set_defaults(fn=cmd_index_build)

    s = sub.add_parser("search")
    s.add_argument("--index", required=True)
    s.add_argument("--image", nargs="*")
    s.add_argument("--text")
    s.add_argument("-k", type=int, default=10)
    s.add_argument("--prototype")
    s.add_argument("--config")
    s.add_argument("--merges", help="CLIP BPE merges file for --text")
    _add_quant_flags(s)
    s.set_defaults(fn=cmd_search)

    c = sub.add_parser("calibrate")
    c.add_argument("--index", required=True)
    c.add_argument("--positive-class", required=True)
    c.add_argument("--shots", type=int, default=10)
    c.add_argument("--prototype", default="mean")
    c.add_argument("--config")
    _add_quant_flags(c)
    c.set_defaults(fn=cmd_calibrate)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    raise SystemExit(args.fn(args))


if __name__ == "__main__":
    main()
