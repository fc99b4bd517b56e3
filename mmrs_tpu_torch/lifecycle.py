"""One-command reference-workflow replication, on the PyTorch port.

Counterpart of mmrs_tpu/lifecycle.py. A user of the reference ran ~27
scripts across its repos to take a raw labeled image tree to a governed
dataset: format normalization, gallery embedding, threshold calibration
(CLIP/lab3.py), the bilingual union report (CLIP/union_dataset.py:
263-425), the CLIP->LLaVA cascade with per-file audit
(code/union_clip_llava2.py:294-328), duplicate/leakage removal
(tool/find_repeated*.py, tool/delete repeated.py), and VQA dataset
construction (code/create_jsonl_dataset4.py). `run_lifecycle` chains
every stage through the port's library surface in one call (CLI:
`mmrs-torch lifecycle`), producing the JAX package's artifact files
(names, CSV columns, JSON keys) under one output root:

  out/
    govern/normalize.json     format-normalization report (dry-run)
    index/                    sharded gallery (npz shards + manifest)
    calibrate/sweep_<cls>.csv lab3-style threshold curve
    calibrate/calibration.json  best threshold / F1 (logit-scaled)
    union/<cls>/_file_details.csv  per-file union audit (+ copies)
    cascade/journal.csv       crash-resume journal (finalized rows)
    cascade/audit.csv         per-image gate/verify audit
    govern/dedup.json         embedding-dedup report (dry-run)
    govern/leakage.json       train/test leakage report (dry-run)
    vqa/dataset*.json         the four cumulative v4 JSONL files
    lifecycle.json            stage manifest + cross-checks

On the card the towers run K3 and K2 (K6 with an int8 tower), the
calibration sweep runs on an f32 device gallery (the JAX lifecycle's
`device_dtype=jnp.float32`), and the embedding dedup runs K9's f32 route.
`impl="torch"` runs the same stages on the kernels' plain versions.

Destructive stages stay DRY-RUN: reports record what would be removed;
nothing in the input tree is touched.

Cross-checks: the union report's EN pass count equals the cascade's
gate-survivor count (same tower, same prototype embedding, same
threshold — the two stages must agree on who passes; both score the
same batches of the same images), and the calibration row count equals
the index size.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _write_json(path: str, obj: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2)


def run_lifecycle(
    root: str,
    out: str,
    positive_class: str,
    cfg=None,
    shots: int = 5,
    test_root: Optional[str] = None,   # leakage check target (optional)
    dedup_tau: float = 0.995,
    seed: int = 0,
    verifier=None,                     # optional cascade verifier
    device=None,
    impl: str = "auto",
) -> Dict:
    """Run the full reference lifecycle over a labeled tree on `device`
    (default: pipeline.default_device()). Returns the manifest dict (also
    written to out/lifecycle.json). `impl` is the kernels' route ("auto",
    or "torch" for their plain versions)."""
    import csv as _csv

    from mmrs_tpu_torch.config import Config
    from mmrs_tpu_torch.index.gallery import build_index
    from mmrs_tpu_torch.io.dataset import FolderDataset, scan_folder
    from mmrs_tpu_torch.pipeline import build_towers, default_device
    from mmrs_tpu_torch.search.engine import SearchEngine
    from mmrs_tpu_torch.search.prototypes import build_prototype

    cfg = cfg or Config()
    device = torch.device(device) if device is not None else default_device()
    manifest: Dict = {"root": root, "out": out,
                      "positive_class": positive_class}
    os.makedirs(out, exist_ok=True)

    # -- 1. governance prep: format normalization (dry-run report) --------
    from mmrs_tpu_torch.govern.normalize import convert_to_jpeg

    rep = convert_to_jpeg(root, dry_run=True)
    norm_path = os.path.join(out, "govern", "normalize.json")
    _write_json(norm_path, {"would_convert": sorted(rep.converted),
                            "errors": sorted(getattr(rep, "errors", []))})
    manifest["normalize"] = {"would_convert": len(rep.converted),
                             "report": norm_path}
    log.info("lifecycle 1/7 normalize: %d conversions (dry-run)",
             len(rep.converted))

    # -- 2. gallery index ---------------------------------------------------
    from mmrs_tpu_torch.models.configs import IMAGE_TOWERS

    towers = build_towers(cfg, device=device, impl=impl)
    image_size = IMAGE_TOWERS[cfg.model.image_tower].image_size
    index_dir = os.path.join(out, "index")
    ds = FolderDataset.from_root(root, image_size=image_size,
                                 stack="openai")
    idx = build_index(ds, towers.image_encode, index_dir,
                      batch_size=cfg.gallery.batch_size,
                      shard_rows=cfg.gallery.shard_rows)
    manifest["index"] = {"rows": len(idx), "dim": idx.dim,
                         "dir": index_dir}
    log.info("lifecycle 2/7 index: %d rows", len(idx))

    # -- 3. calibration (lab3-style sweep CSV + best threshold) ----------
    engine = SearchEngine(idx, cfg.search, device=device,
                          device_dtype=torch.float32)
    labels = np.asarray([c == positive_class for c in idx.classes])
    if not labels.any():
        raise ValueError(f"no rows of class {positive_class!r} in {root}")
    shot_rows = np.flatnonzero(labels)[:shots]
    proto = build_prototype(torch.from_numpy(np.asarray(
        idx.embeddings[shot_rows], np.float32))).cpu().numpy()
    res = engine.sweep_class(proto, labels, calib_config=cfg.calibration)
    del engine
    cal_dir = os.path.join(out, "calibrate")
    os.makedirs(cal_dir, exist_ok=True)
    sweep_csv = os.path.join(cal_dir, f"sweep_{positive_class}.csv")
    with open(sweep_csv, "w", newline="", encoding="utf-8") as f:
        w = _csv.writer(f)
        w.writerow(["threshold", "precision", "recall", "f1"])
        for t, p, r, f1 in zip(res.thresholds, res.precision, res.recall,
                               res.f1):
            w.writerow([f"{t:.4f}", f"{p:.6f}", f"{r:.6f}", f"{f1:.6f}"])
    tau = float(res.best_threshold)           # logit-scaled (x100)
    _write_json(os.path.join(cal_dir, "calibration.json"), {
        "class": positive_class, "best_threshold": tau,
        "best_f1": res.best_f1, "precision": res.best_precision,
        "recall": res.best_recall, "rows": int(labels.size),
        "shots": int(shot_rows.size),
    })
    manifest["calibrate"] = {"best_threshold": tau,
                             "best_f1": float(res.best_f1),
                             "rows": int(labels.size),
                             "sweep_csv": sweep_csv}
    log.info("lifecycle 3/7 calibrate: tau=%.4f f1=%.4f", tau, res.best_f1)

    # -- 4. union report (audit CSV + passing-sample copies) -------------
    from mmrs_tpu_torch.govern.bilingual import bilingual_union

    scale = cfg.search.logit_scale
    union_root = os.path.join(out, "union")
    ures = bilingual_union(
        root, positive_class,
        en_encode=towers.image_encode, en_text_embed=proto,
        cn_encode=towers.image_encode, cn_text_embed=proto,
        out_root=union_root,
        en_threshold=tau / scale, cn_threshold=tau / scale,
        image_size=image_size,
        batch_size=cfg.gallery.batch_size,
    )
    manifest["union"] = {
        "en_pass": ures.report.en_pass, "cn_pass": ures.report.cn_pass,
        "union_pass": ures.report.union_pass,
        "f1": ures.report.metrics.f1,
        "audit_csv": ures.report.audit_csv,
        "copied": len(ures.report.copied),
    }
    log.info("lifecycle 4/7 union: %d pass", ures.report.union_pass)

    # -- 5. cascade with journal + audit ----------------------------------
    from mmrs_tpu_torch.cascade import CascadePipeline

    samples = list(ds.samples)
    paths = [p for p, _ in samples]
    path_labels = [c == positive_class for _, c in samples]

    def scorer(ps):
        # the union's scoring (govern/bilingual.score_dataset) on the same
        # batches: chunks of batch_size paths, one batch each
        sub = FolderDataset([(p, "") for p in ps], image_size=image_size,
                            stack="openai")
        sims = []
        for batch in sub.batches(cfg.gallery.batch_size):
            e = np.asarray(towers.image_encode(batch.pixels), np.float32)
            e = e / np.linalg.norm(e, axis=1, keepdims=True)
            s = (e @ (proto / np.linalg.norm(proto))) * scale
            sims.extend(np.where(batch.ok, s, -np.inf))
        return sims

    cas_dir = os.path.join(out, "cascade")
    os.makedirs(cas_dir, exist_ok=True)
    journal = os.path.join(cas_dir, "journal.csv")
    pipe = CascadePipeline(en_scorer=scorer, en_threshold=tau,
                           verifier=verifier)
    cres = pipe.run_streaming(paths, positive_class, labels=path_labels,
                              chunk_size=max(cfg.gallery.batch_size, 8),
                              journal=journal)
    audit_csv = os.path.join(cas_dir, "audit.csv")
    cres.write_csv(audit_csv)
    manifest["cascade"] = {
        "images": len(cres.paths),
        "gate_passed": int(cres.gate_passed.sum()),
        "final_positives": int(cres.verified.sum()),
        "verifier_calls": cres.verifier_calls,
        "journal": journal, "audit_csv": audit_csv,
        "f1": cres.metrics.f1 if cres.metrics else None,
    }
    log.info("lifecycle 5/7 cascade: %d gate-passed",
             int(cres.gate_passed.sum()))

    # -- 6. dedup + leakage (dry-run reports) ------------------------------
    from mmrs_tpu_torch.govern.dedup import embedding_dedup, leakage_removal

    emb = np.asarray(idx.embeddings, np.float32)
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    drep = embedding_dedup(emb, idx.paths, tau=dedup_tau, dry_run=True,
                           impl=impl, device=device)
    dedup_path = os.path.join(out, "govern", "dedup.json")
    _write_json(dedup_path, {
        "tau": dedup_tau,
        "duplicates": [[d, k] for d, k in drep.duplicates],
    })
    manifest["dedup"] = {"duplicates": len(drep.duplicates),
                         "report": dedup_path}
    if test_root:
        lrep = leakage_removal(
            [p for p, _ in scan_folder(root)],
            [p for p, _ in scan_folder(test_root)],
            dry_run=True)
        leak_path = os.path.join(out, "govern", "leakage.json")
        _write_json(leak_path, {
            "leaked": [[d, s] for d, s in lrep.duplicates]})
        manifest["leakage"] = {"leaked": len(lrep.duplicates),
                               "report": leak_path}
    log.info("lifecycle 6/7 dedup: %d dups", len(drep.duplicates))

    # -- 7. VQA v4 dataset --------------------------------------------------
    from mmrs_tpu_torch.govern import vqa

    by_class: Dict[str, list] = {}
    for p, c in scan_folder(root):
        by_class.setdefault(c, []).append(p)
    easy = by_class.pop("ez_negative", [])
    hard = {c[: -len("_negative")]: v for c, v in list(by_class.items())
            if c.endswith("_negative")}
    for c in list(by_class):
        if c.endswith("_negative"):
            del by_class[c]
    vqa_dir = os.path.join(out, "vqa")
    vout = vqa.build_v4(by_class, easy, hard, out_dir=vqa_dir, seed=seed)
    manifest["vqa"] = {
        k: len(getattr(vout, k))
        for k in ("positives", "with_cross", "with_simple", "with_hard")
    }
    manifest["vqa"]["dir"] = vqa_dir
    log.info("lifecycle 7/7 vqa: %d positives", manifest["vqa"]["positives"])

    # -- cross-checks --------------------------------------------------------
    manifest["cross_checks"] = {
        # same tower + prototype + threshold: the union's EN pass set and
        # the cascade's gate-survivor set must agree (basename-unique
        # trees make the counts directly comparable)
        "union_en_pass_eq_cascade_gate":
            manifest["union"]["en_pass"] == manifest["cascade"]["gate_passed"],
        "calibration_rows_eq_index_rows":
            manifest["calibrate"]["rows"] == manifest["index"]["rows"],
    }
    _write_json(os.path.join(out, "lifecycle.json"), manifest)
    return manifest
