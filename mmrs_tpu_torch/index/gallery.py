"""Persistent embedding gallery (the index).

Counterpart of mmrs_tpu/index/gallery.py, with the same on-disk format:
an index written by either package loads in the other. It replaces the
reference's ad-hoc pickle feature cache
(`./caches/search/features.pkl` keyed by relative path,
code/search_image.py:142-165) with an mmap-able sharded store:

  <dir>/manifest.json       — {embed_dim, dtype, shards: [...], entries: N}
  <dir>/shard_00000.npy     — [rows, D] float16/float32 L2-normalized rows
  <dir>/paths_00000.json    — per-shard [(path, class), ...]

Interrupted builds resume at the last COMPLETE shard (SURVEY.md §5
checkpoint story): each shard is written atomically (tmp + rename) and the
manifest is rewritten after every shard.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from mmrs_tpu_torch.io.dataset import FolderDataset
from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclass
class GalleryIndex:
    embeddings: np.ndarray            # [N, D] L2-normalized (np.memmap ok)
    paths: List[str]
    classes: List[str]                # per-row class labels
    # source directory when loaded/built from disk — lets derived
    # structures (the IVF sidecar) cache themselves next to the shards
    directory: Optional[str] = None

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1])

    def rows_for_paths(self, wanted: Sequence[str]) -> np.ndarray:
        idx = {p: i for i, p in enumerate(self.paths)}
        return np.asarray([idx[w] for w in wanted], np.int64)

    # -- persistence --------------------------------------------------------

    @staticmethod
    def load(directory: str, mmap: bool = True,
             consolidate: Optional[bool] = None) -> "GalleryIndex":
        """Load an index. Multi-shard indexes are consolidated into a single
        `combined.npy` memmap ON FIRST LOAD (written atomically, invalidated
        whenever the shard list CONTENT changes — names, row counts, file
        mtimes/sizes — not just the total row count, so an in-place rebuild
        with a new checkpoint never serves stale embeddings) so big galleries
        never need full RAM residency; pass consolidate=False to force in-RAM
        concatenation."""
        with open(os.path.join(directory, "manifest.json"), encoding="utf-8") as f:
            man = json.load(f)
        paths, classes = [], []
        for shard in man["shards"]:
            with open(os.path.join(directory, shard["meta"]), encoding="utf-8") as f:
                meta = json.load(f)
            paths.extend(m[0] for m in meta)
            classes.extend(m[1] for m in meta)

        shards = man["shards"]
        mode = "r" if mmap else None
        if not shards:
            # a compaction can legitimately drop every row; an empty
            # index must load (len()==0) so callers decide what's next
            embeddings = np.zeros((0, int(man["embed_dim"])), np.float32)
            return GalleryIndex(embeddings, paths, classes,
                                directory=directory)
        if len(shards) == 1:
            embeddings = np.load(os.path.join(directory, shards[0]["data"]),
                                 mmap_mode=mode)
            return GalleryIndex(embeddings, paths, classes,
                                directory=directory)

        if consolidate is None:
            consolidate = mmap
        combined = os.path.join(directory, "combined.npy")
        sidecar = combined + ".json"
        fingerprint = _shard_fingerprint(directory, shards)
        if consolidate:
            stale = True
            if os.path.exists(combined) and os.path.exists(sidecar):
                with open(sidecar, encoding="utf-8") as f:
                    stale = json.load(f) != fingerprint
            if stale:
                first = np.load(os.path.join(directory, shards[0]["data"]),
                                mmap_mode="r")
                total = sum(s["rows"] for s in shards)
                tmp = combined + ".tmp.npy"
                out = np.lib.format.open_memmap(
                    tmp, mode="w+", dtype=first.dtype,
                    shape=(total, first.shape[1]))
                row = 0
                for s in shards:
                    arr = np.load(os.path.join(directory, s["data"]),
                                  mmap_mode="r")
                    out[row:row + arr.shape[0]] = arr
                    row += arr.shape[0]
                out.flush()
                del out
                os.replace(tmp, combined)
                tmp_s = sidecar + ".tmp"
                with open(tmp_s, "w", encoding="utf-8") as f:
                    json.dump(fingerprint, f)
                os.replace(tmp_s, sidecar)
            embeddings = np.load(combined, mmap_mode=mode)
        else:
            embeddings = np.concatenate(
                [np.asarray(np.load(os.path.join(directory, s["data"])))
                 for s in shards], axis=0)
        return GalleryIndex(embeddings, paths, classes,
                            directory=directory)


def _shard_fingerprint(directory: str, shards: List[dict]) -> List[list]:
    """Content identity of the shard list: name, rows, and the data file's
    (size, mtime_ns) — so rebuilding shards in place invalidates combined.npy
    even when the total row count is unchanged."""
    fp = []
    for s in shards:
        st = os.stat(os.path.join(directory, s["data"]))
        fp.append([s["data"], int(s["rows"]), st.st_size, st.st_mtime_ns])
    return fp


def _next_shard_id(shards: List[dict]) -> int:
    """1 + the max id parsed from existing shard FILENAMES. Positional
    len(shards) is wrong after a compaction dropped a shard (ids then no
    longer match positions, and reusing one overwrites a live file)."""
    return 1 + max(
        (int(s["data"].split("_")[1].split(".")[0]) for s in shards),
        default=-1)


def _write_shard(directory: str, shard_id: int, rows: np.ndarray,
                 meta: List[Tuple[str, str]]) -> dict:
    data_name = f"shard_{shard_id:05d}.npy"
    meta_name = f"paths_{shard_id:05d}.json"
    tmp = os.path.join(directory, data_name + ".tmp.npy")
    np.save(tmp, rows)
    os.replace(tmp, os.path.join(directory, data_name))
    tmp_m = os.path.join(directory, meta_name + ".tmp")
    with open(tmp_m, "w", encoding="utf-8") as f:
        json.dump(meta, f, ensure_ascii=False)
    os.replace(tmp_m, os.path.join(directory, meta_name))
    return {"data": data_name, "meta": meta_name, "rows": int(rows.shape[0])}


def _write_manifest(out_dir: str, shards: List[dict], embed_dim: int) -> None:
    man_path = os.path.join(out_dir, "manifest.json")
    tmp = man_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"embed_dim": embed_dim,
                   "shards": shards,
                   "entries": sum(s["rows"] for s in shards)}, f)
    os.replace(tmp, man_path)


def _stream_into(
    out_dir: str,
    shards: List[dict],
    ds: FolderDataset,
    encode_fn: Callable[[np.ndarray], np.ndarray],
    batch_size: int,
    shard_rows: int,
) -> None:
    """Shared build loop: embed `ds` and append complete shards in place
    (atomic shard writes, manifest rewritten after every shard)."""
    buf_rows: List[np.ndarray] = []
    buf_meta: List[Tuple[str, str]] = []
    shard_samples = 0

    def flush():
        nonlocal buf_rows, buf_meta, shard_samples
        if not buf_meta:
            return
        rows = np.concatenate(buf_rows, axis=0)
        entry = _write_shard(out_dir, _next_shard_id(shards), rows,
                             buf_meta)
        entry["samples"] = shard_samples
        shards.append(entry)
        _write_manifest(out_dir, shards, int(rows.shape[1]))
        buf_rows, buf_meta = [], []
        shard_samples = 0

    for batch in ds.batches(batch_size):
        emb = np.asarray(encode_fn(batch.pixels), dtype=np.float32)
        keep = batch.ok
        if not keep.all():
            for p, o in zip(batch.paths, keep):
                if not o:
                    log.warning("quarantined corrupt image: %s", p)
        emb = emb[keep]
        buf_rows.append(emb)
        buf_meta.extend(
            (p, c) for p, c, o in zip(batch.paths, batch.labels, keep) if o
        )
        shard_samples += len(batch)
        if sum(r.shape[0] for r in buf_rows) >= shard_rows:
            flush()
    flush()


def build_index(
    dataset: FolderDataset,
    encode_fn: Callable[[np.ndarray], np.ndarray],
    out_dir: str,
    batch_size: int = 256,
    shard_rows: int = 65536,
    resume: bool = True,
) -> GalleryIndex:
    """Stream the dataset through `encode_fn` (uint8 pixels [B,S,S,3] ->
    L2-normalized embeddings [B,D]) into a sharded on-disk index.

    Quarantined (corrupt) images are dropped, mirroring the reference's
    error-label filter (CLIP/lab1.py:81)."""
    os.makedirs(out_dir, exist_ok=True)
    man_path = os.path.join(out_dir, "manifest.json")

    shards: List[dict] = []
    if resume and os.path.exists(man_path):
        with open(man_path, encoding="utf-8") as f:
            man = json.load(f)
        shards = man["shards"]
        log.info("resuming index build: %d rows in %d complete shards",
                 sum(s["rows"] for s in shards), len(shards))

    # NOTE: resume skips whole BATCH-aligned sample prefixes. Shard rows
    # count only successfully encoded images; to make resume exact we also
    # persist per-shard how many SAMPLES were consumed.
    done_samples = sum(s.get("samples", s["rows"]) for s in shards)
    # any dataclass with `samples` and FolderDataset's batches() works
    # (an in-memory synthetic set, say): resume keeps the dataset's class
    ds = dataclasses.replace(dataset, samples=dataset.samples[done_samples:])
    _stream_into(out_dir, shards, ds, encode_fn, batch_size, shard_rows)
    return GalleryIndex.load(out_dir)
