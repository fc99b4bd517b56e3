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
manifest is rewritten after every shard. `update_index` appends shards for
new images; `compact_index` drops rows and shrinks the IVF sidecar under
`<dir>/ivf` to match (index/ivf.py), best-effort.
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


def update_index(
    dataset: FolderDataset,
    encode_fn: Callable[[np.ndarray], np.ndarray],
    out_dir: str,
    batch_size: int = 256,
    shard_rows: int = 65536,
) -> GalleryIndex:
    """Incremental update (SURVEY §7 'index/ ... incremental update'): embed
    only paths NOT already in the index and append them as new shards.
    Existing shards are untouched, so updates are as cheap as the new data;
    deleted files stay until `compact_index` drops them."""
    man_path = os.path.join(out_dir, "manifest.json")
    with open(man_path, encoding="utf-8") as f:
        shards = json.load(f)["shards"]
    have = set()
    for s in shards:
        with open(os.path.join(out_dir, s["meta"]), encoding="utf-8") as f:
            have.update(m[0] for m in json.load(f))
    new = [smp for smp in dataset.samples if smp[0] not in have]
    log.info("index update: %d existing rows, %d new images",
             len(have), len(new))
    ds = dataclasses.replace(dataset, samples=new)
    _stream_into(out_dir, shards, ds, encode_fn, batch_size, shard_rows)
    return GalleryIndex.load(out_dir)


def compact_index(
    out_dir: str,
    keep: Optional[Callable[[str, str], bool]] = None,
    drop_missing: bool = True,
) -> GalleryIndex:
    """Drop rows whose (path, class) fails `keep` (default: keep all) or
    whose file no longer exists (`drop_missing`) — the index side of the
    governance deletions (dedup/leakage/normalize remove files; the index
    must follow). Shards are rewritten atomically in place; untouched
    shards are left as-is."""
    man_path = os.path.join(out_dir, "manifest.json")
    with open(man_path, encoding="utf-8") as f:
        man = json.load(f)
    new_shards: List[dict] = []
    dim = man["embed_dim"]
    dropped = 0
    # rewritten shards get FRESH ids past every existing one — reusing
    # positional ids could overwrite a kept shard's file mid-compaction
    # (ids are parsed from names: repeated compactions keep growing them)
    next_id = _next_shard_id(man["shards"])
    stale_files: List[str] = []
    global_mask: List[bool] = []     # kept-row mask in global row order
    masks: List[List[bool]] = []     # per-shard, computed before any rewrite
    for s in man["shards"]:
        with open(os.path.join(out_dir, s["meta"]), encoding="utf-8") as f:
            meta = [(m[0], m[1]) for m in json.load(f)]
        mask = []
        for p, c in meta:
            ok = keep(p, c) if keep is not None else True
            if ok and drop_missing and not os.path.exists(p):
                ok = False
            mask.append(ok)
        global_mask += mask
        masks.append(mask)
    # Validate the ANN sidecar against the OLD gallery while it is still
    # loadable: a stale sidecar whose n_total happens to match (gallery
    # re-embedded in place at the same row count) must NOT be renumbered
    # and restamped with a fresh fingerprint — its cluster assignments
    # belong to the old embedding space. Checked here, consumed after the
    # rewrite (post-rewrite the old rows are gone and unverifiable).
    sidecar = os.path.join(out_dir, "ivf")
    shrink_ok = True
    if (not all(global_mask)
            and os.path.exists(os.path.join(sidecar, "ivf.json"))):
        shrink_ok = _sidecar_matches_old_gallery(out_dir, man, sidecar)
    for s, mask in zip(man["shards"], masks):
        with open(os.path.join(out_dir, s["meta"]), encoding="utf-8") as f:
            meta = [(m[0], m[1]) for m in json.load(f)]
        if all(mask):
            new_shards.append(s)
            continue
        dropped += mask.count(False)
        stale_files += [s["data"], s["meta"]]
        sel = np.asarray(mask, bool)
        kept_meta = [m for m, k in zip(meta, mask) if k]
        if not kept_meta:
            continue                      # whole shard gone
        rows = np.asarray(np.load(os.path.join(out_dir, s["data"]),
                                  mmap_mode="r"))
        entry = _write_shard(out_dir, next_id, rows[sel], kept_meta)
        next_id += 1
        entry["samples"] = entry["rows"]
        new_shards.append(entry)
    _write_manifest(out_dir, new_shards, dim)
    for name in stale_files:
        try:
            os.unlink(os.path.join(out_dir, name))
        except OSError:
            pass
    log.info("index compact: dropped %d rows, %d shards remain",
             dropped, len(new_shards))
    idx = GalleryIndex.load(out_dir)
    if (dropped and shrink_ok
            and os.path.exists(os.path.join(sidecar, "ivf.json"))):
        # keep the trained ANN sidecar in step: renumber + re-front-fill
        # instead of re-running k-means (280 s at 10M rows). Any
        # mismatch (e.g. an un-extended sidecar) just warns — the next
        # engine build detects it and retrains. Best-effort by contract,
        # so ANY failure degrades to warn-and-retrain, never a crash.
        try:
            from mmrs_tpu_torch.index.ivf import shrink_sidecar

            shrink_sidecar(sidecar, np.asarray(global_mask, bool),
                           idx.embeddings)
        except Exception as e:
            log.warning("ivf sidecar not shrunk (%s); the next engine "
                        "build retrains it", e)
    return idx


def _sidecar_matches_old_gallery(out_dir: str, man: dict,
                                 sidecar: str) -> bool:
    """True if the saved IVF sidecar's fingerprint matches the CURRENT
    (pre-compaction) gallery content, so shrink_sidecar may safely
    renumber it. Reads only the ~64 strided fingerprint rows via a lazy
    shard-routing view — no consolidation, no full residency."""
    try:
        from mmrs_tpu_torch.index.ivf import gallery_fingerprint, sidecar_meta

        meta = sidecar_meta(sidecar)
        want = (meta or {}).get("fingerprint")
        if not want:          # pre-fingerprint sidecar: nothing to verify
            return True
        got = gallery_fingerprint(_ShardRowView(out_dir, man))
        if got == want:
            return True
        log.warning("ivf sidecar fingerprint does not match the "
                    "pre-compaction gallery (stale sidecar from an "
                    "earlier embedding run?) — skipping shrink; the "
                    "next engine build retrains it")
        return False
    except Exception as e:                      # best-effort gate
        log.warning("ivf sidecar pre-compaction check failed (%s); "
                    "skipping shrink", e)
        return False


class _ShardRowView:
    """Minimal [N, D] row-indexable view over the on-disk shards (mmap),
    just enough surface for gallery_fingerprint: `.shape` + `view[i]`."""

    def __init__(self, out_dir: str, man: dict):
        self._dir = out_dir
        self._shards = man["shards"]
        self._starts = np.cumsum([0] + [s["rows"] for s in self._shards])
        self.shape = (int(self._starts[-1]), int(man["embed_dim"]))

    def __getitem__(self, i: int):
        s = int(np.searchsorted(self._starts, i, side="right")) - 1
        data = np.load(os.path.join(self._dir, self._shards[s]["data"]),
                       mmap_mode="r")
        return data[i - int(self._starts[s])]
