"""IVF (inverted-file) ANN index — sub-linear gallery search on the GPU.

Counterpart of mmrs_tpu/index/ivf.py. A query scores the C centroids,
keeps the `nprobe` best clusters, and scans only their buckets plus a
small exact "spill" of the rows that did not fit a bucket. Per query a
probe reads about nprobe/C of the gallery instead of all of it;
`nprobe == C` probes every bucket and is exactly the flat scan.

  - Training: spherical k-means on a row sample (plain PyTorch; the E-step
    sums go through `index_add_`), then one assignment pass over the
    whole gallery, streamed in chunks.
  - Slots: `_auto_cap`, `_placement` and the int4 rounding of the bucket
    capacity and the spill length to 128 are the JAX package's, so both
    packages build the same slot maps (`bucket_ids`, `spill_ids`) from the
    same centroids, and a sidecar means the same in both. The int4
    rounding is a TPU lane artefact; here it costs at most 127 dead slots
    per bucket, kept for that equality.
  - Device layout (the port's own): bucket rows [C, cap, D] bf16 or int8
    (+ [C, cap] f32 scales), or packed int4 rows [C, cap, D/2] uint8 in
    ops/quant4.py's row-major packing; spill [S, D] or [S, D/2]. D is not
    padded (the JAX package pads it to 128 lanes).
  - Search: the bucket probe is a hand-written CUDA kernel
    (`csrc/ivf_probe.cu`: K7 over bf16/int8 buckets, K8 over int4), the
    spill an exact plain matmul, then one merge.

Tie rule (the JAX package's, from its sequential probe grid): candidates
rank by score, descending; equal scores rank by position, where bucket
slot `s` of the query's `r`-th probed cluster is position r * cap + s and
every spill row comes after every bucket slot, in spill order. Empty
slots and short lists give (-inf, -1).

Sidecar files (`save_ivf` / `load_ivf`) are the JAX package's format:
either package loads what the other wrote and serves the same ids.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.models.layers import _mm_f32
from mmrs_tpu_torch.ops import _cuda, topk
from mmrs_tpu_torch.ops.normalize import l2_normalize
from mmrs_tpu_torch.ops.quant import MAX_DIM, quantize_rows
from mmrs_tpu_torch.ops.quant4 import (prep_queries, quantize_rows_int4,
                                       scores_int4)
from mmrs_tpu_torch.ops.topk import NEG_INF, sorted_topk
from mmrs_tpu_torch.pipeline import default_device
from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_TRAIN_CHUNK = 65536     # E-step rows per [chunk, C] score block
_STREAM_CHUNK = 65536    # host -> device build streaming rows


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _default_device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


def auto_clusters(n_rows: int) -> int:
    """Power of two near sqrt(N) (the classic IVF sizing): 1M -> 1024,
    10M -> 4096; clamped to N/8 (a power of two) for tiny galleries."""
    if n_rows <= 1:
        return 1
    clamp = max(1, n_rows // 8)
    clamp = 1 << (clamp.bit_length() - 1)   # round DOWN to a power of two
    return min(1 << math.ceil(math.log2(math.sqrt(n_rows))), clamp)


def auto_nprobe(n_clusters: int) -> int:
    """Default probe width: C/8, at least 8 (tune per corpus with
    `tune_nprobe`; nprobe == C is exact)."""
    return max(1, min(n_clusters, max(8, n_clusters // 8)))


@dataclass
class IVFIndex:
    """Device-resident IVF structure. Row ids are GLOBAL gallery rows, so
    results are interchangeable with ops/topk.cosine_topk's."""

    centroids: torch.Tensor   # [C, D] L2-normalized, in the build dtype
    buckets: torch.Tensor     # [C, cap, D] bf16/f32/int8 or [C, cap, D/2] u8
    bucket_ids: torch.Tensor  # [C, cap] int32 global row ids, -1 empty
    spill: torch.Tensor       # [S, D] rows or [S, D/2] packed
    spill_ids: torch.Tensor   # [S] int32, -1 empty
    n_total: int              # live gallery rows
    dim: int                  # embedding dim D
    bucket_scales: Optional[torch.Tensor] = None   # [C, cap] f32 (int8/int4)
    spill_scales: Optional[torch.Tensor] = None    # [S] f32
    # host seconds of the build that made this index: {"train", "assign",
    # "fill"} (synchronized on a GPU; 0.0 for a pass that was skipped)
    build_seconds: Optional[dict] = None

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def bucket_cap(self) -> int:
        return int(self.bucket_ids.shape[1])

    @property
    def quant(self) -> str:
        """"" (bf16/f32 rows) | "int8" | "int4"."""
        if self.buckets.dtype == torch.uint8:
            return "int4"
        return "int8" if self.bucket_scales is not None else ""

    @property
    def quantized(self) -> bool:
        return self.bucket_scales is not None

    def hbm_bytes(self) -> int:
        arrs = [self.centroids, self.buckets, self.bucket_ids, self.spill,
                self.spill_ids]
        if self.quantized:
            arrs += [self.bucket_scales, self.spill_scales]
        return sum(a.numel() * a.element_size() for a in arrs)


# -- training -----------------------------------------------------------------


def _spherical_kmeans(x: torch.Tensor, cents: torch.Tensor, iters: int
                      ) -> torch.Tensor:
    """Spherical k-means EM from the given initial centroids: x [M, D] f32
    L2-normalized rows, cents [k, D] f32. Cosine assignment (lowest
    cluster on ties); a cluster that gets no rows, or whose sum is ~0,
    keeps its centroid."""
    k = cents.shape[0]
    for _ in range(iters):
        sums = torch.zeros_like(cents)
        counts = torch.zeros(k, dtype=torch.int64, device=x.device)
        for a in range(0, x.shape[0], _TRAIN_CHUNK):
            xb = x[a:a + _TRAIN_CHUNK]
            assign = torch.argmax(xb @ cents.T, dim=1)
            sums.index_add_(0, assign, xb)
            counts += torch.bincount(assign, minlength=k)
        norm = sums.norm(dim=1, keepdim=True)
        cents = torch.where((counts[:, None] > 0) & (norm > 1e-12),
                            sums / norm.clamp_min(1e-12), cents)
    return cents


def train_centroids(sample, n_clusters: int, iters: int = 10, seed: int = 0,
                    device=None, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Spherical k-means centroids [C, D] f32 from a row sample. The
    initial centroids are distinct sample rows drawn by `generator` (a CPU
    generator seeded with `seed` when none is given), so a seed gives the
    same index on every device."""
    x = torch.as_tensor(np.asarray(sample) if not isinstance(
        sample, torch.Tensor) else sample)
    x = l2_normalize(x.to(_default_device(device if device is not None
                                          else x.device)).float())
    m = x.shape[0]
    if n_clusters > m:
        raise ValueError(f"n_clusters {n_clusters} > sample rows {m}")
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    idx = torch.randperm(m, generator=generator,
                         device=generator.device)[:n_clusters]
    return _spherical_kmeans(x, x[idx.to(x.device)].clone(), iters)


# -- build --------------------------------------------------------------------


def _assign_chunk(rows: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid (cosine, lowest cluster on ties) of each row."""
    return torch.argmax(l2_normalize(rows.float()) @ cents.T, dim=1)


def _auto_cap(assign: np.ndarray, n_clusters: int, n: int,
              cover: float = 0.98, max_slots_frac: float = 1.3) -> int:
    """Bucket capacity from the measured cluster histogram: the smallest
    cap whose buckets hold >= `cover` of all rows (the rest spill to the
    exact scan), bounded so total slots stay <= max_slots_frac * n."""
    counts = np.bincount(assign, minlength=n_clusters)
    caps = np.unique(counts)
    lo = 0
    for c in caps:  # <= C candidates; covered(c) is monotone in c
        if np.minimum(counts, c).sum() >= cover * n:
            lo = int(c)
            break
    else:
        lo = int(caps[-1])
    hi = max(8, math.floor(max_slots_frac * n / n_clusters))
    return _round_up(max(8, min(lo, hi)), 8)


def _placement(assign: np.ndarray, n_clusters: int,
               cap: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """Host-side slotting. Returns (bpos [N], spos [N], bucket_ids
    [C*cap], spill_ids [S]); bpos/spos are -1 where the row goes to the
    other structure. Rows fill each bucket in row order."""
    n = assign.shape[0]
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    starts = np.searchsorted(sorted_assign, np.arange(n_clusters))
    rank = np.arange(n, dtype=np.int64) - starts[sorted_assign]
    in_bucket = rank < cap

    bpos = np.full(n, -1, np.int32)
    spos = np.full(n, -1, np.int32)
    flat = (sorted_assign.astype(np.int64) * cap + rank)[in_bucket]
    bpos[order[in_bucket]] = flat.astype(np.int32)
    n_spill = int((~in_bucket).sum())
    spos[order[~in_bucket]] = np.arange(n_spill, dtype=np.int32)

    bucket_ids = np.full(n_clusters * cap, -1, np.int32)
    bucket_ids[flat] = order[in_bucket].astype(np.int32)
    spill_ids = order[~in_bucket].astype(np.int32)
    return bpos, spos, bucket_ids, spill_ids


def _alloc(c: int, cap: int, s_rows: int, d: int, quant: str,
           dtype: torch.dtype, device: torch.device):
    """Zeroed (buckets, bucket_scales, spill, spill_scales) in the port's
    device layout."""
    width, row_dtype = d, (torch.int8 if quant == "int8" else dtype)
    if quant == "int4":
        width, row_dtype = d // 2, torch.uint8
    buckets = torch.zeros((c, cap, width), dtype=row_dtype, device=device)
    spill = torch.zeros((s_rows, width), dtype=row_dtype, device=device)
    bscales = sscales = None
    if quant:
        bscales = torch.zeros((c, cap), dtype=torch.float32, device=device)
        sscales = torch.zeros((s_rows,), dtype=torch.float32, device=device)
    return buckets, bscales, spill, sscales


def _fill_chunk(arrays, rows: torch.Tensor, bpos: np.ndarray,
                spos: np.ndarray, quant: str) -> None:
    """Write one chunk of gallery rows into its bucket and spill slots, in
    place. Each row takes the JAX package's chain from f32: L2-normalize,
    then cast (bf16/f32), or quantize (int8 codes, or packed int4)."""
    buckets, bscales, spill, sscales = arrays
    rows = l2_normalize(rows.to(buckets.device).float())
    scale = None
    if quant == "int4":
        vals, scale = quantize_rows_int4(rows)
    elif quant == "int8":
        vals, scale = quantize_rows(rows)
    else:
        vals = rows.to(buckets.dtype)
    for dst, dst_scales, pos in ((buckets.view(-1, buckets.shape[-1]),
                                  bscales, bpos),
                                 (spill, sscales, spos)):
        live = np.flatnonzero(pos >= 0)
        if live.size == 0:
            continue
        src = torch.from_numpy(live).to(rows.device)
        at = torch.from_numpy(pos[live].astype(np.int64)).to(rows.device)
        dst[at] = vals[src]
        if scale is not None:
            dst_scales.view(-1)[at] = scale[src]


def _quant_mode(quantize) -> str:
    quant = {True: "int8", False: "", None: ""}.get(quantize, quantize)
    if quant not in ("", "int8", "int4"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    return quant


def build_ivf(
    embeddings,                       # [N, D] host array-like (memmap ok)
    n_clusters: int = 0,              # 0 = auto (pow2 near sqrt N)
    bucket_cap: int = 0,              # 0 = auto (_auto_cap)
    iters: int = 10,
    train_rows: int = 262_144,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    chunk: int = _STREAM_CHUNK,
    centroids=None,                   # reuse trained centroids [C, D]
    assignments: Optional[np.ndarray] = None,  # reuse a prior full pass
    quantize=False,                   # False | True/"int8" | "int4"
    cover: float = 0.98,              # auto-cap slot budget (spill = 1-cover)
    slots_frac: float = 1.3,          # total-slots ceiling (x n rows)
    device=None,
    mesh=None,                        # slot-shard the buckets over it
) -> IVFIndex:
    """Train (or reuse) centroids, assign every row, and stream the rows
    into the buckets. Host memory stays about one chunk; device memory is
    the buckets plus the spill. With `mesh`, the buckets and the spill are
    allocated already slot-sharded (parallel/ivf.py) and each device only
    ever holds its strips: a ShardedIVF."""
    n, d = embeddings.shape
    if n == 0:
        raise ValueError("empty gallery")
    device = _default_device(device)
    sample = None
    if centroids is None and assignments is None:
        m = min(n, max(train_rows,
                       n_clusters if n_clusters > 0 else auto_clusters(n)))
        sel = (np.linspace(0, n - 1, m).astype(np.int64)
               if m < n else np.arange(n))
        sample = torch.from_numpy(np.asarray(embeddings[sel], np.float32))

    def chunks():
        for a in range(0, n, chunk):
            rows = np.array(embeddings[a:a + chunk], np.float32)
            if rows.shape[0] < chunk:
                rows = np.concatenate(
                    [rows, np.zeros((chunk - rows.shape[0], d), np.float32)])
            yield torch.from_numpy(rows)

    return build_ivf_streaming(
        chunks, n, d, n_clusters=n_clusters, bucket_cap=bucket_cap,
        iters=iters, seed=seed, dtype=dtype, chunk=chunk, sample=sample,
        centroids=centroids, assignments=assignments, quantize=quantize,
        cover=cover, slots_frac=slots_frac, device=device, mesh=mesh)


def build_ivf_streaming(
    make_chunks,                      # () -> iterator of [chunk, D] tensors
    n: int,
    d: int,
    n_clusters: int = 0,
    bucket_cap: int = 0,
    iters: int = 10,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    chunk: int = _STREAM_CHUNK,
    sample=None,                      # training rows [M, D]
    centroids=None,
    assignments: Optional[np.ndarray] = None,
    train_rows: int = 262_144,
    quantize=False,
    cover: float = 0.98,
    slots_frac: float = 1.3,
    device=None,
    mesh=None,
) -> IVFIndex:
    """Build from a re-iterable chunk source (device tensors welcome: the
    1M-row check generates its chunks on the card). Chunks must be exactly
    `chunk` rows (zero-pad the tail). Passes: [sample], assign, fill. With
    no `sample`, the training rows are strided out of the stream itself
    (one extra pass). The index keeps each pass's seconds in
    `build_seconds`. With `mesh` the capacity rounds to a multiple of 8 S
    (int4: 128 S) and the spill pad likewise, as the JAX package's sharded
    build, so both place the same rows in the same slots; training and
    assignment run on `device`, the fill streams into each shard's strips
    (parallel/ivf.fill_strips)."""
    import time

    if n <= 0:
        raise ValueError("empty gallery")
    if assignments is not None and centroids is None:
        # fresh centroids would disagree with the stale row placement
        raise ValueError(
            "assignments without centroids: reusing a prior assignment "
            "pass only makes sense with the centroids that produced it")
    device = _default_device(device)
    if n_clusters <= 0:
        n_clusters = auto_clusters(n)
    n_clusters = min(n_clusters, n)
    quant = _quant_mode(quantize)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    seconds = {"train": 0.0, "assign": 0.0, "fill": 0.0}
    t0 = sync()
    if centroids is None:
        if sample is None:
            m = min(n, max(train_rows, n_clusters))
            stride = max(1, n // m)
            parts = []
            for ci, rows in enumerate(make_chunks()):
                valid = min(chunk, n - ci * chunk)
                parts.append(torch.as_tensor(rows)[:valid:stride].to(device))
            sample = torch.cat(parts)[:m]
            del parts
        centroids = train_centroids(sample, n_clusters, iters=iters,
                                    seed=seed, device=device)
        seconds["train"] = sync() - t0
    sample = None
    cents = l2_normalize(torch.as_tensor(
        np.array(centroids) if not isinstance(centroids, torch.Tensor)
        else centroids).to(device).float())
    if cents.shape[0] != n_clusters:
        raise ValueError("centroids/n_clusters mismatch")

    t0 = sync()
    if assignments is None:
        parts = [_assign_chunk(torch.as_tensor(rows).to(device), cents)
                 for rows in make_chunks()]
        assignments = torch.cat(parts)[:n].cpu().numpy()
        seconds["assign"] = sync() - t0
    assignments = np.asarray(assignments, np.int32)
    if assignments.shape[0] != n:
        raise ValueError("assignments/rows mismatch")

    t0 = sync()
    if bucket_cap <= 0:
        bucket_cap = _auto_cap(assignments, n_clusters, n, cover=cover,
                               max_slots_frac=slots_frac)
    bucket_cap = min(bucket_cap, _round_up(n, 8))
    shards = 1
    if mesh is not None:
        from mmrs_tpu_torch.parallel.mesh import DATA_AXIS

        shards = mesh.shape[DATA_AXIS]
        bucket_cap = _round_up(bucket_cap, 8 * shards)
    if quant == "int4":
        # the JAX package's lane rounding, kept so slot maps are equal
        bucket_cap = _round_up(bucket_cap, 128 * shards)
    bpos, spos, bucket_ids, spill_ids = _placement(assignments, n_clusters,
                                                   bucket_cap)
    n_spill = spill_ids.shape[0]
    s_pad = (max(128, _round_up(n_spill, 128 * shards)) if quant == "int4"
             else max(8, _round_up(n_spill, 8 * shards)))
    item = {"": torch.finfo(dtype).bits / 8, "int8": 1, "int4": 0.5}[quant]
    log.info(
        "ivf: C=%d cap=%d -> %.2f GB buckets + %.2f GB spill (%d rows, "
        "%.2f%% — scanned exactly)", n_clusters, bucket_cap,
        n_clusters * bucket_cap * d * item / 1e9, s_pad * d * item / 1e9,
        n_spill, 100.0 * n_spill / n)

    if mesh is not None:
        from mmrs_tpu_torch.parallel.ivf import fill_strips

        sids = np.full(s_pad, -1, np.int32)
        sids[:n_spill] = spill_ids
        out = fill_strips(
            ((ci * chunk, torch.as_tensor(rows))
             for ci, rows in enumerate(make_chunks())), n, d,
            cents.to(dtype), bucket_ids.reshape(n_clusters, bucket_cap),
            sids, quant, dtype, mesh)
        seconds["fill"] = sync() - t0
        out.build_seconds = seconds
        return out
    arrays = _alloc(n_clusters, bucket_cap, s_pad, d, quant, dtype, device)
    for ci, rows in enumerate(make_chunks()):
        a = ci * chunk
        b = min(a + chunk, n)
        _fill_chunk(arrays, torch.as_tensor(rows)[:b - a], bpos[a:b],
                    spos[a:b], quant)
    seconds["fill"] = sync() - t0

    sids = np.full(s_pad, -1, np.int32)
    sids[:n_spill] = spill_ids
    buckets, bscales, spill, sscales = arrays
    return IVFIndex(
        centroids=cents.to(dtype),
        buckets=buckets,
        bucket_ids=torch.from_numpy(
            bucket_ids.reshape(n_clusters, bucket_cap)).to(device),
        spill=spill,
        spill_ids=torch.from_numpy(sids).to(device),
        n_total=n,
        dim=d,
        bucket_scales=bscales,
        spill_scales=sscales,
        build_seconds=seconds,
    )


# -- search: the bucket probe (K7, K8) ------------------------------------------


def _probe_plain(probe, bucket_ids, k, score_rows):
    """The plain probe: per query (bounded memory, as `_probe_buckets_xla`
    maps over queries), gather the probed buckets, score them with
    `score_rows(i, pids)` -> [P*cap] f32, mask empty slots and keep the
    stable top-k of the positions (lowest position first on ties)."""
    qn, p = probe.shape
    vals = torch.full((qn, k), NEG_INF, device=probe.device)
    ids = torch.full((qn, k), -1, dtype=torch.int32, device=probe.device)
    for i in range(qn):
        pids = probe[i].long()
        flat_ids = bucket_ids[pids].reshape(-1)
        s = torch.where(flat_ids >= 0, score_rows(i, pids), NEG_INF)
        v, pos = sorted_topk(s[None, :], k)
        vals[i] = v[0]
        ids[i] = torch.where(pos[0] >= 0, flat_ids[pos[0].clamp_min(0).long()],
                             -1)
    return vals, ids


def _check_probe(name: str, qn: int, d: int, probe, buckets, bucket_ids,
                 scales, k: int, width: int) -> None:
    """Shapes and limits both probe kernels share."""
    c, cap, w = buckets.shape
    if probe.dtype != torch.int32 or bucket_ids.dtype != torch.int32:
        raise ValueError(f"{name}: probe and bucket_ids must be int32")
    if (probe.dim() != 2 or probe.shape[0] != qn or w != width
            or bucket_ids.shape != (c, cap)):
        raise ValueError(
            f"{name}: queries [{qn}, {d}], probe {tuple(probe.shape)}, "
            f"buckets {tuple(buckets.shape)} and bucket_ids "
            f"{tuple(bucket_ids.shape)} do not match")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (c, cap)):
        raise ValueError(f"{name}: scales must be f32 [{c}, {cap}]")
    topk.check_scan_shapes(name, qn, probe.shape[1] * cap, k)


PROBE_TILE = 8   # K7's and K8's queries a tile (csrc/ivf_probe.cu kProbeQT)


def _chunked_slots(p: int, cap: int) -> int:
    """The probe scans' n: P buckets of ceil(cap / 256) 256-slot chunks,
    one partial list each (list r * n_cc + c)."""
    return p * -(-cap // topk.CHUNK_ROWS) * topk.CHUNK_ROWS


def bucket_owners(probe: torch.Tensor) -> torch.Tensor:
    """K7's and K8's ownership rule, in plain PyTorch: [Q, P] bool, True
    where entry (q, r) is the first entry of its tile of PROBE_TILE
    queries, in row-major (q, r) order, to name its bucket. The kernel reads each
    owner's bucket once and writes its scores for every entry of the tile
    naming it."""
    qn, p = probe.shape
    width = PROBE_TILE * p
    pad = -(-qn // PROBE_TILE) * PROBE_TILE - qn
    flat = torch.cat([probe, probe.new_full((pad, p), 0)]).reshape(-1, width)
    order = torch.arange(width, device=probe.device)
    same = flat[:, :, None] == flat[:, None, :]            # [tiles, e, e']
    earlier = same & (order[None, :] < order[:, None])[None]
    return ~earlier.any(2).reshape(-1, p)[:qn]


def _probe_cuda(name: str, q_rows: torch.Tensor, probe, bucket_ids, k: int,
                scan, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a probe scan through the gallery scans' merge passes
    (ops/topk.scan_and_merge) over partial lists of n / 256 chunks a
    query, then map the winning positions to global ids. The partials
    carry the virtual position r * cap + s (slot s of the query's r-th
    probed bucket), so the merge's (score desc, id asc) order is exactly
    the tie rule. `scan(a, b, kc, part_v, part_i, stream)` launches
    the scan for queries a..b-1."""
    qn, p = probe.shape
    c, cap = bucket_ids.shape
    lib = _cuda.library()

    def run(a: int, b: int):
        vals, pos = topk.scan_and_merge(
            b - a, n, k, q_rows.device,
            lambda *args: scan(a, b, *args), name)
        ids = torch.empty((b - a, k), dtype=torch.int32,
                          device=q_rows.device)
        # under the tensors' device, as every launch: on another card
        # than the current one the stream would meet the wrong context
        with torch.cuda.device(q_rows.device):
            _cuda.check(lib.mmrs_probe_ids(
                vals.data_ptr(), pos.data_ptr(), probe[a:b].data_ptr(),
                bucket_ids.data_ptr(), b - a, p, c, cap, k, ids.data_ptr(),
                _cuda.stream_of(q_rows)), f"{name} ids")
        return vals, ids

    return topk.by_query_slices(qn, run)


def _probe_buckets_cuda(q, probe, buckets, bucket_ids, scales, k):
    name = "probe_buckets"
    _cuda.require_cuda(name, q, probe, buckets, bucket_ids,
                       *(() if scales is None else (scales,)))
    qn, d = q.shape
    if q.dtype != torch.bfloat16 or buckets.dtype not in (torch.bfloat16,
                                                          torch.int8):
        raise ValueError(f"{name} kernel takes bf16 queries and bf16 or int8 "
                         f"buckets, got {q.dtype} and {buckets.dtype}")
    if (buckets.dtype == torch.int8) != (scales is not None):
        raise ValueError(f"{name}: int8 buckets need scales, bf16 none")
    _check_probe(name, qn, d, probe, buckets, bucket_ids, scales, k, d)
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"{name} kernel needs D % 8 == 0 and D <= "
                         f"{MAX_DIM}, got D={d}")
    if q.data_ptr() % 16 or buckets.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned rows")
    c, cap = bucket_ids.shape
    p = probe.shape[1]
    out = _probe_cuda(
        name, q, probe, bucket_ids, k,
        lambda a, b, kc, pv, pi, stream: _cuda.library().mmrs_probe_scan(
            q[a:b].data_ptr(), probe[a:b].data_ptr(), buckets.data_ptr(),
            bucket_ids.data_ptr(), 0 if scales is None else scales.data_ptr(),
            int(buckets.dtype == torch.int8), b - a, p, c, cap, d, kc, pv, pi,
            stream), _chunked_slots(p, cap))
    probe_buckets.launches += 1
    return out


def probe_buckets(
    q: torch.Tensor,            # [Q, D] bf16 (f32 for f32 buckets, plain only)
    probe: torch.Tensor,        # [Q, P] int32 cluster ids, best first
    buckets: torch.Tensor,      # [C, cap, D] bf16 / f32 / int8
    bucket_ids: torch.Tensor,   # [C, cap] int32, -1 empty
    scales: Optional[torch.Tensor],   # [C, cap] f32 for int8 buckets
    k: int,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the top k of each query over its probed buckets (values [Q, k]
    f32, global ids [Q, k] int32). Scores are f32 sums of q * row (int8
    rows widen exactly, the query is never quantized), times the slot's
    scale for int8. On a CUDA tensor the kernel runs, or this raises."""
    if _cuda.takes_kernel(impl, q):
        return _probe_buckets_cuda(q, probe, buckets, bucket_ids, scales, k)
    d = buckets.shape[2]

    def score(i, pids):
        s = _mm_f32(buckets[pids].reshape(-1, d).to(q.dtype), q[i:i + 1])
        s = s[:, 0]
        return s if scales is None else s * scales[pids].reshape(-1)

    return _probe_plain(probe, bucket_ids, k, score)


probe_buckets.launches = 0   # kernel launches, for showing the path ran it


def _probe_buckets_q4_cuda(q_q, q_scale, rs_q, probe, buckets, bucket_ids,
                           scales, k):
    name = "probe_buckets_q4"
    _cuda.require_cuda(name, q_q, q_scale, rs_q, probe, buckets, bucket_ids,
                       scales)
    qn, d = q_q.shape
    if (q_q.dtype != torch.int8 or buckets.dtype != torch.uint8
            or q_scale.dtype != torch.float32 or rs_q.dtype != torch.float32):
        raise ValueError(f"{name} kernel takes int8 query codes, f32 query "
                         f"scales and rowsums and uint8 packed buckets")
    if q_scale.shape != (qn,) or rs_q.shape != (qn,):
        raise ValueError(f"{name}: query scales / rowsums must be [{qn}]")
    _check_probe(name, qn, d, probe, buckets, bucket_ids, scales, k, d // 2)
    if d % 16 or d > MAX_DIM:
        raise ValueError(f"{name} kernel needs D % 16 == 0 and D <= "
                         f"{MAX_DIM}, got D={d}")
    if q_q.data_ptr() % 16 or buckets.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs 16-byte aligned rows")
    c, cap = bucket_ids.shape
    p = probe.shape[1]
    out = _probe_cuda(
        name, q_q, probe, bucket_ids, k,
        lambda a, b, kc, pv, pi, stream: _cuda.library().mmrs_probe_scan_q4(
            q_q[a:b].data_ptr(), q_scale[a:b].data_ptr(),
            rs_q[a:b].data_ptr(), probe[a:b].data_ptr(), buckets.data_ptr(),
            bucket_ids.data_ptr(), scales.data_ptr(), b - a, p, c, cap, d,
            kc, pv, pi, stream), _chunked_slots(p, cap))
    probe_buckets_q4.launches += 1
    return out


def probe_buckets_q4(
    q_q: torch.Tensor,          # [Q, D] int8 query codes (prep_queries)
    q_scale: torch.Tensor,      # [Q] f32
    rs_q: torch.Tensor,         # [Q] f32 rowsum of the low half's codes
    probe: torch.Tensor,        # [Q, P] int32
    buckets: torch.Tensor,      # [C, cap, D/2] uint8 packed int4 rows
    bucket_ids: torch.Tensor,   # [C, cap] int32
    scales: torch.Tensor,       # [C, cap] f32
    k: int,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: the same probe over int4 packed buckets. Scores are exact int32
    dots and the shared f32 epilogue (ops/quant4._score_f32), so they are
    bit-identical to the JAX package's. On a CUDA tensor the kernel runs,
    or this raises."""
    if _cuda.takes_kernel(impl, q_q):
        return _probe_buckets_q4_cuda(q_q, q_scale, rs_q, probe, buckets,
                                      bucket_ids, scales, k)
    w = buckets.shape[2]

    def score(i, pids):
        return scores_int4(q_q[i:i + 1], q_scale[i:i + 1], rs_q[i:i + 1],
                           buckets[pids].reshape(-1, w),
                           scales[pids].reshape(-1))[0]

    return _probe_plain(probe, bucket_ids, k, score)


probe_buckets_q4.launches = 0   # kernel launches, for showing the path ran it


# -- search: ivf_topk -----------------------------------------------------------


def _merge_spill(vals, ids, ss, spill_ids, k):
    """Exact spill candidates [Q, S] (masked), then the final merge: the
    probe's list first, so equal scores keep bucket slots before spill
    rows (the tie rule)."""
    ss = torch.where(spill_ids[None, :] >= 0, ss, NEG_INF)
    sv, si = sorted_topk(ss, min(k, ss.shape[1]))
    sid = spill_ids[si.long()]
    fv, fo = sorted_topk(torch.cat([vals, sv], dim=1), k)
    fi = torch.gather(torch.cat([ids, sid], dim=1), 1, fo.long())
    return torch.where(fi < 0, NEG_INF, fv), fi


def _ivf_topk_body(q, ivf: IVFIndex, probe, k: int, impl: str):
    """bf16 / f32 / int8 buckets: probe (K7) + the exact spill scan."""
    qd = q.to(torch.bfloat16 if ivf.quantized else ivf.buckets.dtype)
    vals, ids = probe_buckets(qd, probe, ivf.buckets, ivf.bucket_ids,
                              ivf.bucket_scales, k, impl=impl)
    ss = _mm_f32(qd, ivf.spill.to(qd.dtype))
    if ivf.quantized:
        ss = ss * ivf.spill_scales[None, :]
    return _merge_spill(vals, ids, ss, ivf.spill_ids, k)


def _ivf_topk_body_q4(q, ivf: IVFIndex, probe, k: int, impl: str):
    """int4 buckets: probe (K8) + the exact packed spill scan."""
    q_q, q_scale, rs_q = prep_queries(q.float())
    vals, ids = probe_buckets_q4(q_q, q_scale, rs_q, probe, ivf.buckets,
                                 ivf.bucket_ids, ivf.bucket_scales, k,
                                 impl=impl)
    ss = scores_int4(q_q, q_scale, rs_q, ivf.spill, ivf.spill_scales)
    return _merge_spill(vals, ids, ss, ivf.spill_ids, k)


def ivf_topk(
    queries: torch.Tensor,    # [Q, D] L2-normalized
    ivf: IVFIndex,
    k: int = 10,
    nprobe: int = 0,          # 0 = auto
    impl: str = "auto",       # auto (kernels on a GPU) | torch (plain)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (cosines [Q, k] f32, global row ids [Q, k] int32), best first
    under the tie rule above: the cosine_topk contract restricted to the
    probed buckets plus the exact spill. nprobe == C is the flat scan."""
    if nprobe <= 0:
        nprobe = auto_nprobe(ivf.n_clusters)
    nprobe = min(nprobe, ivf.n_clusters)
    k = min(k, ivf.n_total)
    q = queries.to(ivf.buckets.device)
    body = _ivf_topk_body_q4 if ivf.quant == "int4" else _ivf_topk_body
    return body(q, ivf, probe_lists(q, ivf, nprobe), k, impl)


def probe_lists(queries: torch.Tensor, ivf: IVFIndex, nprobe: int
                ) -> torch.Tensor:
    """[Q, nprobe] int32: each query's best clusters, best first. Centroid
    scores take operands in the centroids' dtype and f32 sums; the stable
    sort keeps the lowest cluster first on ties (lax.top_k's rule)."""
    csims = _mm_f32(queries.to(ivf.centroids.dtype), ivf.centroids)
    return sorted_topk(csims, nprobe)[1].contiguous()


def tune_nprobe(ivf: IVFIndex, embeddings, target_recall: float = 0.95,
                k: int = 10, n_queries: int = 64, impl: str = "auto",
                mesh=None) -> dict:
    """Smallest power-of-two nprobe whose measured recall@k against the
    exact scan reaches `target_recall`, on a strided row sample as queries.
    Probe sets nest as nprobe grows, so recall is monotone and a doubling
    walk suffices. The exact oracle streams the gallery chunk by chunk
    (index/stream.py), so the flat gallery never sits next to the buckets.
    With `mesh` (a ShardedIVF), the oracle and the probes run on it.

    Returns {"nprobe", "recall", "target", "k", "curve": {nprobe: r}}."""
    from mmrs_tpu_torch.index.stream import streaming_topk

    n = embeddings.shape[0]
    sel = np.unique(np.linspace(0, n - 1, n_queries).astype(np.int64))
    q_host = np.asarray(embeddings[sel], np.float32)
    device = ivf.buckets.device if mesh is None else ivf.device
    q = l2_normalize(torch.from_numpy(q_host).to(device))
    k = min(k, n)
    _, exact = streaming_topk(embeddings, q_host, k=k, device=device,
                              impl=impl, mesh=mesh)

    def recall_at(nprobe: int) -> float:
        if mesh is not None:
            from mmrs_tpu_torch.parallel.ivf import sharded_ivf_topk

            _, got = sharded_ivf_topk(q, ivf, k=k, nprobe=nprobe, mesh=mesh,
                                      impl=impl)
        else:
            _, got = ivf_topk(q, ivf, k=k, nprobe=nprobe, impl=impl)
        got = got.cpu().numpy()
        return sum(len(set(exact[i]) & set(got[i]))
                   for i in range(got.shape[0])) / float(got.size)

    curve = {}
    nprobe = 1
    while True:
        nprobe = min(nprobe, ivf.n_clusters)
        curve[nprobe] = recall_at(nprobe)
        if curve[nprobe] >= target_recall or nprobe >= ivf.n_clusters:
            break
        nprobe *= 2
    log.info("tune_nprobe: target %.3f -> nprobe=%d (recall %.4f; curve %s)",
             target_recall, nprobe, curve[nprobe],
             {p: round(r, 4) for p, r in curve.items()})
    return {"nprobe": nprobe, "recall": curve[nprobe],
            "target": target_recall, "k": k,
            "curve": {int(p): float(r) for p, r in curve.items()}}


def ivf_recall(ivf: IVFIndex, embeddings, queries, k: int = 10,
               nprobe: int = 0, impl: str = "auto") -> float:
    """Measured recall@k against the exact scan for a query sample (the
    report for choosing nprobe)."""
    from mmrs_tpu_torch.ops.topk import cosine_topk

    device = ivf.buckets.device
    q = l2_normalize(torch.as_tensor(np.asarray(queries, np.float32)
                                     ).to(device))
    g = l2_normalize(torch.as_tensor(np.asarray(embeddings, np.float32)
                                     ).to(device))
    oracle = torch.bfloat16 if ivf.quantized else ivf.buckets.dtype
    _, exact = cosine_topk(q.to(oracle), g.to(oracle), k, impl=impl)
    _, got = ivf_topk(q, ivf, k=k, nprobe=nprobe, impl=impl)
    exact, got = exact.cpu().numpy(), got.cpu().numpy()
    hits = sum(len(set(exact[i]) & set(got[i])) for i in range(exact.shape[0]))
    return hits / float(exact.shape[0] * exact.shape[1])


# -- persistence ----------------------------------------------------------------


def gallery_fingerprint(embeddings) -> str:
    """Cheap content identity of a gallery: shape + md5 over ~64 strided
    rows (memmap-friendly). Guards a sidecar against a gallery that changed
    at unchanged shape."""
    n, d = embeddings.shape
    h = hashlib.md5(f"{n}x{d}".encode())
    # n == 0: shape-only hash (linspace(0, -1) would index row -1)
    for i in (np.unique(np.linspace(0, n - 1, 64).astype(np.int64))
              if n else ()):
        h.update(np.ascontiguousarray(
            np.asarray(embeddings[int(i)], np.float32)).tobytes())
    return h.hexdigest()


def sidecar_meta(directory: str) -> Optional[dict]:
    """The saved sidecar's meta dict, or None if no sidecar exists."""
    path = os.path.join(directory, "ivf.json")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _write_meta(directory: str, meta: dict) -> None:
    tmp = os.path.join(directory, "ivf.json.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(directory, "ivf.json"))


def _write_maps(directory: str, centroids: np.ndarray, bucket_ids,
                spill_ids) -> None:
    tmp = os.path.join(directory, "ivf.npz.tmp.npz")
    np.savez(tmp, centroids=centroids, bucket_ids=bucket_ids,
             spill_ids=spill_ids)
    os.replace(tmp, os.path.join(directory, "ivf.npz"))


def update_sidecar_meta(directory: str, **extra) -> None:
    """Merge extra keys (e.g. the tuned-nprobe record) into ivf.json
    atomically."""
    meta = sidecar_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no ivf sidecar in {directory}")
    meta.update(extra)
    _write_meta(directory, meta)


def save_ivf(directory: str, ivf: IVFIndex, embeddings=None) -> None:
    """Sidecar next to a gallery: centroids and slot maps only (the bucket
    rows are rebuilt from the gallery on load). The centroids are stored
    as f32 padded with zero columns to a multiple of 128, as the JAX
    package stores its lane-padded ones. Pass the gallery `embeddings` to
    stamp a content fingerprint that `load_ivf` verifies."""
    os.makedirs(directory, exist_ok=True)
    c, d = ivf.centroids.shape
    cents = np.zeros((c, _round_up(d, 128)), np.float32)
    cents[:, :d] = ivf.centroids.float().cpu().numpy()
    _write_maps(directory, cents, ivf.bucket_ids.cpu().numpy(),
                ivf.spill_ids.cpu().numpy())
    meta = {"n_total": ivf.n_total, "dim": ivf.dim,
            "n_clusters": ivf.n_clusters, "bucket_cap": ivf.bucket_cap,
            "quantized": ivf.quantized, "quant": ivf.quant}
    if embeddings is not None:
        meta["fingerprint"] = gallery_fingerprint(embeddings)
    _write_meta(directory, meta)


def _rewrite_sidecar(directory: str, meta: dict, z, bucket_ids,
                     spill: np.ndarray, n_total: int, embeddings) -> dict:
    """Store changed slot maps (spill padded to a multiple of 8, never
    empty) with a fresh fingerprint; drop the tuned nprobe (recall
    drifted; re-measured on demand)."""
    s_pad = max(8, _round_up(spill.size, 8))
    spill_arr = np.full(s_pad, -1, np.int32)
    spill_arr[:spill.size] = spill
    _write_maps(directory, z["centroids"], bucket_ids, spill_arr)
    new_meta = dict(meta)
    new_meta["n_total"] = n_total
    new_meta["fingerprint"] = gallery_fingerprint(embeddings)
    new_meta.pop("tuned", None)
    _write_meta(directory, new_meta)
    return new_meta


def _assign_rows(rows: np.ndarray, cents: torch.Tensor) -> np.ndarray:
    return _assign_chunk(torch.from_numpy(rows).to(cents.device),
                         cents).cpu().numpy()


def extend_sidecar(directory: str, embeddings, chunk: int = _STREAM_CHUNK,
                   device=None) -> dict:
    """Extend a saved sidecar to rows APPENDED to the gallery since it was
    saved (`index update`): assign only the new rows with the saved
    centroids, put each into its cluster's next free slot (overflow
    appends to the spill, scanned exactly), and rewrite the sidecar. The
    k-means and the old rows' assignment never re-run. Returns the new
    meta."""
    meta = sidecar_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no ivf sidecar in {directory}")
    n_old, d = meta["n_total"], meta["dim"]
    n = embeddings.shape[0]
    if embeddings.shape[1] != d:
        raise ValueError(f"dim {embeddings.shape[1]} != sidecar {d}")
    if n < n_old:
        raise ValueError(
            f"gallery shrank ({n} < {n_old}): extend only handles "
            "appends — rebuild with build_ivf")
    if meta.get("fingerprint"):
        got = gallery_fingerprint(embeddings[:n_old])
        if got != meta["fingerprint"]:
            raise ValueError(
                "sidecar fingerprint mismatch on the OLD prefix — the "
                "existing rows changed, not just appended; rebuild")
    z = np.load(os.path.join(directory, "ivf.npz"))
    # the stored centroids are zero-padded unit rows: slicing back to the
    # true dim keeps every assignment score
    cents = torch.from_numpy(np.ascontiguousarray(
        z["centroids"][:, :d], np.float32)).to(_default_device(device))
    bucket_ids = np.array(z["bucket_ids"])            # [C, cap]
    spill_ids = list(z["spill_ids"][z["spill_ids"] >= 0])
    cap = bucket_ids.shape[1]

    parts = [_assign_rows(np.asarray(embeddings[a:min(a + chunk, n)],
                                     np.float32), cents)
             for a in range(n_old, n, chunk)]
    assign_new = np.concatenate(parts) if parts else np.zeros(0, np.int64)

    free = (bucket_ids >= 0).sum(axis=1).astype(np.int64)   # ids fill front
    for j, cl in enumerate(assign_new):
        row = n_old + j
        if free[cl] < cap:
            bucket_ids[cl, free[cl]] = row
            free[cl] += 1
        else:
            spill_ids.append(row)
    new_meta = _rewrite_sidecar(directory, meta, z, bucket_ids,
                                np.asarray(spill_ids, np.int32), n,
                                embeddings)
    log.info("ivf sidecar extended: %d -> %d rows (%d new; spill now %d)",
             n_old, n, n - n_old, len(spill_ids))
    return new_meta


def shrink_sidecar(directory: str, kept_mask, embeddings,
                   chunk: int = _STREAM_CHUNK, device=None) -> dict:
    """Shrink a saved sidecar after rows were DELETED from the gallery
    (`index compact`). `kept_mask` is a bool array over the pre-compaction
    rows; `embeddings` is the post-compaction gallery (the kept rows, in
    order). Ids renumber in place, each bucket re-front-fills, then former
    spill rows move into the freed slots using the saved centroids. The
    k-means never re-runs. Returns the new meta."""
    meta = sidecar_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no ivf sidecar in {directory}")
    kept = np.asarray(kept_mask, bool)
    if kept.shape[0] != meta["n_total"]:
        raise ValueError(f"mask covers {kept.shape[0]} rows, sidecar "
                         f"has {meta['n_total']}")
    n_new, d = int(kept.sum()), meta["dim"]
    if n_new == 0:
        # ValueError keeps compact_index on its warn-and-retrain path
        raise ValueError("compaction kept 0 rows — nothing to shrink; "
                         "rebuild the sidecar when rows return")
    if embeddings.shape[0] != n_new or embeddings.shape[1] != d:
        raise ValueError(
            f"post-compaction gallery is {embeddings.shape}, mask keeps "
            f"{n_new}x{d} — pass the compacted gallery and its mask")
    z = np.load(os.path.join(directory, "ivf.npz"))
    # old row id -> new row id (-1 for dropped); the gather also runs on
    # the -1 pad ids (wrapping to the last element), which `where` drops
    new_of = np.where(kept, np.cumsum(kept) - 1, -1).astype(np.int32)
    old_ids = np.array(z["bucket_ids"])               # [C, cap]
    cap = old_ids.shape[1]
    bucket_ids = np.where(old_ids >= 0, new_of[old_ids], -1)
    # re-front-fill every bucket: the probe mask and extend_sidecar's
    # free-slot counter assume each bucket's live slots come first
    order = np.argsort(bucket_ids < 0, axis=1, kind="stable")
    bucket_ids = np.take_along_axis(bucket_ids, order, axis=1)
    sp = z["spill_ids"]
    spill = np.where(sp >= 0, new_of[sp], -1)
    spill = spill[spill >= 0]
    if spill.size:
        # every query scans the spill: moving rows out of it is the
        # latency gain of a delete
        cents = torch.from_numpy(np.ascontiguousarray(
            z["centroids"][:, :d], np.float32)).to(_default_device(device))
        free = (bucket_ids >= 0).sum(axis=1).astype(np.int64)
        still_spilled = []
        for a in range(0, spill.size, chunk):
            ids = spill[a:a + chunk]
            assign = _assign_rows(np.asarray(embeddings[ids], np.float32),
                                  cents)
            for rid, cl in zip(ids, assign):
                if free[cl] < cap:
                    bucket_ids[cl, free[cl]] = rid
                    free[cl] += 1
                else:
                    still_spilled.append(int(rid))
        spill = np.asarray(still_spilled, np.int32)
    new_meta = _rewrite_sidecar(directory, meta, z, bucket_ids, spill, n_new,
                                embeddings)
    log.info("ivf sidecar shrunk: %d -> %d rows (spill now %d)",
             kept.shape[0], n_new, spill.size)
    return new_meta


def load_ivf(directory: str, embeddings=None,
             dtype: torch.dtype = torch.bfloat16, chunk: int = _STREAM_CHUNK,
             make_chunks=None, n: int = 0, d: int = 0, device=None,
             mesh=None) -> IVFIndex:
    """Rebuild the device structure from a sidecar and the gallery rows
    (one streamed fill pass; no training, no assignment). Rows come from
    `embeddings` (host array-like, fingerprint-verified) or from a
    `make_chunks` chunk source with explicit n and d (the caller vouches
    that the stream matches the sidecar). A sidecar written by either
    package loads here. With `mesh`, the slot maps are padded with dead
    slots to multiples of the shard count and the rows stream straight
    into each shard's strips: a ShardedIVF (parallel/ivf.py)."""
    meta = sidecar_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no ivf sidecar in {directory}")
    z = np.load(os.path.join(directory, "ivf.npz"))
    if embeddings is not None:
        n, d = embeddings.shape
    elif make_chunks is None or n <= 0 or d <= 0:
        raise ValueError("need embeddings, or make_chunks with n and d")
    if n != meta["n_total"] or d != meta["dim"]:
        raise ValueError(
            f"ivf sidecar built for {meta['n_total']}x{meta['dim']}, "
            f"gallery is {n}x{d} — rebuild with build_ivf")
    if embeddings is not None and meta.get("fingerprint"):
        if gallery_fingerprint(embeddings) != meta["fingerprint"]:
            raise ValueError(
                "ivf sidecar fingerprint mismatch: the gallery content "
                "changed since the sidecar was saved (same shape, "
                "different rows) — rebuild with build_ivf")
    device = _default_device(device)
    bucket_ids = np.asarray(z["bucket_ids"], np.int32)
    spill_ids = np.asarray(z["spill_ids"], np.int32)
    quant = meta.get("quant", "int8" if meta.get("quantized") else "")
    if mesh is not None:
        from mmrs_tpu_torch.parallel.ivf import fill_strips
        from mmrs_tpu_torch.parallel.mesh import DATA_AXIS

        shards = mesh.shape[DATA_AXIS]
        cap = bucket_ids.shape[1]
        bucket_ids = np.pad(bucket_ids, ((0, 0), (0, -cap % shards)),
                            constant_values=-1)
        spill_ids = np.pad(spill_ids, (0, -spill_ids.shape[0] % shards),
                           constant_values=-1)
    def row_chunks():
        if make_chunks is not None:
            for ci, rows in enumerate(make_chunks()):
                yield ci * chunk, torch.as_tensor(rows)
            return
        for a in range(0, n, chunk):
            yield a, torch.from_numpy(np.array(embeddings[a:a + chunk],
                                               np.float32))

    cents = torch.from_numpy(np.ascontiguousarray(z["centroids"][:, :d],
                                                  np.float32))
    if mesh is not None:
        return fill_strips(row_chunks(), n, d, cents.to(dtype), bucket_ids,
                           spill_ids, quant, dtype, mesh)
    c, cap = bucket_ids.shape
    bpos = np.full(n, -1, np.int32)
    flat = bucket_ids.reshape(-1)
    live = flat >= 0
    bpos[flat[live]] = np.arange(c * cap, dtype=np.int32)[live]
    spos = np.full(n, -1, np.int32)
    slive = spill_ids >= 0
    spos[spill_ids[slive]] = np.arange(spill_ids.shape[0],
                                       dtype=np.int32)[slive]
    arrays = _alloc(c, cap, spill_ids.shape[0], d, quant, dtype, device)
    for a, rows in row_chunks():
        b = min(a + chunk, n)
        _fill_chunk(arrays, rows[:b - a], bpos[a:b], spos[a:b], quant)
    buckets, bscales, spill, sscales = arrays
    return IVFIndex(
        centroids=cents.to(device).to(dtype),
        buckets=buckets,
        bucket_ids=torch.from_numpy(bucket_ids).to(device),
        spill=spill,
        spill_ids=torch.from_numpy(spill_ids).to(device),
        n_total=n,
        dim=d,
        bucket_scales=bscales,
        spill_scales=sscales,
    )
