"""Query engine: text / image / k-shot-prototype search over a gallery.

Counterpart of mmrs_tpu/search/engine.py for the flat gallery on one
device (code/search_image.py:320-390), with its residency ladder: bf16
rows (the rank-parity default), int8 rows + per-row scales (half the
device memory) or packed int4 rows + scales (a quarter). Every query goes
through the gallery's fused top-k scan (ops/topk.py, ops/quant.py,
ops/quant4.py: CUDA kernels on a GPU). Scores follow the reference's
`100. * feat @ ref.T` convention (code/search_image.py:105-117) via the
configured logit scale. With `config.ann == "ivf"` the gallery is an IVF
index instead (index/ivf.py: the bucket probe kernels K7 / K8 on a GPU),
for every rung of the ladder, with its sidecar cached under
`<index>/ivf`. With a `mesh` (parallel/mesh.py) every rung and the IVF
index are split over its data axis: gallery rows (parallel/topk.py,
parallel/quant4.py) or IVF slot strips (parallel/ivf.py), each shard
scanned on its device and the candidates merged; a ragged row count is
padded to the shard multiple and masked at query time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from mmrs_tpu_torch.config import SearchConfig
from mmrs_tpu_torch.index.gallery import GalleryIndex
from mmrs_tpu_torch.ops.normalize import l2_normalize
from mmrs_tpu_torch.ops.quant import (cosine_topk_quantized, quantize_rows,
                                      scores_q8)
from mmrs_tpu_torch.ops.quant4 import (cosine_topk_int4, quantize_rows_int4,
                                       similarities_int4)
from mmrs_tpu_torch.ops import topk
from mmrs_tpu_torch.ops.topk import cosine_topk
from mmrs_tpu_torch.pipeline import default_device
from mmrs_tpu_torch.search.prototypes import build_prototype
from mmrs_tpu_torch.utils.logging import get_logger
from mmrs_tpu_torch.utils.stats import StageStats

log = get_logger(__name__)

UPLOAD_CHUNK = 131072  # host->device staging rows (bounds host RSS)


@dataclass
class SearchHit:
    path: str
    score: float
    rank: int
    cls: str


def _row_align(mode: str, device: torch.device) -> int:
    """The gallery row width the card's flat scan takes: K1 rows a
    multiple of 8 values, K4 codes of 16 (ops/topk.ROW_ALIGN); the CPU and
    K5 (whose packing needs D % 8, as the JAX package's) take D as it is."""
    if device.type != "cuda" or mode == "int4":
        return 1
    return topk.ROW_ALIGN["int8" if mode else "bf16"]


def _to_device_chunked(embeddings, dtype: torch.dtype, device: torch.device,
                       chunk: int = UPLOAD_CHUNK, align: int = 1
                       ) -> torch.Tensor:
    """Upload a (possibly memmapped) [N, D] host array chunk by chunk, cast
    to `dtype` and L2-normalize each chunk on the device (normalization is
    per row, so this equals normalizing the whole `dtype` gallery). Rows
    are zero-padded to a multiple of `align` values, once, here."""
    n, d = embeddings.shape
    out = torch.zeros((n, d + -d % align), dtype=dtype, device=device)
    for a in range(0, n, chunk):
        rows = torch.from_numpy(np.array(embeddings[a:a + chunk]))
        out[a:a + chunk, :d] = l2_normalize(rows.to(device).to(dtype))
    return out


def _quantize_gallery_chunked(embeddings, mode: str, device: torch.device,
                              chunk: int = UPLOAD_CHUNK, align: int = 1):
    """Upload, L2-normalize and quantize chunk by chunk, so the peak device
    memory while the engine is built is the packed gallery plus one chunk
    (the full bf16 gallery is never resident). Each chunk takes the JAX
    package's chain: rows cast to bf16, L2-normalized in bf16, then
    quantized from f32, so codes and scales are bit-identical to it. int8
    codes are zero-padded to a multiple of `align`, once, here (a zero
    code changes no score and no scale)."""
    n, d = embeddings.shape
    if mode == "int4":
        gal = torch.empty((n, d // 2), dtype=torch.uint8, device=device)
        quantize = quantize_rows_int4
    else:
        gal = torch.zeros((n, d + -d % align), dtype=torch.int8,
                          device=device)
        quantize = quantize_rows
    scales = torch.empty((n,), dtype=torch.float32, device=device)
    for a in range(0, n, chunk):
        rows = torch.from_numpy(np.array(embeddings[a:a + chunk]))
        rows = l2_normalize(rows.to(device).to(torch.bfloat16))
        codes, scales[a:a + chunk] = quantize(rows)
        gal[a:a + chunk, :codes.shape[1]] = codes
    return gal, scales


def _place_on_mesh(embeddings, mode: str, dtype: torch.dtype, mesh):
    """The gallery split over the mesh's data axis: each local position's
    ceil(N / S) rows uploaded straight to its device by the single-device
    chunked functions (the same per-row numerics), the last shards' tails
    padded: zero rows (bf16), zero codes and scales (int8), or the codes of
    zero FLOAT rows (int4: a zero byte would decode to -8), all of which
    score exactly 0.0. Returns (row blocks, scale blocks or None), None
    where another process owns the position."""
    from mmrs_tpu_torch.parallel.mesh import data_devices, local_positions

    n, d = embeddings.shape
    s = mesh.shape["data"]
    per = -(-n // s)
    devs = data_devices(mesh)
    rows, scales = [None] * s, [None] * s
    for p in local_positions(mesh):
        dev = devs[p]
        lo, hi = min(n, p * per), min(n, (p + 1) * per)
        pad = per - (hi - lo)
        align = _row_align(mode, dev)
        if not mode:
            g = _to_device_chunked(embeddings[lo:hi], dtype, dev,
                                   align=align)
            rows[p] = torch.cat([g, g.new_zeros((pad, g.shape[1]))])
            continue
        g, sc = _quantize_gallery_chunked(embeddings[lo:hi], mode, dev,
                                          align=align)
        if mode == "int4":
            pg, ps = quantize_rows_int4(torch.zeros((pad, d), device=dev))
        else:
            pg, ps = g.new_zeros((pad, g.shape[1])), sc.new_zeros((pad,))
        rows[p], scales[p] = torch.cat([g, pg]), torch.cat([sc, ps])
    return rows, (scales if mode else None)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


class SearchEngine:
    """Holds the gallery on the device and answers queries."""

    def __init__(
        self,
        index: GalleryIndex,
        config: Optional[SearchConfig] = None,
        mesh=None,
        quantize=False,
        device=None,
        device_dtype: torch.dtype = torch.bfloat16,
    ):
        """`quantize` selects the gallery residency ladder ("", "int8",
        "int4"); `device_dtype` is the flat unquantized gallery's dtype
        (bf16, the serving default; f32 for calibration at full
        precision, as the JAX lifecycle's). An out-of-memory error while
        the gallery is placed is raised again as a RuntimeError that
        points at `mmrs-torch plan` (plan.py), which predicts every rung's
        residency before building."""
        try:
            self._init(index, config, mesh, quantize, device, device_dtype)
        except Exception as e:
            msg = str(e)
            if (isinstance(e, torch.OutOfMemoryError)
                    or "out of memory" in msg.lower()):
                from mmrs_tpu_torch.plan import oom_hint

                dim = index.embeddings.shape[1] if len(index) else 0
                raise RuntimeError(
                    f"{oom_hint(len(index), dim)} (device error: "
                    f"{msg[:300]})") from e
            raise

    def _init(self, index, config, mesh, quantize, device, device_dtype):
        self.index = index
        self.config = config or SearchConfig()
        self.stats = StageStats()
        self.mesh = mesh
        if quantize is True:
            quantize = "int8"
        elif quantize in (False, None):
            quantize = ""
        if quantize not in ("", "int8", "int4"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.quantized = quantize
        if mesh is not None:   # queries start and answers end there
            from mmrs_tpu_torch.parallel.mesh import first_device

            self.device = first_device(mesh)
        else:
            self.device = (torch.device(device) if device is not None
                           else default_device())
        self.gallery = self.gallery_scales = self.ivf = None
        if self.config.ann == "ivf":
            self._init_ivf()
        elif self.config.ann not in ("none", "", None):
            raise ValueError(f"unknown ann mode {self.config.ann!r}")
        elif mesh is not None:
            self.gallery, self.gallery_scales = _place_on_mesh(
                index.embeddings, quantize, device_dtype, mesh)
        elif quantize:
            self.gallery, self.gallery_scales = _quantize_gallery_chunked(
                index.embeddings, quantize, self.device,
                align=_row_align(quantize, self.device))
        else:
            self.gallery = _to_device_chunked(
                index.embeddings, device_dtype, self.device,
                align=_row_align("", self.device))

    def _blocks(self):
        """(row blocks, scale blocks) of the local shards, one pair without
        a mesh."""
        if self.mesh is None:
            return [self.gallery], [self.gallery_scales]
        from mmrs_tpu_torch.parallel.mesh import local_positions

        pos = local_positions(self.mesh)
        return ([self.gallery[p] for p in pos],
                [None if self.gallery_scales is None
                 else self.gallery_scales[p] for p in pos])

    def _fit(self, q: torch.Tensor) -> torch.Tensor:
        """Queries [Q, D] zero-padded to the placed gallery's row width."""
        pad = self._blocks()[0][0].shape[1] - q.shape[1]
        if self.quantized == "int4" or pad <= 0:
            return q
        return torch.nn.functional.pad(q, (0, pad))

    def _init_ivf(self) -> None:
        """The IVF gallery: the flat gallery is never on the device. The
        trained sidecar (centroids + slot maps, ~4 B/row) is cached under
        <index>/ivf: a compatible one is extended over appended rows and
        loaded (no k-means, no assignment pass); otherwise the index is
        built and the sidecar saved. A fingerprint of the gallery rows, the
        quantize mode and the cluster / capacity knobs decide
        compatibility. `ann_target_recall` measures an nprobe and keeps it
        in the sidecar."""
        import dataclasses
        import os

        from mmrs_tpu_torch.index import ivf as ivf_mod

        index, cfg = self.index, self.config
        if cfg.ann_target_recall > 0 and cfg.ann_nprobe > 0:
            raise ValueError("set ann_nprobe or ann_target_recall, not both")
        sidecar = meta = None
        loaded = False
        if getattr(index, "directory", None):
            sidecar = os.path.join(index.directory, "ivf")
            meta = ivf_mod.sidecar_meta(sidecar)
            compatible = meta is not None and (
                meta.get("quant", "") == self.quantized
                and cfg.ann_clusters in (0, meta.get("n_clusters"))
                and cfg.ann_bucket_cap in (0, meta.get("bucket_cap"))
                # the auto cap derives from cover and slots_frac; an
                # explicit cap overrides them
                and (cfg.ann_bucket_cap != 0
                     or (meta.get("cover", 0.98) == cfg.ann_cover
                         and meta.get("slots_frac", 1.3)
                         == cfg.ann_slots_frac)))
            if compatible and meta["n_total"] < len(index):
                # the gallery grew (index update): assign only the new rows
                try:
                    meta = ivf_mod.extend_sidecar(sidecar, index.embeddings,
                                                  device=self.device)
                except (ValueError, OSError) as e:
                    log.warning("ivf sidecar extend failed (%s); "
                                "rebuilding", e)
                    compatible = False
            if compatible:
                try:
                    self.ivf = ivf_mod.load_ivf(sidecar, index.embeddings,
                                                device=self.device,
                                                mesh=self.mesh)
                    loaded = True
                except ValueError as e:
                    log.warning("ivf sidecar rejected (%s); rebuilding", e)
        if self.ivf is None:
            self.ivf = ivf_mod.build_ivf(
                index.embeddings, n_clusters=cfg.ann_clusters,
                bucket_cap=cfg.ann_bucket_cap, iters=cfg.ann_train_iters,
                quantize=self.quantized, cover=cfg.ann_cover,
                slots_frac=cfg.ann_slots_frac, device=self.device,
                mesh=self.mesh)
            if sidecar is not None:
                try:
                    ivf_mod.save_ivf(sidecar, self.ivf,
                                     embeddings=index.embeddings)
                    ivf_mod.update_sidecar_meta(
                        sidecar, cover=cfg.ann_cover,
                        slots_frac=cfg.ann_slots_frac)
                    meta = ivf_mod.sidecar_meta(sidecar)
                except OSError as e:  # read-only index dirs are fine
                    log.warning("ivf sidecar not saved: %s", e)
                    sidecar = None
        if cfg.ann_target_recall > 0:
            # reuse a persisted tuning only when the index came from that
            # sidecar and the target and k match; else measure and persist
            tuned = (meta or {}).get("tuned")
            if not (loaded and tuned
                    and tuned.get("target") == cfg.ann_target_recall
                    and tuned.get("k") == cfg.top_k):
                tuned = ivf_mod.tune_nprobe(
                    self.ivf, index.embeddings,
                    target_recall=cfg.ann_target_recall, k=cfg.top_k,
                    mesh=self.mesh)
                if sidecar is not None:
                    try:
                        ivf_mod.update_sidecar_meta(sidecar, tuned=tuned)
                    except OSError as e:
                        log.warning("tuned nprobe not saved: %s", e)
            self.config = dataclasses.replace(
                self.config, ann_nprobe=int(tuned["nprobe"]))
            log.info("ann_target_recall %.3f -> nprobe %d (measured recall "
                     "%.4f)", cfg.ann_target_recall, tuned["nprobe"],
                     tuned["recall"])

    # -- core ---------------------------------------------------------------

    def query_vectors(self, vectors, top_k: Optional[int] = None
                      ) -> List[List[SearchHit]]:
        """vectors [Q, D] (unnormalized ok). Returns hits per query."""
        k = min(top_k or self.config.top_k, len(self.index))
        q = l2_normalize(_as_tensor(vectors, self.device))
        with self.stats.timed("topk", count=q.shape[0]):
            if self.ivf is not None and self.mesh is not None:
                from mmrs_tpu_torch.parallel.ivf import sharded_ivf_topk

                vals, idxs = sharded_ivf_topk(
                    q, self.ivf, k=k, nprobe=self.config.ann_nprobe,
                    mesh=self.mesh)
            elif self.ivf is not None:
                from mmrs_tpu_torch.index.ivf import ivf_topk

                vals, idxs = ivf_topk(q, self.ivf, k=k,
                                      nprobe=self.config.ann_nprobe)
            elif self.mesh is not None:
                vals, idxs = self._sharded_topk(q, k)
            elif self.quantized == "int4":
                vals, idxs = cosine_topk_int4(q, self.gallery,
                                              self.gallery_scales, k)
            elif self.quantized:
                vals, idxs = cosine_topk_quantized(self._fit(q), self.gallery,
                                                   self.gallery_scales, k)
            else:
                vals, idxs = cosine_topk(self._fit(q).to(self.gallery.dtype),
                                         self.gallery, k)
            vals = vals.cpu().numpy()
            idxs = idxs.cpu().numpy()
        scale = self.config.logit_scale
        out: List[List[SearchHit]] = []
        for qi in range(vals.shape[0]):
            hits: List[SearchHit] = []
            for j in range(idxs.shape[1]):
                r = int(idxs[qi, j])
                if r < 0:
                    continue    # sentinel: k exceeded the gallery rows
                hits.append(SearchHit(
                    path=self.index.paths[r],
                    score=float(vals[qi, j] * scale),
                    rank=len(hits),
                    cls=self.index.classes[r],
                ))
            out.append(hits)
        return out

    def _sharded_topk(self, q: torch.Tensor, k: int):
        """The flat rungs over the mesh's row blocks (K1 / K4 / K5 a
        shard), masked past the index's rows."""
        from mmrs_tpu_torch.parallel.quant4 import sharded_cosine_topk_int4
        from mmrs_tpu_torch.parallel.topk import (
            sharded_cosine_topk, sharded_cosine_topk_quantized)

        n = len(self.index)
        if self.quantized == "int4":
            return sharded_cosine_topk_int4(q, self.gallery,
                                            self.gallery_scales, k,
                                            self.mesh, n_valid=n)
        if self.quantized:
            return sharded_cosine_topk_quantized(
                self._fit(q), self.gallery, self.gallery_scales, k,
                self.mesh, n_valid=n)
        dtype = self._blocks()[0][0].dtype
        return sharded_cosine_topk(self._fit(q).to(dtype), self.gallery, k,
                                   self.mesh, n_valid=n)

    # -- query flavors (the reference's entry points) -------------------------

    def query_text(self, text_embeds, top_k=None):
        """Text->image search: embeds from the matching text tower."""
        return self.query_vectors(text_embeds, top_k)

    def query_image(self, image_embeds, top_k=None):
        """Reference-image->image search."""
        return self.query_vectors(image_embeds, top_k)

    def query_prototype(self, shot_embeds, strategy: Optional[str] = None,
                        text_embed=None, top_k=None):
        """K-shot prototype search with the reference's strategies."""
        cfg = self.config
        proto = build_prototype(_as_tensor(shot_embeds, self.device),
                                strategy=strategy or cfg.prototype,
                                text_embed=text_embed,
                                cluster_k=cfg.cluster_k,
                                balance_ratio=cfg.cluster_balance_ratio,
                                outlier_percentile=cfg.outlier_percentile)
        return self.query_vectors(proto[None, :], top_k)

    def device_similarities(self, vectors) -> torch.Tensor:
        """UNscaled cosine rows [Q, N] f32 against the device gallery,
        computed chunk by chunk so that no f32 (or unpacked) copy of the
        whole gallery is made: bf16 operands with f32 sums, or the int8 /
        int4 scores of the quantized top-k scans."""
        if self.ivf is not None:
            raise RuntimeError(
                "device_similarities needs the flat gallery; calibrate "
                "with ann='none' (calibration is an offline build step)")
        q = self._fit(l2_normalize(_as_tensor(vectors, self.device)))
        blocks, scales = self._blocks()
        if not self.quantized:
            q = q.to(blocks[0].dtype).float()
        strips = [self._similarity_strip(q, g, s)
                  for g, s in zip(blocks, scales)]
        if self.mesh is None:
            return strips[0]
        from mmrs_tpu_torch.parallel.topk import gather_columns

        return gather_columns(strips, self.mesh)[:, :len(self.index)]

    def _similarity_strip(self, q: torch.Tensor, gallery: torch.Tensor,
                          scales) -> torch.Tensor:
        """[Q, rows] f32 scores of one row block on its device, chunk by
        chunk."""
        q = q.to(gallery.device)
        if self.quantized == "int8":
            q_q, q_scale = quantize_rows(q)
        n = gallery.shape[0]
        sims = torch.empty((q.shape[0], n), dtype=torch.float32,
                           device=gallery.device)
        for a in range(0, n, UPLOAD_CHUNK):
            rows = gallery[a:a + UPLOAD_CHUNK]
            if self.quantized == "int4":
                part = similarities_int4(q, rows,
                                         scales[a:a + UPLOAD_CHUNK])
            elif self.quantized:
                part = scores_q8(q_q, q_scale, rows,
                                 scales[a:a + UPLOAD_CHUNK])
            else:
                part = q @ rows.float().T
            sims[:, a:a + UPLOAD_CHUNK] = part
        return sims

    def sweep_class(self, vector, positives: np.ndarray,
                    thresholds: Optional[np.ndarray] = None,
                    calib_config=None):
        """Threshold calibration against the whole gallery on the device:
        the [N] sims and the (tp, fp, fn) reductions stay there, only the
        [T] counts come back. Thresholds apply to SCALED sims
        (config.logit_scale), as the reference's threshold tables."""
        from mmrs_tpu_torch.config import CalibrationConfig
        from mmrs_tpu_torch.search.calibrate import (_sweep_counts,
                                                     grid_thresholds,
                                                     result_from_counts)

        cfg = calib_config or CalibrationConfig()
        vec = _as_tensor(vector, self.device)
        sims = self.device_similarities(vec[None, :])[0]
        sims = sims * self.config.logit_scale
        pos = torch.from_numpy(np.asarray(positives, bool)).to(self.device)
        if thresholds is None:
            thresholds = grid_thresholds(cfg, float(sims.min()),
                                         float(sims.max()),
                                         scale=self.config.logit_scale)
        thr = torch.from_numpy(np.asarray(thresholds, np.float32)).to(
            self.device)
        tp, fp, fn = _sweep_counts(sims, pos, thr)
        return result_from_counts(thresholds, tp, fp, fn)
