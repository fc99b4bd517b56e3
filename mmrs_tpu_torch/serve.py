"""HTTP serving layer: the query engine behind a JSON API.

Counterpart of mmrs_tpu/serve.py (stdlib HTTP, no server
dependency):

  GET  /healthz          -> {"ok": true, "rows": N, "dim": D,
                            "gallery_shards": S, "gallery_int8": bool,
                            "gallery_quant": "bf16"|"int8"|"int4",
                            "ann": {...}?, "verifier": {kind, draft?}}:
                            liveness plus the deployment shape in one call
                            (a meshed verifier adds "tp", and "dp" when
                            its data axis is wider than 1)
  GET  /v1/stats         -> per-stage serving counters (StageStats: total
                            seconds, item counts, calls, items/call —
                            batch utilization — items/s, p50/p99; stage
                            "queue_wait": each query's wait in the device
                            batcher's queue, submit to dispatch), plus
                            "speculative" realized acceptance when the
                            verifier decodes with a draft model, and
                            "verifier": {tp, dp?} when it runs on a mesh
  POST /v1/search        -> {"hits": [[{path, score, rank, cls}, ...], ...]}
        body: {"text": "a photo of lychee", "k": 10}
           or {"image_b64": "<base64 jpeg/png>", "k": 10}
           or {"texts": [...]} / {"images_b64": [...]} for batched queries
  POST /v1/verify        -> {"results": [{gate_score, gate_passed,
                                          verified}, ...]}
        body: {"image_b64": ... | "images_b64": [...],
               "category": "lychee", "threshold": 27.63,
               "prompt": "a photo of {category}"?}
        The cascade's serving form (union_clip_llava2.py's gate->VLM flow
        as an endpoint): CLIP-score each image against the category
        prompt, threshold, and — when the service was built with a
        verifier — run the VLM yes/no on the gate survivors only.
        `verified` is null for images the gate rejected (never sent to
        the VLM) and for all images when no verifier is attached.

Concurrency model (micro-batched): ThreadingHTTPServer threads do HTTP
parse / JSON / base64 / JPEG decode concurrently, then hand device work to
two single-threaded MicroBatchers (microbatch.py):

  - the DEVICE worker coalesces concurrent text/image encodes + top-k
    scans into single batched dispatches (a gallery scan is bound by the
    gallery's bytes, so queries that arrive together ride one kernel
    launch: K1 / K4 / K5 or the IVF probes K7 / K8, behind the towers' K3,
    K2 and, for an int8 tower, K6);
  - the VLM worker packs gate survivors from ALL in-flight /v1/verify
    requests into fixed-size verify packs and pipelines them through
    verify_batch_async/collect (the LLaVA verifier's K10 / K11), so
    search requests never wait on a host thread holding a lock through a
    multi-hundred-ms 7B decode.

Each worker runs its torch work under `torch.inference_mode()` on its own
thread (the mode is thread-local; the towers' and the verifier's entry
points set it too). CUDA work from the two threads shares the default
stream and so runs in order on the card; host-side the search worker
keeps serving while the VLM worker waits in `collect`. Result fetches
stay serialized across the two workers by one fetch lock unless
`serialize_fetch=False` (`--concurrent-fetch`).

Start via `mmrs-torch serve --index DIR --port 8080 [--merges bpe.txt]`.
"""

from __future__ import annotations

import base64
import binascii
import inspect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from mmrs_tpu_torch.microbatch import MicroBatcher
from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger("serve")


class SearchService:
    """Engine + towers behind micro-batched text / image / verify methods.

    `verifier` (optional) is any cascade Verifier (cascade/verifier.py) —
    an LLaVAVerifier, an HTTP-backed CallableVerifier, or a stub; it
    powers /v1/verify's VLM stage. `verify_batch` is the FIXED batch for
    batched verifiers: survivors go to the VLM in packs of this size
    (padded), so the 7B decodes one batch shape whatever the survivor
    count. `logit_scale` is the gate
    score multiplier (the reference's 100·cosine; keep it equal to
    config.search.logit_scale so CLI and HTTP thresholds agree).

    `batch_window` is the micro-batcher linger (seconds) — how long the
    device worker waits for concurrent requests to join a batch.
    `verify_pipeline_depth` caps in-flight async verify packs."""

    def __init__(self, engine, towers, image_size: int = 224, verifier=None,
                 verify_batch: int = 8, logit_scale: float = 100.0,
                 max_batch: int = 64, batch_window: float = 0.002,
                 verify_pipeline_depth: int = 2,
                 serialize_fetch: bool = True,
                 engine_factory=None, watch_interval: float = 0.0):
        self.engine = engine
        self.towers = towers
        # hot-reload: with an engine_factory the service
        # watches the index manifest's content fingerprint (at most every
        # watch_interval seconds, checked on the device worker thread
        # between micro-batches) and swaps in a freshly-built engine when
        # `mmrs index update`/`compact` rewrote it — replacing the
        # reference's rebuild-the-pickle-and-restart workflow
        # (code/search_image.py:142-165). The swap is a plain attribute
        # assignment on the only thread that queries the engine, so no
        # request ever sees a half-built engine; the OLD gallery stays
        # device-resident until the new one is up (peak 2x residency —
        # serve IVF where the sidecar reload is cheap).
        self.engine_factory = engine_factory
        self.watch_interval = watch_interval
        self.reloads = 0
        self._last_watch = 0.0
        self._index_fp = self._current_index_fp()
        self.image_size = image_size
        self.verifier = verifier
        self.verify_batch = verify_batch
        self.logit_scale = logit_scale
        self.verify_pipeline_depth = verify_pipeline_depth
        # per-stage serving counters (GET /v1/stats); `calls` counts device
        # DISPATCHES, `count` items — items/call is the batching factor.
        from mmrs_tpu_torch.utils.stats import StageStats

        self.stats = StageStats()
        # ONE result fetch in flight at a time across both workers (see
        # module docstring); dispatches are not serialized. With
        # serialize_fetch=False the search worker fetches concurrently with
        # a VLM collect (device-level overlap decides latency, not a host
        # lock).
        import contextlib

        self._fetch_lock = (threading.Lock() if serialize_fetch
                            else contextlib.nullcontext())
        # the search batcher's queue wait (submit to dispatch) is stage
        # `queue_wait`
        self._device = MicroBatcher(self._device_handler, max_batch=max_batch,
                                    batch_window=batch_window,
                                    name="mmrs-device-batcher",
                                    stats=self.stats)
        self._vlm = MicroBatcher(self._vlm_handler, max_batch=max_batch,
                                 batch_window=batch_window,
                                 name="mmrs-vlm-batcher")

    def close(self) -> None:
        """Stop the worker threads (in-flight requests finish first)."""
        self._device.close()
        self._vlm.close()

    # -- index hot-reload ------------------------------------------------

    def _current_index_fp(self) -> Optional[str]:
        """Content hash of the live index's manifest (None when the
        engine has no backing directory — in-RAM indexes don't reload)."""
        d = getattr(getattr(self.engine, "index", None), "directory", None)
        if not d:
            return None
        import hashlib
        import os

        try:
            with open(os.path.join(d, "manifest.json"), "rb") as f:
                return hashlib.md5(f.read()).hexdigest()
        except OSError:
            return None

    def maybe_reload(self, force: bool = False) -> bool:
        """Swap in a freshly-built engine if the index manifest changed.

        Runs on the device worker thread between micro-batches (also
        callable directly, e.g. from tests or an ops hook). Returns True
        when a swap happened. A failed rebuild keeps the old engine
        serving and logs the error."""
        if self.engine_factory is None:
            return False
        import time

        now = time.monotonic()
        if not force and (now - self._last_watch) < self.watch_interval:
            return False
        self._last_watch = now
        fp = self._current_index_fp()
        if not force and (fp is None or fp == self._index_fp):
            return False
        try:
            new_engine = self.engine_factory()
        except Exception as e:  # noqa: BLE001 — keep serving the old index
            log.warning("index hot-reload failed (%s); keeping the "
                        "current engine", e)
            return False
        self.engine = new_engine
        self._index_fp = self._current_index_fp()
        self.reloads += 1
        log.info("index hot-reload: engine swapped (%d rows)",
                 len(new_engine.index))
        return True

    def verifier_mesh(self) -> Optional[dict]:
        """{"tp": model-axis width, "dp": data-axis width when above 1}
        of a verifier hosted on a mesh (parallel/vlm.py), else None."""
        from mmrs_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

        mesh = getattr(self.verifier, "mesh", None)
        if mesh is None:
            return None
        shape = mesh.shape
        v = {"tp": int(shape.get(MODEL_AXIS, mesh.devices.size))}
        if int(shape.get(DATA_AXIS, 1)) > 1:
            v["dp"] = int(shape[DATA_AXIS])
        return v

    def healthz(self) -> dict:
        """Liveness + deployment shape: gallery size/sharding/dtype and
        the verifier's hosting (tensor-parallel width, data-parallel
        width, draft) in one ops-facing call."""
        body = {"ok": True}
        if self.engine_factory is not None:
            body["index_reloads"] = self.reloads
            body["watch_interval"] = self.watch_interval
        if self.engine is not None:
            mesh = getattr(self.engine, "mesh", None)
            # rows shard over the DATA axis only: a 2-D engine mesh must
            # not report its model axis as shards
            shards = 1 if mesh is None else int(mesh.shape.get(
                "data", mesh.devices.size))
            quant = getattr(self.engine, "quantized", "") or ""
            if quant is True:   # pre-mode engines used a bool
                quant = "int8"
            body.update({
                "rows": len(self.engine.index),
                "dim": self.engine.index.dim,
                "gallery_shards": shards,
                "gallery_int8": quant == "int8",
                "gallery_quant": quant or "bf16",
            })
            ivf = getattr(self.engine, "ivf", None)
            if ivf is not None:
                body["ann"] = {
                    "kind": "ivf",
                    "clusters": ivf.n_clusters,
                    # the tuned value when --ann-target-recall measured one
                    "nprobe": (self.engine.config.ann_nprobe
                               or "auto"),
                    "bucket_quant": ivf.quant or "bf16",
                }
        if self.verifier is not None:
            v = {"kind": type(self.verifier).__name__}
            v.update(self.verifier_mesh() or {})
            if getattr(self.verifier, "draft_params", None) is not None:
                v["draft"] = True
            body["verifier"] = v
        return body

    # -- request-thread entry points ------------------------------------------

    def search_texts(self, texts: List[str], k: Optional[int]) -> list:
        if self.towers.text_encode is None:
            raise ValueError("server started without a tokenizer; "
                             "text search unavailable")
        return self._device.submit(("text", k), list(texts))

    def search_images(self, blobs: List[bytes], k: Optional[int]) -> list:
        pixels = self._decode(blobs)
        return self._device.submit(("image", k), pixels)

    def verify_images(self, blobs: List[bytes], category: str,
                      threshold: float,
                      prompt: str = "a photo of {category}") -> list:
        """The cascade as a request/response flow: CLIP gate (100·cosine vs
        the category prompt, the reference's logit-scaled score) then the
        VLM yes/no on gate survivors only (union_clip_llava2.py:189-194)."""
        import os
        import tempfile

        if self.towers.text_encode is None:
            raise ValueError("server started without a tokenizer; "
                             "verify unavailable")
        pixels = self._decode(blobs)
        scores = self._device.submit(
            ("gate",), (pixels, prompt.format(category=category)))
        passed = scores >= threshold
        verified: List[Optional[bool]] = [None] * len(blobs)
        if self.verifier is not None and passed.any():
            survivors = [i for i in range(len(blobs)) if passed[i]]
            # the Verifier protocol takes paths (the cascade's unit of
            # work); uploaded bytes go through short-lived temp files
            tmps = []
            try:
                for i in survivors:
                    f = tempfile.NamedTemporaryFile(suffix=".jpg",
                                                    delete=False)
                    f.write(blobs[i])
                    f.close()
                    tmps.append(f.name)
                # one item per survivor image: the VLM worker packs
                # survivors from ALL concurrent requests (same category)
                # into fixed-size packs
                answers = self._vlm.submit_many(category, tmps)
                for i, ok in zip(survivors, answers):
                    verified[i] = bool(ok)
            finally:
                for p in tmps:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
        return [{"gate_score": float(s), "gate_passed": bool(p),
                 "verified": v}
                for s, p, v in zip(scores, passed, verified)]

    # -- helpers --------------------------------------------------------------

    def _decode(self, blobs: List[bytes]) -> np.ndarray:
        """JPEG/PNG decode + resize on the REQUEST thread: decode is pure
        host CPU, so concurrent requests overlap it while the device
        worker crunches."""
        from mmrs_tpu_torch.io.images import pil_loader
        from mmrs_tpu_torch.ops.preprocess import resize_center_crop

        with self.stats.timed("decode", count=len(blobs)):
            return np.stack([
                resize_center_crop(pil_loader(b), self.image_size)
                for b in blobs
            ])

    @staticmethod
    def _hits(per_query) -> list:
        return [[{"path": h.path, "score": h.score, "rank": h.rank,
                  "cls": h.cls} for h in hits] for hits in per_query]

    @staticmethod
    def _split(flat: list, sizes: List[int]) -> list:
        out, i = [], 0
        for n in sizes:
            out.append(flat[i:i + n])
            i += n
        return out

    # -- device worker (single thread; one dispatch per request GROUP) --------

    def _device_handler(self, key, payloads):
        with torch.inference_mode():
            return self._device_work(key, payloads)

    def _device_work(self, key, payloads):
        kind = key[0]
        # hot-reload check rides the device worker thread, so an engine
        # swap can never race a query (both happen here, sequentially)
        if self.watch_interval > 0:
            self.maybe_reload()
        with self._fetch_lock:
            if kind == "text":
                k = key[1]
                sizes = [len(p) for p in payloads]
                texts = [t for p in payloads for t in p]
                with self.stats.timed("text_encode", count=len(texts)):
                    vecs = self.towers.text_encode(texts)
                with self.stats.timed("query", count=len(texts)):
                    hits = self._hits(self.engine.query_text(vecs, top_k=k))
                return self._split(hits, sizes)
            if kind == "image":
                k = key[1]
                sizes = [len(p) for p in payloads]
                pixels = np.concatenate(payloads, axis=0)
                with self.stats.timed("image_encode", count=len(pixels)):
                    vecs = self.towers.image_encode(pixels)
                with self.stats.timed("query", count=len(pixels)):
                    hits = self._hits(self.engine.query_image(vecs, top_k=k))
                return self._split(hits, sizes)
            if kind == "gate":
                # payloads: [(pixels [n,H,W,3], prompt_str), ...] — images
                # from every in-flight verify request share one encode;
                # distinct prompts share one text dispatch
                sizes = [len(px) for px, _ in payloads]
                pixels = np.concatenate([px for px, _ in payloads], axis=0)
                prompts = []
                prompt_idx = []
                for _, pr in payloads:
                    if pr not in prompts:
                        prompts.append(pr)
                    prompt_idx.append(prompts.index(pr))
                with self.stats.timed("image_encode", count=len(pixels)):
                    img = np.asarray(self.towers.image_encode(pixels))
                with self.stats.timed("text_encode", count=len(prompts)):
                    txt = np.asarray(self.towers.text_encode(prompts))
                out, i = [], 0
                for n, pi in zip(sizes, prompt_idx):
                    out.append(self.logit_scale * (img[i:i + n] @ txt[pi]))
                    i += n
                return out
            raise ValueError(f"unknown device work kind {kind!r}")

    # -- VLM worker (single thread; fixed packs, pipelined dispatch) ----------

    def _vlm_handler(self, category, paths):
        with torch.inference_mode():
            return self._vlm_work(category, paths)

    def _vlm_work(self, category, paths):
        """All pending survivor images for `category` -> fixed-size verify
        packs. Async-capable verifiers keep `verify_pipeline_depth` packs
        in flight (dispatch pack i+1 while the device decodes pack i)."""
        v = self.verifier
        vb = self.verify_batch
        async_ok = (hasattr(v, "verify_batch_async")
                    and hasattr(v, "collect"))
        if async_ok:
            answers: list = []
            in_flight: list = []

            def drain_one():
                n, handle = in_flight.pop(0)
                with self._fetch_lock, \
                        self.stats.timed("verifier_wait", count=n):
                    answers.extend(v.collect(handle))

            for j in range(0, len(paths), vb):
                pack = paths[j:j + vb]
                with self.stats.timed("verifier", count=len(pack)):
                    handle = v.verify_batch_async(pack, category,
                                                  fixed_batch=vb)
                in_flight.append((len(pack), handle))
                while len(in_flight) > self.verify_pipeline_depth:
                    drain_one()
            while in_flight:
                drain_one()
            return answers
        batch_fn = getattr(v, "verify_batch", None)
        if batch_fn is not None:
            # pass fixed_batch only to verifiers that accept it (any
            # cascade Verifier slots in, mirroring pipeline._verify_paths)
            takes_fixed = "fixed_batch" in inspect.signature(
                batch_fn).parameters
            answers = []
            for j in range(0, len(paths), vb):
                pack = paths[j:j + vb]
                with self._fetch_lock, \
                        self.stats.timed("verifier", count=len(pack)):
                    answers.extend(
                        batch_fn(pack, category, fixed_batch=vb)
                        if takes_fixed else batch_fn(pack, category))
            return answers
        out = []
        with self._fetch_lock:
            for p in paths:
                with self.stats.timed("verifier", count=1):
                    out.append(bool(v.verify(p, category)))
        return out


def _blob_list(req: dict) -> List[bytes]:
    """Decode image_b64/images_b64 from a request body. An explicit empty
    `images_b64` list means "no images" (not "fall back to image_b64")."""
    if "images_b64" in req:
        return [base64.b64decode(s) for s in req["images_b64"]]
    return [base64.b64decode(req["image_b64"])]


def _make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging, not stderr
            log.debug(fmt % args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/healthz":
                    return self._reply(200, service.healthz())
                if self.path == "/v1/stats":
                    from mmrs_tpu_torch.cascade.verifier import (
                        speculative_stats_of,
                    )

                    body = {"stages": service.stats.as_dict()}
                    # realized speculative acceptance (rounds, tokens,
                    # verification-slot utilization) when the verifier
                    # decodes with a draft model
                    spec = speculative_stats_of(service.verifier)
                    if spec is not None:
                        body["speculative"] = spec
                    hosting = service.verifier_mesh()
                    if hosting is not None:
                        body["verifier"] = hosting
                    return self._reply(200, body)
                return self._reply(404, {"error": "unknown path"})
            except Exception as e:  # noqa: BLE001 — keep serving
                return self._reply(500, {"error": repr(e)})

        def do_POST(self):
            if self.path not in ("/v1/search", "/v1/verify"):
                return self._reply(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/v1/verify":
                    blobs = _blob_list(req)
                    if not blobs:  # explicit empty images_b64 -> no work
                        return self._reply(200, {"results": []})
                    results = service.verify_images(
                        blobs, req["category"],
                        float(req.get("threshold", 0.0)),
                        prompt=req.get("prompt", "a photo of {category}"))
                    return self._reply(200, {"results": results})
                k = req.get("k")
                if "text" in req or "texts" in req:
                    texts = (req["texts"] if "texts" in req
                             else [req["text"]])
                    if not texts:
                        return self._reply(200, {"hits": []})
                    hits = service.search_texts(list(texts), k)
                elif "image_b64" in req or "images_b64" in req:
                    blobs = _blob_list(req)
                    if not blobs:
                        return self._reply(200, {"hits": []})
                    hits = service.search_images(blobs, k)
                else:
                    return self._reply(
                        400, {"error": "need text(s) or image(s)_b64"})
                return self._reply(200, {"hits": hits})
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError, binascii.Error) as e:
                # malformed request payloads are the CLIENT's fault
                return self._reply(400, {"error": repr(e)})
            except Exception as e:  # noqa: BLE001 — keep serving
                # device/runtime/batcher faults are SERVER errors: a 400
                # here miscounts monitoring and stops clients retrying
                return self._reply(500, {"error": repr(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    # a burst of concurrent clients must not overflow the listen backlog
    # (socketserver's default of 5 resets connections under a burst)
    request_queue_size = 128
    daemon_threads = True


def make_server(service: SearchService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; call .serve_forever() to run."""
    return _Server((host, port), _make_handler(service))
