"""The port's serving layer (serve.py, microbatch.py, `search --server`)
against mmrs_tpu's: tests/test_serve.py, test_serve_reload.py and
test_microbatch.py's cases that need no mesh, on the port, and search
hits equal to mmrs_tpu's SearchService over the same index and weights
(paths equal, scores within 1e-4: f32 towers on both sides)."""

import base64
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from mmrs_tpu import serve as j_serve
from mmrs_tpu.config import Config as JConfig
from mmrs_tpu.index.gallery import GalleryIndex as JGalleryIndex
from mmrs_tpu.microbatch import MicroBatcher as JMicroBatcher
from mmrs_tpu.models import checkpoint as j_checkpoint
from mmrs_tpu.models import clip as j_clip
from mmrs_tpu.models.configs import CLIP_TEXT_TINY, VIT_TINY
from mmrs_tpu.models.tokenizer import CLIPTokenizer as JTokenizer
from mmrs_tpu.pipeline import build_towers as j_build_towers
from mmrs_tpu.search.engine import SearchEngine as JEngine
from mmrs_tpu_torch.config import Config
from mmrs_tpu_torch.index.gallery import (GalleryIndex, build_index,
                                          compact_index, update_index)
from mmrs_tpu_torch.io.dataset import FolderDataset
from mmrs_tpu_torch.microbatch import MicroBatcher
from mmrs_tpu_torch.models.tokenizer import CLIPTokenizer
from mmrs_tpu_torch.pipeline import build_towers
from mmrs_tpu_torch.search.engine import SearchEngine
from mmrs_tpu_torch.serve import SearchService, make_server

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _cfg(mod, ckpt):
    cfg = mod()
    cfg.model.image_tower = "vit_tiny"
    cfg.model.dtype = "float32"
    cfg.model.checkpoint_path = ckpt
    return cfg


def _img_bytes(rng, color, size=32):
    arr = np.clip(np.full((size, size, 3), color, int)
                  + rng.integers(-20, 20, (size, size, 3)), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


RED, BLUE, GREEN = (220, 30, 30), (30, 30, 220), (30, 200, 30)


class ColorVerifier:
    """Answers by opening the (temp-file) image: yes iff mostly red.
    Exercises the /v1/verify blob -> tempfile -> Verifier path."""

    def __init__(self):
        self.calls = []

    def verify(self, image_path, category):
        self.calls.append((image_path, category))
        arr = np.asarray(Image.open(image_path).convert("RGB"), float)
        return bool(arr[..., 0].mean() > arr[..., 2].mean())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two color classes of 4 JPEGs, one f32 vit_tiny checkpoint both
    packages load, an index built by the port, and the port's service
    behind an HTTP server on an ephemeral port."""
    tmp = tmp_path_factory.mktemp("serve")
    root, out = str(tmp / "data"), str(tmp / "idx")
    rng = np.random.default_rng(0)
    blobs = {}
    for cls, color in [("red", RED), ("blue", BLUE)]:
        os.makedirs(os.path.join(root, cls))
        for i in range(4):
            blobs[cls] = _img_bytes(rng, color)
            with open(os.path.join(root, cls, f"{cls}{i}.jpg"), "wb") as f:
                f.write(blobs[cls])
    ckpt = str(tmp / "tiny.npz")
    j_checkpoint.save_npz(j_clip.init(jax.random.key(1), j_clip.CLIPConfig(
        vision=VIT_TINY, text=CLIP_TEXT_TINY)), ckpt)
    towers = build_towers(_cfg(Config, ckpt), tokenizer=CLIPTokenizer([]),
                          device="cpu")
    build_index(FolderDataset.from_root(root), towers.image_encode, out,
                batch_size=8)
    engine = SearchEngine(GalleryIndex.load(out), device="cpu")
    verifier = ColorVerifier()
    svc = SearchService(engine, towers, verifier=verifier, batch_window=0.05)
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield SimpleNamespace(base=f"http://127.0.0.1:{srv.server_address[1]}",
                          blobs=blobs, verifier=verifier, ckpt=ckpt,
                          index=out, towers=towers, service=svc)
    srv.shutdown()
    srv.server_close()
    svc.close()
    t.join(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _b64(blob):
    return base64.b64encode(blob).decode()


def test_healthz(world):
    h = _get(world.base + "/healthz")
    assert h["ok"] and h["rows"] == 8 and h["dim"] == VIT_TINY.embed_dim
    assert h["gallery_shards"] == 1 and h["gallery_int8"] is False
    assert h["gallery_quant"] == "bf16"
    assert h["verifier"] == {"kind": "ColorVerifier"}


def test_healthz_equals_jax_for_each_rung(world):
    """The deployment shape reads the same as mmrs_tpu's for the flat
    rungs and an IVF engine (one device: one shard)."""
    import dataclasses

    from mmrs_tpu.config import SearchConfig as JSearch
    from mmrs_tpu_torch.config import SearchConfig

    for quant, ann in (("", None), ("int8", None), ("int4", None),
                       ("", 4)):
        t_cfg, j_cfg = SearchConfig(), JSearch()
        if ann:
            t_cfg = dataclasses.replace(t_cfg, ann="ivf", ann_clusters=ann,
                                        ann_nprobe=2)
            j_cfg = dataclasses.replace(j_cfg, ann="ivf", ann_clusters=ann,
                                        ann_nprobe=2)
        t_eng = SearchEngine(GalleryIndex.load(world.index), t_cfg,
                             quantize=quant, device="cpu")
        j_eng = JEngine(JGalleryIndex.load(world.index), j_cfg,
                        quantize=quant)
        got = SearchService(t_eng, None, verifier=ColorVerifier())
        want = j_serve.SearchService(j_eng, None, verifier=ColorVerifier())
        try:
            assert got.healthz() == want.healthz()
        finally:
            got.close()
            want.close()


@pytest.mark.parametrize("k", [3, 8])
def test_search_hits_equal_jax(world, k):
    j_towers = j_build_towers(_cfg(JConfig, world.ckpt),
                              tokenizer=JTokenizer([]))
    j_svc = j_serve.SearchService(JEngine(JGalleryIndex.load(world.index)),
                                  j_towers)
    try:
        for blob in world.blobs.values():
            want = j_svc.search_images([blob], k)
            got = _post(world.base + "/v1/search",
                        {"image_b64": _b64(blob), "k": k})["hits"]
            assert [h["path"] for h in got[0]] == \
                [h["path"] for h in want[0]]
            np.testing.assert_allclose([h["score"] for h in got[0]],
                                       [h["score"] for h in want[0]],
                                       atol=1e-4)
        texts = ["red thing", "blue thing"]
        want = j_svc.search_texts(texts, k)
        got = _post(world.base + "/v1/search", {"texts": texts, "k": k})
        assert [[h["path"] for h in q] for q in got["hits"]] == \
            [[h["path"] for h in q] for q in want]
    finally:
        j_svc.close()


def test_image_search_ranks_same_class_first(world):
    out = _post(world.base + "/v1/search",
                {"image_b64": _b64(world.blobs["red"]), "k": 3})
    hits = out["hits"][0]
    assert len(hits) == 3
    assert hits[0]["cls"] == "red" and hits[0]["score"] >= hits[-1]["score"]


def test_bad_request(world):
    req = urllib.request.Request(
        world.base + "/v1/search", data=b"{}",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_verify_endpoint_cascade(world):
    """/v1/verify: gate scores + survivor-only VLM verify over uploads."""
    imgs = [_b64(world.blobs["red"]), _b64(world.blobs["blue"])]
    n0 = len(world.verifier.calls)
    res = _post(world.base + "/v1/verify",
                {"images_b64": imgs, "category": "red",
                 "threshold": -1e9})["results"]
    assert len(res) == 2 and all(r["gate_passed"] for r in res)
    assert res[0]["verified"] is True and res[1]["verified"] is False
    assert len(world.verifier.calls) - n0 == 2
    n1 = len(world.verifier.calls)
    res = _post(world.base + "/v1/verify",
                {"images_b64": imgs, "category": "red",
                 "threshold": 1e9})["results"]
    assert all(not r["gate_passed"] and r["verified"] is None for r in res)
    assert len(world.verifier.calls) == n1


def test_gate_scores_equal_jax(world):
    """The gate's 100 x cosine against the category prompt, the same as
    mmrs_tpu's service on the same weights."""
    j_towers = j_build_towers(_cfg(JConfig, world.ckpt),
                              tokenizer=JTokenizer([]))
    j_svc = j_serve.SearchService(None, j_towers)
    blobs = list(world.blobs.values())
    try:
        want = j_svc.verify_images(blobs, "red", threshold=0.0)
        got = world.service.verify_images(blobs, "red", threshold=0.0)
    finally:
        j_svc.close()
    np.testing.assert_allclose([r["gate_score"] for r in got],
                               [r["gate_score"] for r in want], atol=1e-3)


def test_stats_endpoint(world):
    _post(world.base + "/v1/search",
          {"image_b64": _b64(world.blobs["red"]), "k": 2})
    st = _get(world.base + "/v1/stats")["stages"]
    for stage in ("decode", "image_encode", "query"):
        assert stage in st and st[stage]["count"] >= 1, st
        assert "items_per_call" in st[stage]


def test_empty_batch_requests(world):
    assert _post(world.base + "/v1/search", {"texts": []}) == {"hits": []}
    assert _post(world.base + "/v1/search", {"images_b64": []}) == \
        {"hits": []}
    assert _post(world.base + "/v1/verify",
                 {"images_b64": [], "category": "red"}) == {"results": []}


def test_http_concurrent_requests_batch(world):
    """10 concurrent HTTP searches coalesce: device dispatches < requests
    (the /v1/stats call counts), and nothing deadlocks."""
    st0 = _get(world.base + "/v1/stats")["stages"].get("query", {})
    calls0, count0 = st0.get("calls", 0), st0.get("count", 0)
    n = 10
    barrier = threading.Barrier(n)
    errors = []

    def one(i):
        try:
            barrier.wait(timeout=30)
            out = _post(world.base + "/v1/search",
                        {"text": f"thing {i}", "k": 2})
            assert len(out["hits"]) == 1 and len(out["hits"][0]) == 2
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    st1 = _get(world.base + "/v1/stats")["stages"]["query"]
    assert st1["count"] - count0 == n
    assert st1["calls"] - calls0 < n, (st1, calls0)


def test_workers_run_under_inference_mode(world, monkeypatch):
    """Every torch call of the device worker runs under inference mode on
    its own thread (the mode is thread-local)."""
    seen = []
    real = world.towers.image_encode

    def spy(pixels):
        seen.append((torch.is_inference_mode_enabled(),
                     threading.current_thread().name))
        return real(pixels)

    monkeypatch.setattr(world.towers, "image_encode", spy)
    world.service.search_images([world.blobs["blue"]], 2)
    assert seen == [(True, "mmrs-device-batcher")]


# ---- service-level micro-batching (stub towers / engine) -------------------

def _stub_towers(dim=8):
    def text_encode(texts):
        out = np.zeros((len(texts), dim), np.float32)
        out[:, 0] = 1.0
        return out

    def image_encode(pixels):
        out = np.zeros((len(pixels), dim), np.float32)
        out[:, 0] = np.asarray(pixels)[..., 0].mean(axis=(1, 2)) / 255.0
        return out

    return SimpleNamespace(text_encode=text_encode,
                           image_encode=image_encode)


class _FakeEngine:
    """query_* returns one hit per query row; index is unused."""

    index = SimpleNamespace(dim=8, paths=[], classes=[])

    def query_text(self, vecs, top_k=None):
        return [[SimpleNamespace(path=f"t{i}", score=1.0, rank=0, cls="c")]
                for i in range(len(vecs))]

    query_image = query_text


def _jpeg_blob(value):
    buf = io.BytesIO()
    Image.fromarray(np.full((8, 8, 3), value, np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def test_verify_images_fixed_packs():
    """Batched verifiers get fixed-size packs; results map back to the
    right images."""
    blobs = [_jpeg_blob(10 * i) for i in range(5)]

    class Towers:
        def image_encode(self, pixels):
            out = np.zeros((len(pixels), 8), np.float32)
            out[:, 0] = np.arange(len(pixels), dtype=np.float32)
            return out

        def text_encode(self, texts):
            e = np.zeros((1, 8), np.float32)
            e[0, 0] = 1.0
            return e

    class PackVerifier:
        def __init__(self):
            self.packs = []

        def verify_batch(self, paths, category, fixed_batch=None):
            assert fixed_batch == 2
            self.packs.append(len(paths))
            return [j % 2 == 1 for j in range(len(paths))]

    pv = PackVerifier()
    svc = SearchService(engine=None, towers=Towers(), verifier=pv,
                        verify_batch=2, logit_scale=1.0)
    try:
        res = svc.verify_images(blobs, "cat", threshold=2.0)
    finally:
        svc.close()
    assert [r["gate_passed"] for r in res] == [False, False, True, True, True]
    assert pv.packs == [2, 1]
    assert [r["verified"] for r in res] == [None, None, False, True, False]


def test_vlm_packs_across_requests():
    """Survivors from concurrent /v1/verify requests share fixed verify
    packs: 2 requests x 3 survivors -> packs of 4 and 2."""
    class AsyncPackVerifier:
        def __init__(self):
            self.packs = []

        def verify_batch_async(self, paths, category, fixed_batch=None):
            self.packs.append(len(paths))
            return [True] * len(paths)

        def collect(self, handle):
            return handle

    pv = AsyncPackVerifier()
    svc = SearchService(engine=None, towers=_stub_towers(), verifier=pv,
                        verify_batch=4, logit_scale=1.0, batch_window=0.25)
    blobs = [_jpeg_blob(200)] * 3
    barrier = threading.Barrier(2)
    results = [None, None]

    def one(slot):
        barrier.wait(timeout=30)
        results[slot] = svc.verify_images(blobs, "cat", threshold=0.0)

    threads = [threading.Thread(target=one, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    svc.close()
    for res in results:
        assert res is not None
        assert [r["verified"] for r in res] == [True, True, True]
    assert sum(pv.packs) == 6 and max(pv.packs) == 4, pv.packs
    st = svc.stats.as_dict()["verifier"]
    assert st["count"] == 6 and st["calls"] == 2


def test_search_not_blocked_by_slow_verify():
    """With concurrent fetches allowed, a search completes while a
    verify's collect is still in flight."""
    dispatched = threading.Event()
    release = threading.Event()

    class SlowVerifier:
        def verify_batch_async(self, paths, category, fixed_batch=None):
            dispatched.set()
            return [True] * len(paths)

        def collect(self, handle):
            assert release.wait(timeout=60), "never released"
            return handle

    svc = SearchService(engine=_FakeEngine(), towers=_stub_towers(),
                        verifier=SlowVerifier(), verify_batch=2,
                        logit_scale=1.0, batch_window=0.005,
                        serialize_fetch=False)
    verify_result = []

    def do_verify():
        verify_result.append(
            svc.verify_images([_jpeg_blob(200)], "cat", threshold=0.0))

    t = threading.Thread(target=do_verify)
    t.start()
    assert dispatched.wait(timeout=60)
    hits = svc.search_texts(["a query"], k=1)
    assert len(hits) == 1 and hits[0][0]["path"] == "t0"
    assert not verify_result
    release.set()
    t.join(timeout=60)
    assert not t.is_alive()
    svc.close()
    assert verify_result and verify_result[0][0]["verified"] is True


def test_verify_drives_the_llava_verifier_async_path(tmp_path):
    """/v1/verify's VLM worker drives LLaVAVerifier.verify_batch_async /
    collect: the verdicts equal the verifier's own verify_batch on the
    same images (a 2-layer random LLaVA on the CPU)."""
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.models import llava
    from mmrs_tpu_torch.models.configs import VITConfig
    from mmrs_tpu_torch.models.llama import LlamaConfig

    class Tok:
        def encode(self, t):
            return [3 + (ord(c) % 60) for c in t][:12]

        def decode(self, ids):
            return "yes" if ids and ids[0] % 2 == 0 else "no"

    cfg = llava.LLaVAConfig(
        vision=VITConfig(image_size=32, patch_size=8, width=48, layers=2,
                         heads=4, embed_dim=32),
        lm=LlamaConfig(vocab_size=128, dim=64, layers=2, heads=4,
                       kv_heads=2, mlp_dim=128, max_seq=128))
    model = llava.LLaVA(cfg, torch.Generator().manual_seed(0))
    v = LLaVAVerifier(model, cfg, Tok(), max_new_tokens=3, eos_token=-1,
                      image_size=32, compute_dtype=torch.float32,
                      device="cpu")
    blobs = [_jpeg_blob(x) for x in (40, 120, 220)]
    paths = []
    for i, b in enumerate(blobs):
        p = tmp_path / f"{i}.jpg"
        p.write_bytes(b)
        paths.append(str(p))
    want = v.verify_batch(paths, "cat", fixed_batch=4)
    svc = SearchService(engine=None, towers=_stub_towers(), verifier=v,
                        verify_batch=4, logit_scale=1.0, batch_window=0.05)
    try:
        got = svc.verify_images(blobs, "cat", threshold=0.0)
    finally:
        svc.close()
    assert [r["verified"] for r in got] == want
    assert svc.stats.as_dict()["verifier"]["calls"] == 1


def test_verify_with_tp_hosted_verifier_matches_one_device(tmp_path):
    """SearchService.verify_images with a 2x2-meshed LLaVAVerifier (the
    --tp 2x2 serving config): the VLM worker drives the TP generate and
    the verdicts equal the one-device verifier's (and JAX's meshed
    service's); /healthz and /v1/stats report the verifier's tp and dp."""
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from mmrs_tpu.cascade.verifier import TPULLaVAVerifier
    from mmrs_tpu.models import llava as j_llava
    from mmrs_tpu.models.configs import VITConfig as JVITConfig
    from mmrs_tpu.models.llama import LlamaConfig as JLlamaConfig
    from mmrs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from mmrs_tpu_torch.cascade.verifier import LLaVAVerifier
    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.models import convert_jax, llava
    from mmrs_tpu_torch.models.configs import VITConfig
    from mmrs_tpu_torch.models.llama import LlamaConfig
    from mmrs_tpu_torch.parallel.mesh import make_mesh

    class Tok:
        def encode(self, t):
            return [3 + (ord(c) % 60) for c in t][:12]

        def decode(self, ids):
            return "yes" if ids and ids[0] % 2 == 0 else "no"

    lm = dict(vocab_size=128, dim=64, layers=2, heads=4, kv_heads=2,
              mlp_dim=128, max_seq=128)
    vis = dict(image_size=32, patch_size=8, width=48, layers=2, heads=4,
               embed_dim=32)
    jcfg = j_llava.LLaVAConfig(vision=JVITConfig(**vis),
                               lm=JLlamaConfig(**lm))
    params = j_llava.init(jax.random.key(0), jcfg)
    cfg = llava.LLaVAConfig(vision=VITConfig(**vis), lm=LlamaConfig(**lm))
    model = convert_jax.from_jax_llava(jax.tree.map(np.asarray, params),
                                       cfg)
    kw = dict(max_new_tokens=3, eos_token=-1, image_size=32)
    mesh = make_mesh(MeshConfig(data_size=2, model_size=2),
                     [torch.device("cpu")] * 4)
    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                  (DATA_AXIS, MODEL_AXIS))
    verifiers = {
        "one": LLaVAVerifier(model, cfg, Tok(), compute_dtype=torch.float32,
                             device="cpu", **kw),
        "tp": LLaVAVerifier(model, cfg, Tok(), compute_dtype=torch.float32,
                            mesh=mesh, **kw),
        "jax": TPULLaVAVerifier(params, jcfg, Tok(),
                                compute_dtype=jnp.float32, mesh=jmesh, **kw)}
    blobs = [_jpeg_blob(v) for v in (40, 120, 220)]
    got = {}
    for name, v in verifiers.items():
        svc = SearchService(engine=None, towers=_stub_towers(), verifier=v,
                            verify_batch=4, logit_scale=1.0,
                            batch_window=0.05)
        try:
            got[name] = [r["verified"] for r in svc.verify_images(
                blobs, "cat", threshold=0.0)]
            if name == "tp":
                srv = make_server(svc, port=0)
                t = threading.Thread(target=srv.serve_forever, daemon=True)
                t.start()
                try:
                    base = f"http://127.0.0.1:{srv.server_address[1]}"
                    health = _get(base + "/healthz")["verifier"]
                    stats = _get(base + "/v1/stats")["verifier"]
                finally:
                    srv.shutdown()
                    srv.server_close()
            if name == "jax":
                j_health = svc.healthz()["verifier"]
        finally:
            svc.close()
    assert got["tp"] == got["one"] == got["jax"]
    assert health == {"kind": "LLaVAVerifier", "tp": 2, "dp": 2}
    assert {k: j_health[k] for k in ("tp", "dp")} == {"tp": 2, "dp": 2}
    assert stats == {"tp": 2, "dp": 2}
    svc = SearchService(engine=None, towers=_stub_towers(),
                        verifier=verifiers["one"], batch_window=0.01)
    try:
        assert svc.healthz()["verifier"] == {"kind": "LLaVAVerifier"}
        assert svc.verifier_mesh() is None
    finally:
        svc.close()


def test_stats_surface_speculative_acceptance():
    class SpecVerifier:
        def verify(self, image_path, category):
            return True

        def speculative_stats(self):
            return {"rounds": 7, "tokens": 21, "utilization": 0.75}

    svc = SearchService(engine=None, towers=_stub_towers(),
                        verifier=SpecVerifier(), batch_window=0.01)
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        body = _get(f"http://127.0.0.1:{srv.server_address[1]}/v1/stats")
        assert body["speculative"] == {"rounds": 7, "tokens": 21,
                                       "utilization": 0.75}
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_cli_search_server_mode(world, tmp_path, capsys):
    """`mmrs-torch search --server URL` (and mmrs_tpu's client) query the
    port's running server over HTTP: the same lines."""
    from mmrs_tpu.cli.main import main as j_main
    from mmrs_tpu_torch.cli.main import main as t_main

    img = tmp_path / "q.jpg"
    img.write_bytes(world.blobs["red"])
    outs = []
    for main in (t_main, j_main):
        with pytest.raises(SystemExit) as e:
            main(["search", "--server", world.base, "--image", str(img),
                  "-k", "3"])
        assert e.value.code == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    lines = [ln.split("\t") for ln in outs[0].splitlines()]
    assert len(lines) == 3 and lines[0][3] == "red"
    with pytest.raises(SystemExit) as e:
        t_main(["search", "--text", "x"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        t_main(["search", "--server", "http://127.0.0.1:9", "--text", "x"])
    assert e.value.code == 2
    assert "unreachable" in capsys.readouterr().err


# ---- hot reload (tests/test_serve_reload.py) --------------------------------

def test_serve_hot_reload(tmp_path):
    root, out = str(tmp_path / "data"), str(tmp_path / "idx")
    rng = np.random.default_rng(0)
    for cls, color in [("red", RED), ("blue", BLUE)]:
        os.makedirs(os.path.join(root, cls))
        for i in range(3):
            with open(os.path.join(root, cls, f"{cls}{i}.jpg"), "wb") as f:
                f.write(_img_bytes(rng, color))
    cfg = Config()
    cfg.model.image_tower = "vit_tiny"
    towers = build_towers(cfg, tokenizer=CLIPTokenizer([]), device="cpu")
    build_index(FolderDataset.from_root(root), towers.image_encode, out,
                batch_size=8)

    def engine_factory():
        return SearchEngine(GalleryIndex.load(out), cfg.search, device="cpu")

    svc = SearchService(engine_factory(), towers, batch_window=0.01,
                        engine_factory=engine_factory, watch_interval=0.01)
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def search(blob, k=6):
        return _post(base + "/v1/search", {"image_b64": _b64(blob),
                                           "k": k})["hits"][0]

    try:
        probe_green = _img_bytes(rng, GREEN)
        assert _get(base + "/healthz")["rows"] == 6
        assert {h["cls"] for h in search(probe_green)} == {"red", "blue"}

        os.makedirs(os.path.join(root, "green"))
        for i in range(2):
            with open(os.path.join(root, "green", f"g{i}.jpg"), "wb") as f:
                f.write(_img_bytes(rng, GREEN))
        update_index(FolderDataset.from_root(root), towers.image_encode,
                     out, batch_size=8)
        deadline = time.time() + 60
        while time.time() < deadline:
            time.sleep(0.05)
            if any(h["cls"] == "green" for h in search(probe_green)):
                break
        else:
            pytest.fail(f"inserted rows never surfaced ({svc.reloads})")
        health = _get(base + "/healthz")
        assert health["rows"] == 8 and health["index_reloads"] >= 1

        for i in range(3):
            os.remove(os.path.join(root, "red", f"red{i}.jpg"))
        compact_index(out, drop_missing=True)
        probe_red = _img_bytes(rng, RED)
        deadline = time.time() + 60
        while time.time() < deadline:
            time.sleep(0.05)
            if all(h["cls"] != "red" for h in search(probe_red, k=8)):
                break
        else:
            pytest.fail(f"compacted rows kept surfacing ({svc.reloads})")
        assert _get(base + "/healthz")["rows"] == 5

        from mmrs_tpu_torch.io.images import pil_loader
        from mmrs_tpu_torch.ops.preprocess import resize_center_crop

        fresh = engine_factory()
        px = resize_center_crop(pil_loader(probe_red), svc.image_size)[None]
        fresh_hits = fresh.query_image(towers.image_encode(px), top_k=5)[0]
        live = search(probe_red, k=5)
        assert [h["path"] for h in live] == [h.path for h in fresh_hits]
        np.testing.assert_allclose([h["score"] for h in live],
                                   [h.score for h in fresh_hits], atol=1e-4)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_maybe_reload_guards():
    svc = SearchService(engine=None, towers=None)
    assert svc.maybe_reload(force=True) is False

    class _Eng:
        index = None

    sentinel = _Eng()

    def bad_factory():
        raise RuntimeError("disk gone")

    svc2 = SearchService(engine=sentinel, towers=None,
                         engine_factory=bad_factory, watch_interval=0.01)
    assert svc2.maybe_reload(force=True) is False
    assert svc2.engine is sentinel and svc2.reloads == 0
    svc.close()
    svc2.close()


# ---- MicroBatcher (tests/test_microbatch.py), both copies -------------------

BATCHERS = pytest.mark.parametrize("mb_cls", [MicroBatcher, JMicroBatcher],
                                   ids=["torch", "jax"])


@BATCHERS
def test_coalesces_concurrent_submits(mb_cls):
    calls = []

    def handler(key, payloads):
        calls.append(list(payloads))
        return [p * 10 for p in payloads]

    mb = mb_cls(handler, batch_window=0.2)
    n = 8
    barrier = threading.Barrier(n)
    results = [None] * n

    def one(i):
        barrier.wait(timeout=30)
        results[i] = mb.submit("k", i)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    mb.close()
    assert results == [i * 10 for i in range(n)]
    assert len(calls) < n and sum(len(c) for c in calls) == n


@BATCHERS
def test_groups_by_key_errors_and_caps(mb_cls):
    seen = {}

    def handler(key, payloads):
        if key == "bad":
            raise ValueError("boom")
        seen.setdefault(key, []).append(len(payloads))
        return [(key, p) for p in payloads]

    mb = mb_cls(handler, max_batch=4, batch_window=0.05)
    assert mb.submit_many("a", [1, 2, 3]) == [("a", 1), ("a", 2), ("a", 3)]
    with pytest.raises(ValueError, match="boom"):
        mb.submit("bad", 1)
    assert mb.submit_many("c", list(range(10))) == [("c", i)
                                                    for i in range(10)]
    assert max(seen["c"]) <= 4
    mb.close()
    mb.close()
    with pytest.raises(RuntimeError):
        mb.submit("a", 2)
    wrong = mb_cls(lambda key, ps: [1], batch_window=0.0)
    with pytest.raises(RuntimeError, match="results"):
        wrong.submit_many("k", [1, 2])
    wrong.close()


@BATCHERS
def test_close_never_strands_racing_submitters(mb_cls):
    mb = mb_cls(lambda k, xs: [x * 2 for x in xs], batch_window=0.001)

    def pound():
        for i in range(200):
            try:
                mb.submit("k", i)
            except RuntimeError:
                return

    threads = [threading.Thread(target=pound) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.01)
    mb.close()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "submitter stranded"


def test_queue_wait_counts_the_wait_behind_a_slow_handler():
    """The port's batcher records each item's wait, submit to the start of
    its handler call: with one item a call, the second item waits out the
    first item's handler."""
    from mmrs_tpu_torch.utils.stats import StageStats

    stats, handled = StageStats(), []

    def slow(key, payloads):
        t0 = time.perf_counter()
        time.sleep(0.05)
        handled.append(time.perf_counter() - t0)
        return payloads

    mb = MicroBatcher(slow, max_batch=1, batch_window=0.0, stats=stats)
    assert mb.submit_many("k", [1, 2]) == [1, 2]
    mb.close()
    rec = stats.stages["queue_wait"]
    assert (rec.calls, rec.count) == (2, 2)
    first, second = rec.recent
    assert second > handled[0] > first
    assert stats.as_dict()["queue_wait"]["p99_seconds"] == second


def test_stats_endpoint_reports_queue_wait(world):
    _post(world.base + "/v1/search", {"text": "a thing", "k": 2})
    st = _get(world.base + "/v1/stats")["stages"]["queue_wait"]
    assert st["count"] >= 1
    assert 0.0 <= st["p50_seconds"] <= st["p99_seconds"]
