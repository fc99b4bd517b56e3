"""A tiny copy of the benchmark for CPU tests: the real generators,
metric readers and reference, over the port's tiny tower presets and a
small gallery, under a root of its own."""

from __future__ import annotations

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

VIT_TINY = {"kind": "vit", "image_size": 224, "patch_size": 32, "width": 128,
            "layers": 2, "heads": 4, "mlp_ratio": 4, "embed_dim": 64,
            "activation": "quick_gelu", "layer_norm_eps": 1e-05,
            "ln_outlier_gain": 8.0}
CONFIGS = {
    "tiny-clip": {
        "port": {"image_tower": "vit_tiny", "text_tower": "clip_text"},
        "dtype": "bfloat16", "image_tower": VIT_TINY,
        "text_tower": {"kind": "clip_text", "vocab_size": 49408,
                       "context_length": 77, "width": 128, "layers": 2,
                       "heads": 4, "mlp_ratio": 4, "embed_dim": 64,
                       "activation": "quick_gelu", "layer_norm_eps": 1e-05,
                       "ln_outlier_gain": 8.0},
        "gallery": {"rows": 8192, "dim": 64, "clusters": 64, "spread": 1.0}},
    "tiny-taiyi": {
        "port": {"image_tower": "vit_tiny", "text_tower": "taiyi_roberta"},
        "dtype": "bfloat16", "image_tower": VIT_TINY,
        "text_tower": {"kind": "bert", "vocab_size": 21128, "hidden_size": 64,
                       "layers": 2, "heads": 2, "intermediate_size": 128,
                       "max_position_embeddings": 512, "type_vocab_size": 2,
                       "num_labels": 64, "layer_norm_eps": 1e-12,
                       "activation": "gelu", "max_length": 64},
        "gallery": {"rows": 8192, "dim": 64, "clusters": 64, "spread": 1.0}},
}
TRAFFIC_CHANGES = {
    "index": {"pool_images": 64, "batch": 16, "shard_rows": 48,
              "sample_rows": 24},
    "search_en_poisson": {"pool_texts": 32, "rate_qps": 20, "senders": 4,
                          "max_batch": 4, "sample_requests": 8},
    "search_zh_poisson": {"pool_texts": 32, "rate_qps": 20, "senders": 4,
                          "max_batch": 4, "sample_requests": 8},
}
CELLS = [("t-clip.index", "tiny-clip", "index"),
         ("t-taiyi.index", "tiny-taiyi", "index"),
         ("t-clip.search", "tiny-clip", "search_en_poisson"),
         ("t-taiyi.search", "tiny-taiyi", "search_zh_poisson")]


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str, limits=None) -> str:
    """A benchmark root at `tmp`: BENCHMARK.json with the tiny cells and
    the real metrics, the real generators and metric readers (linked),
    tiny configuration, traffic and limit files. Returns the root."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    bench = os.path.join(tmp, "benchmark")
    os.makedirs(bench, exist_ok=True)
    for d in ("generators", "metrics"):
        os.symlink(os.path.join(BENCH, d), os.path.join(bench, d))
    manifest["configs"] = []
    for name, cfg in CONFIGS.items():
        _dump(os.path.join(bench, "configs", f"{name}.json"), cfg)
        manifest["configs"].append({
            "name": name, "source": "tiny", "reduced": [], "why": "tests",
            "file": f"benchmark/configs/{name}.json"})
    for name, changes in TRAFFIC_CHANGES.items():
        with open(os.path.join(BENCH, "traffic", f"{name}.json"),
                  encoding="utf-8") as f:
            traffic = json.load(f)
        traffic.update(changes)
        _dump(os.path.join(bench, "traffic", f"{name}.json"), traffic)
    manifest["workloads"] = [
        {"name": c, "config": cfg, "traffic": tr, "chips": 1, "why": "tests"}
        for c, cfg, tr in CELLS]
    real = {"index": "clip-b32.index", "search_en_poisson": "clip-b32.search",
            "search_zh_poisson": "taiyi-l14.search"}
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            if "workloads" in m:
                m["workloads"] = [c for c, _, tr in CELLS
                                  if real[tr].split(".")[1]
                                  == m["workloads"][0].split(".")[1]]
    for c, _, tr in CELLS:
        with open(os.path.join(BENCH, "limits", f"{real[tr]}.json"),
                  encoding="utf-8") as f:
            lim = json.load(f)
        _dump(os.path.join(bench, "limits", f"{c}.json"),
              (limits or {}).get(c, lim))
    _dump(os.path.join(tmp, "BENCHMARK.json"), manifest)
    return tmp


def tiny(name: str):
    return copy.deepcopy(CONFIGS[name])
