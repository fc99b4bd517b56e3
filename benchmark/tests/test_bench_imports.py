"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the system under test. Top-level module
names are compared whole: `mmrs_tpu_torch` is not `mmrs_tpu`."""

from __future__ import annotations

import ast
import os

from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "mmrs_tpu"}


def _imports(path: str):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _sources(top: str):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {(p, m) for p in _sources(tiny.BENCH) for m in _imports(p)
           if m in FORBIDDEN}
    assert not bad
    # the port's own name is allowed, and is another name than the JAX one
    assert "mmrs_tpu_torch" not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(tiny.BENCH, "reference")
    names = {m for p in _sources(ref) for m in _imports(p)}
    assert "mmrs_tpu_torch" not in names
    assert names <= {"__future__", "html", "unicodedata", "typing", "math",
                     "numpy", "torch", "regex", "benchmark"}


def test_the_checker_compares_whole_names():
    from benchmark import run

    assert run.forbidden_modules(["mmrs_tpu_torch", "mmrs_tpu_torch.serve",
                                  "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["mmrs_tpu.ops.topk", "jax.numpy", "flax",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                 "mmrs_tpu"]
