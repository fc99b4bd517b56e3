"""The port imports torch and never jax, nor the heavy optional packages.

Each check runs in a fresh interpreter, since this test process has jax
loaded already.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _python(code: str, cwd: str = REPO) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_modules_import_no_jax_and_no_optional_packages():
    r = _python(
        "import importlib, pkgutil, sys\n"
        "import mmrs_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    mmrs_tpu_torch.__path__, 'mmrs_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
        "print(sorted(m for m in ('jax', 'jaxlib', 'mmrs_tpu', 'yaml',\n"
        "    'regex', 'PIL', 'ml_dtypes', 'triton') if m in sys.modules))\n"
        "print(' '.join(names))\n")
    assert r.returncode == 0, r.stderr[-2000:]
    count, loaded, names = r.stdout.strip().splitlines()
    assert int(count) >= 36
    assert loaded == "[]"
    for mod in ("index.ivf", "index.stream", "ops.kmeans",
                "search.prototypes", "ops.allpairs", "govern.dedup",
                "govern.hashing", "govern.native", "govern.normalize",
                "govern.manifest", "govern.vqa"):
        assert f"mmrs_tpu_torch.{mod}" in names.split()


def test_chip_smoke_imports_no_jax_and_refuses_without_a_gpu(tmp_path):
    r = _python("import sys, chip_smoke\n"
                "print('jax' in sys.modules, 'mmrs_tpu' in sys.modules)\n"
                "sys.exit(chip_smoke.main())\n")
    assert r.stdout.splitlines()[0] == "False False"
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and '"ok"' not in r.stdout
