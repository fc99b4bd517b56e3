"""Build and load the port's hand-written GPU kernels.

CUDA C++ (`csrc/*.cu`): one nvcc process per source, all started
together, compiles each to an object for `sm_90a` (Hopper); one more links
them into a shared library with a plain C interface, loaded with ctypes.
The build runs on first use, from the package's own sources, into
`_build/` next to them, keyed by a hash of the sources and flags, so a
fresh checkout builds once and later processes reuse the library.

Triton (`csrc/*_triton.py`): loaded as a module from its file on first
use; Triton compiles the kernel at its first launch.

Nothing here runs at import: this module is imported on machines without
a GPU, nvcc or triton.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import time
from functools import lru_cache
from typing import Optional

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CUDA_SOURCES = ("cosine_topk.cu", "mha_short_seq.cu", "quant_topk.cu",
                "mlp_int8.cu", "ivf_probe.cu", "first_match.cu",
                "decode_attention.cu", "dense_epilogue.cu", "layer_norm.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C signature of every exported function: (argtypes, restype)
_SIGNATURES = {
    "mmrs_topk_chunk_rows": ((), _I),
    "mmrs_topk_max_sort": ((), _I),
    "mmrs_topk_select_max": ((), _I),
    "mmrs_error_string": ((_I,), ctypes.c_char_p),
    "mmrs_topk_scan": ((_P, _P, _I, _I, _I, _I, _I, _P, _P, _P), _I),
    "mmrs_topk_merge": ((_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P), _I),
    "mmrs_mha_short_seq": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
                           _I),
    "mmrs_mha_short_seq_mma": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _P), _I),
    "mmrs_topk_scan_q8": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
                          _I),
    "mmrs_topk_scan_q4": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                           _P), _I),
    "mmrs_mlp_int8_geometry": ((_I,), _I),
    "mmrs_mlp_int8": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _I, _I, _I, _I, _I, _I, _P), _I),
    "mmrs_probe_scan": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                         _P, _P), _I),
    "mmrs_probe_scan_q4": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _P, _P, _P), _I),
    "mmrs_probe_ids": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P), _I),
    "mmrs_first_match_geometry": ((_I,), _I),
    "mmrs_split_bf16x3": ((_P, _P, _LL, _P), _I),
    "mmrs_first_match": ((_P, _P, _I, _I, _I, _F, _I, _LL, _LL, _I, _P, _P),
                         _I),
    "mmrs_decode_attention": ((_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                               _I, _LL, _LL, _LL, _LL, _I, _F, _I, _I, _I, _I,
                               _P), _I),
    "mmrs_decode_slots": ((_I, _I, _I, _I), _I),
    "mmrs_chunk_attention": ((_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                              _I, _I, _LL, _LL, _LL, _LL, _I, _F, _I, _I, _P),
                             _I),
    "mmrs_bias_act_slots": ((_I, _I), _I),
    "mmrs_bias_act": ((_P, _P, _P, _LL, _I, _I, _I, _I, _P), _I),
    "mmrs_layer_norm_slots": ((_I, _I), _I),
    "mmrs_layer_norm": ((_P, _LL, _P, _P, _I, _P, _LL, _I, _F, _I, _I, _P),
                        _I),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels build only where "
        "the CUDA toolkit is installed")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libmmrs_kernels_{_source_hash()}.so")


def build() -> float:
    """Compile the CUDA sources if the current library is missing; returns
    the seconds spent (0.0 when it was already built). The compilers'
    output (`-Xptxas -v`: registers, shared memory, spills per kernel) is
    kept beside the library as `<name>.log`."""
    path = library_path()
    if os.path.exists(path):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in CUDA_SOURCES:
        obj = f"{tmp}.{src}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj,
               os.path.join(CSRC_DIR, src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:            # wait for every compiler
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    seconds = time.perf_counter() - t0
    with open(path[:-3] + ".log", "w", encoding="utf-8") as f:
        f.write("\n".join(log))
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)
    return seconds


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    build()
    lib = ctypes.CDLL(library_path())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().mmrs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The handle of t's device's current stream: the raw query, as torch's
    own kernel launchers make it (a `torch.cuda.current_stream` object
    costs ~5 us of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


@lru_cache(maxsize=None)
def triton_module(name: str):
    """Load `csrc/<name>.py` (a Triton kernel source) as a module."""
    mod_name = f"mmrs_tpu_torch_csrc_{name}"
    spec = importlib.util.spec_from_file_location(
        mod_name, os.path.join(CSRC_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod   # Triton reads the kernel's source back
    spec.loader.exec_module(mod)
    return mod


def takes_kernel(impl: str, x: torch.Tensor) -> bool:
    """The one route rule of every op that takes `impl`: "auto" runs the
    kernel on a CUDA tensor and the plain PyTorch version elsewhere,
    "torch" the plain version anywhere; any other value raises
    ValueError. An op adds its own conditions on its inputs (dtype, shape,
    autograd) after this."""
    if impl in ("auto", "torch"):
        return impl == "auto" and x.device.type == "cuda"
    raise ValueError(f"unknown impl {impl!r}")


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd records an op on these tensors (a training step)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """A kernel's output has no autograd history: its launch writes a fresh
    tensor through raw pointers. So a kernel refuses (RuntimeError) to run
    under grad mode on a floating input that requires grad, where it would
    silently cut the graph and leave those inputs' gradients at zero.
    Training takes the plain route (`impl="torch"`).
    None entries (absent scales) are skipped."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and t.requires_grad):
            raise RuntimeError(
                f"{name}: the kernel does not record autograd history, and "
                f"an input requires grad; run the plain route "
                f"(impl='torch') to train, or call under torch.no_grad()")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Kernel inputs must all lie on one CUDA device and be contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {dev}")
