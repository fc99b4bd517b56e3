"""ctypes bindings for the native governance core (csrc/govern_core.cpp).

Counterpart of mmrs_tpu/govern/native.py. The shared library is built with
g++ on first use (~1 s) from the port's own copy of the source into
`mmrs_tpu_torch/_build/`, named by a hash of the source and flags, through
a temporary file and a rename, so that concurrent processes may race and a
source edit never runs an old library. Every entry point has a numpy
fallback (host code either way), so the package works without a toolchain;
the native path is the performance tier for million-file galleries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mmrs_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "govern_core.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmmrs_govern_{h.hexdigest()[:16]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """The native library (built first if needed), or None when it cannot
    be built or loaded: then the numpy fallbacks run."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not os.path.exists(so):
        try:
            _build(so)
        except Exception as e:  # noqa: BLE001
            log.warning("native build failed, using numpy fallback: %r", e)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        log.warning("native load failed: %r", e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.md5_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_char_p]
    lib.md5_files.argtypes = [ctypes.c_char_p, i64p, ctypes.c_int64,
                              u8p, u8p, ctypes.c_int]
    lib.md5_files.restype = ctypes.c_int64
    lib.hamming_first_match.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int, i64p, ctypes.c_int]
    lib.hamming_first_match.restype = None
    lib.hamming_cross_any.argtypes = [u64p, u64p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int, i64p, ctypes.c_int]
    lib.hamming_cross_any.restype = None
    _LIB = lib
    return lib


def md5_buffer(data: bytes) -> str:
    lib = load_library()
    if lib is None:
        return hashlib.md5(data).hexdigest()
    out = ctypes.create_string_buffer(16)
    lib.md5_buffer(data, len(data), out)
    return out.raw.hex()


def md5_files(paths: Sequence[str], threads: int = 0
              ) -> Tuple[List[str], np.ndarray]:
    """Thread-pool MD5 of file contents. Returns (hex digests, ok mask);
    failed reads get an empty string."""
    lib = load_library()
    if lib is None:
        hexes, ok = [], np.zeros(len(paths), bool)
        for i, p in enumerate(paths):
            try:
                with open(p, "rb") as f:
                    hexes.append(hashlib.md5(f.read()).hexdigest())
                ok[i] = True
            except OSError:
                hexes.append("")
        return hexes, ok

    # os.fsencode, not str.encode: non-UTF8 filenames arrive from
    # os.listdir as surrogate-escaped str and must round-trip to the
    # original bytes (str.encode raises and would abort the whole batch)
    encoded = [os.fsencode(p) for p in paths]
    blob = b"".join(e + b"\0" for e in encoded)
    offsets = np.zeros(len(paths), np.int64)
    pos = 0
    for i, e in enumerate(encoded):
        offsets[i] = pos
        pos += len(e) + 1
    out = np.zeros((len(paths), 16), np.uint8)
    ok = np.zeros(len(paths), np.uint8)
    lib.md5_files(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads,
    )
    hexes = [out[i].tobytes().hex() if ok[i] else "" for i in range(len(paths))]
    return hexes, ok.astype(bool)


def hamming_first_match(
    hashes: np.ndarray,       # [H, N] uint64 (kind-major)
    threshold: int = 5,
    threads: int = 0,
) -> np.ndarray:
    """Keep-first duplicate scan: out[i] = first j < i with ANY kind within
    `threshold`, else -1. Native threaded early-exit scan, or a numpy
    block fallback."""
    hashes = np.ascontiguousarray(hashes, np.uint64)
    h, n = hashes.shape
    lib = load_library()
    if lib is not None:
        out = np.empty(n, np.int64)
        lib.hamming_first_match(
            hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            h, n, threshold,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            threads,
        )
        return out

    from mmrs_tpu_torch.govern.hashing import packed_hamming

    out = np.full(n, -1, np.int64)
    block = 1024
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        dup = np.zeros((i1 - i0, i1), bool)
        for k in range(h):
            dup |= packed_hamming(hashes[k, i0:i1], hashes[k, :i1]) <= threshold
        for r in range(i1 - i0):
            i = i0 + r
            cand = np.nonzero(dup[r, :i])[0]
            if cand.size:
                out[i] = cand[0]
    return out


def hamming_cross_any(
    a: np.ndarray,            # [H, NA] uint64
    b: np.ndarray,            # [H, NB] uint64
    threshold: int = 0,
    threads: int = 0,
) -> np.ndarray:
    """out[i] = first row of b with ANY kind within threshold, else -1."""
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    h, na = a.shape
    _, nb = b.shape
    lib = load_library()
    if lib is not None:
        out = np.empty(na, np.int64)
        lib.hamming_cross_any(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            h, na, nb, threshold,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            threads,
        )
        return out

    from mmrs_tpu_torch.govern.hashing import packed_hamming

    out = np.full(na, -1, np.int64)
    hit = np.zeros((na, nb), bool)
    for k in range(h):
        hit |= packed_hamming(a[k], b[k]) <= threshold
    for i in range(na):
        cand = np.nonzero(hit[i])[0]
        if cand.size:
            out[i] = cand[0]
    return out
