"""Exact and perceptual image hashing.

Native re-implementations of the hashes the reference gets from `imagehash`
(not available here) plus its MD5 pixel hash:

  - exact_pixel_hash: MD5 over raw RGB bytes
    (tool/find_repeated.py:6-19 `calculate_image_hash`).
  - dhash: horizontal-gradient hash, resize (9, 8) grayscale
    (tool/delete repeated.py leakage removal uses dHash with Hamming <= 0,
    i.e. exact dHash match).
  - phash: 32x32 grayscale -> 2-D DCT-II -> top-left 8x8 block > median
    (imagehash.phash algorithm).
  - whash: Haar wavelet LL-band hash with max-level LL removal
    (imagehash.whash algorithm, hash_size 8).
  - ahash: mean hash (bonus; trivially available).

`compare_hashes` reproduces tool/find_repeated_in_same_folder.py:38-54:
two images are duplicates if ANY of (phash, dhash, whash) Hamming
distances <= threshold (default 5).

Hashes are returned as uint64 for vectorized Hamming math at scale
(packed_hamming below); hex round-trip provided for manifests.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
import numpy as np


def exact_pixel_hash(img) -> str:
    """MD5 of the raw RGB pixel bytes (decode-normalized, so recompressed
    copies with identical pixels match)."""
    return hashlib.md5(img.convert("RGB").tobytes()).hexdigest()


def _gray(img, size_wh) -> np.ndarray:
    from PIL import Image

    g = img.convert("L").resize(size_wh, Image.LANCZOS)
    return np.asarray(g, dtype=np.float64)


def _pack_bits(bits: np.ndarray) -> np.uint64:
    """Row-major bool array -> uint64 (MSB-first, 64 bits)."""
    flat = bits.flatten()
    assert flat.size == 64
    out = np.uint64(0)
    for b in flat:
        out = np.uint64(out << np.uint64(1)) | np.uint64(bool(b))
    return out


def ahash(img, hash_size: int = 8) -> np.uint64:
    pixels = _gray(img, (hash_size, hash_size))
    return _pack_bits(pixels > pixels.mean())


def dhash(img, hash_size: int = 8) -> np.uint64:
    # resize takes (width, height); imagehash uses (hash_size + 1, hash_size)
    pixels = _gray(img, (hash_size + 1, hash_size))
    return _pack_bits(pixels[:, 1:] > pixels[:, :-1])


def _dct2(x: np.ndarray) -> np.ndarray:
    """Orthonormal 2-D DCT-II (scipy.fftpack.dct(dct(x.T).T) equivalent)."""
    from scipy.fftpack import dct

    return dct(dct(x, axis=0), axis=1)


def phash(img, hash_size: int = 8, highfreq_factor: int = 4) -> np.uint64:
    size = hash_size * highfreq_factor
    pixels = _gray(img, (size, size))
    coeffs = _dct2(pixels)[:hash_size, :hash_size]
    med = np.median(coeffs)
    return _pack_bits(coeffs > med)


def _haar_dwt2(x: np.ndarray, levels: int) -> np.ndarray:
    """LL band after `levels` of a 2-D Haar transform (pywt 'haar' approx)."""
    ll = x.copy()
    for _ in range(levels):
        # rows
        a = (ll[:, 0::2] + ll[:, 1::2]) / np.sqrt(2.0)
        # cols
        ll = (a[0::2, :] + a[1::2, :]) / np.sqrt(2.0)
    return ll


def whash(img, hash_size: int = 8, remove_max_haar_ll: bool = True) -> np.uint64:
    """imagehash.whash: scale to a power-of-two square >= hash_size, Haar
    decompose to the hash_size level, optionally remove the global LL
    (max-level) component, threshold at the median."""
    image_natural_scale = 2 ** int(np.log2(min(img.size)))
    image_scale = max(image_natural_scale, hash_size)
    ll_max_level = int(np.log2(image_scale))
    level = int(np.log2(hash_size))
    dwt_level = ll_max_level - level

    pixels = _gray(img, (image_scale, image_scale)) / 255.0
    if remove_max_haar_ll:
        # imagehash zeroes the max-level LL coefficient and reconstructs;
        # with orthonormal Haar that equals subtracting the global mean.
        pixels = pixels - pixels.mean()
    ll = _haar_dwt2(pixels, dwt_level)
    ll = ll / (2.0 ** dwt_level)  # normalize like pywt's orthonormal output
    med = np.median(ll)
    return _pack_bits(ll > med)


def hamming(a: np.uint64, b: np.uint64) -> int:
    return int(bin(int(a) ^ int(b)).count("1"))


@dataclass
class PerceptualHashes:
    phash: np.uint64
    dhash: np.uint64
    whash: np.uint64

    def to_hex(self) -> dict:
        return {k: f"{int(getattr(self, k)):016x}" for k in ("phash", "dhash", "whash")}


def perceptual_hashes(img, hash_size: int = 8) -> PerceptualHashes:
    """The trio used by tool/find_repeated_in_same_folder.py:8-22."""
    return PerceptualHashes(
        phash=phash(img, hash_size),
        dhash=dhash(img, hash_size),
        whash=whash(img, hash_size),
    )


def compare_hashes(a: PerceptualHashes, b: PerceptualHashes,
                   threshold: int = 5) -> bool:
    """Duplicate if ANY of the three Hamming distances <= threshold
    (tool/find_repeated_in_same_folder.py:38-54)."""
    return (
        hamming(a.phash, b.phash) <= threshold
        or hamming(a.dhash, b.dhash) <= threshold
        or hamming(a.whash, b.whash) <= threshold
    )


# --------------------------------------------------------------------------
# Vectorized Hamming at scale
# --------------------------------------------------------------------------

_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def packed_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances between uint64 hash vectors.

    a [N], b [M] uint64 -> [N, M] uint8. Byte-table popcount; replaces the
    reference's O(N^2) Python loop over imagehash objects
    (tool/find_repeated_in_same_folder.py:83-87)."""
    ax = a[:, None] ^ b[None, :]
    view = ax.view(np.uint8).reshape(*ax.shape, 8)
    return _POPCNT[view].sum(axis=-1)
