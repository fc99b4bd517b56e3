"""Inputs made from the seed: images, texts, vocabularies and galleries.

Sizes and arrival gaps that decide how much work a run does are drawn
from a fixed generator and only their order from the run's seed, so every
seed gives the same work in another order. Contents (pixels, words,
gallery rows, weights) come from the seed.
"""

from __future__ import annotations

import dataclasses
import string
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from mmrs_tpu_torch.io.dataset import Batch

FIXED = 20240601            # the draw of sizes, gaps and vocabularies
PLANT_SIGMAS = (0.25, 1.25)  # noise of a query's planted rows, near to far


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# -- vocabularies ------------------------------------------------------------

def clip_merges(n_merges: int) -> Tuple[List[Tuple[str, str]], List[str]]:
    """A synthetic CLIP merges list of exactly `n_merges` entries (the
    published vocabulary size less the 512 byte units and 2 markers): the
    left-to-right merges of random lowercase words, and those words."""
    r = rng(FIXED)
    letters = np.array(list(string.ascii_lowercase))
    merges: List[Tuple[str, str]] = []
    seen = set()
    words: List[str] = []
    while len(merges) < n_merges:
        word = "".join(r.choice(letters, size=int(r.integers(3, 11))))
        units = list(word[:-1]) + [word[-1] + "</w>"]
        while len(units) > 1 and len(merges) < n_merges:
            pair = (units[0], units[1])
            if pair not in seen:
                seen.add(pair)
                merges.append(pair)
            units = [pair[0] + pair[1]] + units[2:]
        words.append(word)
    return merges, words


def wordpiece_vocab(size: int) -> Tuple[Dict[str, int], List[str]]:
    """A synthetic BERT-Chinese vocabulary of exactly `size` entries: [PAD],
    unused slots, [UNK] [CLS] [SEP] [MASK] at 100-103 as in
    bert-base-chinese, then CJK characters from U+4E00; and those
    characters."""
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = [chr(0x4E00 + i) for i in range(size - len(tokens))]
    return {t: i for i, t in enumerate(tokens + chars)}, chars


# -- texts -------------------------------------------------------------------

def lengths(n: int, lo: int, hi: int, tail: float) -> np.ndarray:
    """n lengths in [lo, hi] with P(L) proportional to L^-tail (a heavy
    tail of long queries), drawn from the fixed generator."""
    support = np.arange(lo, hi + 1)
    p = support.astype(float) ** -tail
    return rng(FIXED).choice(support, size=n, p=p / p.sum())


def texts(n: int, units: Sequence[str], lo: int, hi: int, tail: float,
          sep: str, seed: int) -> List[str]:
    """n texts of `lo`..`hi` units (words joined by spaces, or characters)
    drawn from the seed."""
    r = rng(seed)
    pool = np.asarray(units)
    return [sep.join(r.choice(pool, size=int(m))) for m in
            r.permutation(lengths(n, lo, hi, tail))]


# -- images ------------------------------------------------------------------

def image_pool(n: int, size: int, seed: int, device,
               chunk: int = 512) -> np.ndarray:
    """n distinct uint8 [size, size, 3] images on the host, made on the
    device: a colour, a smooth random field and pixel noise, each with its
    own strength, so that images differ in more than their noise."""
    gen = device_generator(seed, device)
    out = np.empty((n, size, size, 3), np.uint8)
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        colour = torch.rand((m, 3, 1, 1), generator=gen, device=device) * 255
        amp = 20 + 80 * torch.rand((m, 1, 1, 1), generator=gen, device=device)
        field = torch.nn.functional.interpolate(
            torch.randn((m, 3, 8, 8), generator=gen, device=device),
            size=(size, size), mode="bilinear", align_corners=False)
        grain = 40 * torch.rand((m, 1, 1, 1), generator=gen, device=device)
        noise = torch.randn((m, 3, size, size), generator=gen, device=device)
        img = (colour + amp * field + grain * noise).clamp(0, 255)
        out[a:a + m] = img.round().to(torch.uint8).permute(0, 2, 3,
                                                           1).cpu().numpy()
    return out


@dataclasses.dataclass
class Samples:
    """(path, class) of the stream's images, made when asked for: a path
    names the pool image a row was made from."""
    pool_ids: np.ndarray
    start: int = 0
    stop: int = 1 << 62

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, i):
        if isinstance(i, slice):
            a, b, _ = i.indices(len(self))
            return Samples(self.pool_ids, self.start + a, self.start + b)
        n = self.start + i
        p = int(self.pool_ids[n % len(self.pool_ids)])
        return f"pool/{p:05d}/{n}.png", f"c{p % 16}"


@dataclasses.dataclass
class ImageStream:
    """Decoded images as a data loader hands them over, batch after batch,
    until `deadline` (a perf_counter time). Batches are contiguous slices
    of the pool (no copy), in an order drawn from the seed."""
    samples: Samples
    pool: np.ndarray
    deadline: float = float("inf")
    tick: Callable[[], None] = lambda: None   # called before each batch
    # shared with the copy build_index makes (dataclasses.replace)
    yielded: List[int] = dataclasses.field(default_factory=lambda: [0])

    def batches(self, batch_size: int):
        ids = self.samples.pool_ids
        i = 0
        while time.perf_counter() < self.deadline and i < len(self.samples):
            self.tick()
            first = self.samples.start + i
            p = int(ids[first % len(ids)])
            meta = [self.samples[i + j] for j in range(batch_size)]
            yield Batch(pixels=self.pool[p:p + batch_size],
                        labels=[c for _, c in meta],
                        paths=[path for path, _ in meta],
                        ok=np.ones(batch_size, bool))
            i += batch_size
            self.yielded[0] += batch_size


def stream_ids(n_pool: int, batch: int, seed: int) -> np.ndarray:
    """Pool image of each stream row, batch by batch: each batch a
    contiguous run of the pool, a cycle of every run in seeded order."""
    runs = rng(seed).permutation(n_pool // batch) * batch
    return (runs[:, None] + np.arange(batch)[None, :]).reshape(-1)


# -- galleries ---------------------------------------------------------------

def gallery(rows: int, dim: int, clusters: int, spread: float,
            anchors: torch.Tensor, per_anchor: int, seed: int, device,
            block: int = 1 << 18) -> Tuple[np.ndarray, np.ndarray]:
    """A clustered gallery of L2-normalized rows on the host (float16, as
    an index stores them), made on the device: each row a random cluster
    centre plus noise of norm about `spread`. Each anchor (a query's
    reference embedding) gets `per_anchor` rows planted at seeded places,
    from near to far. Returns (rows [N, D] float16, planted row ids
    [anchors, per_anchor])."""
    gen = device_generator(seed, device)
    centres = torch.nn.functional.normalize(
        torch.randn((clusters, dim), generator=gen, device=device), dim=1)
    out = np.empty((rows, dim), np.float16)
    host = torch.from_numpy(out)
    for a in range(0, rows, block):
        m = min(block, rows - a)
        pick = torch.randint(0, clusters, (m,), generator=gen, device=device)
        noise = torch.randn((m, dim), generator=gen, device=device)
        g = centres[pick] + noise * (spread / dim ** 0.5)
        host[a:a + m] = torch.nn.functional.normalize(g, dim=1).half().cpu()
    n_a = anchors.shape[0]
    where = torch.randperm(rows, generator=gen, device=device)[
        :n_a * per_anchor].reshape(n_a, per_anchor)
    sig = torch.linspace(*PLANT_SIGMAS, per_anchor, device=device)
    noise = torch.randn((n_a, per_anchor, dim), generator=gen, device=device)
    planted = torch.nn.functional.normalize(
        anchors.float()[:, None, :] + noise * (sig[None, :, None]
                                               / dim ** 0.5), dim=2)
    where_np = where.cpu().numpy()
    out[where_np.reshape(-1)] = planted.half().reshape(-1, dim).cpu().numpy()
    return out, where_np


class RowNames:
    """The path of gallery row r, made when asked for ("r<r>")."""

    def __init__(self, n: int, value: str = ""):
        self.n, self.value = n, value

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, r):
        if isinstance(r, slice):
            return [self[i] for i in range(*r.indices(self.n))]
        if not -self.n <= r < self.n:
            raise IndexError(r)
        return self.value or f"r{r % self.n}"


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson stream at `rate`
    over `seconds`: round(rate * seconds) exponential gaps from the fixed
    generator, scaled to end at `seconds`, in an order drawn from the
    seed."""
    n = max(1, int(round(rate * seconds)))
    gaps = rng(FIXED).exponential(1.0 / rate, n)
    gaps *= seconds / gaps.sum()
    return np.cumsum(rng(seed).permutation(gaps))
