"""Inputs of a vision-language cell made from the seed, besides its weights
(`weights.draw`): a SentencePiece vocabulary and the image files the
verifier reads.

The vocabulary and the sizes of the work come from a fixed generator, so
every seed runs the same prompts; pixels and weights come from the seed.
"""

from __future__ import annotations

import os
import re
import string
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Tuple

import numpy as np

from benchmark import data

Piece = Tuple[str, float, int]     # (text, score, type) in id order
SPACE = "▁"
PUNCTUATION = ".,?!:;'\"-()/"


def words_of(texts: Iterable[str]) -> List[str]:
    """The words of the texts, in order of first appearance."""
    seen: Dict[str, None] = {}
    for t in texts:
        for w in re.findall(r"[A-Za-z0-9]+", t):
            seen.setdefault(w, None)
    return list(seen)


def sentencepiece_vocab(size: int, texts: Iterable[str]) -> List[Piece]:
    """A synthetic LLaMA-style SentencePiece BPE vocabulary of exactly
    `size` pieces: <unk> <s> </s>, the 256 byte pieces <0x00>..<0xFF>,
    single characters, then for every word of `texts` the chains of its
    prefixes with and without the leading U+2581 (so that each word is
    one piece, as common English words are), and chains of random
    lowercase words to fill. Scores fall with the id, as in a trained
    model; merging is then deterministic."""
    pieces: Dict[str, int] = {}

    def add(text: str, kind: int = 1) -> None:
        if len(pieces) < size and text not in pieces:
            pieces[text] = kind

    add("<unk>", 2)
    add("<s>", 3)
    add("</s>", 3)
    for b in range(256):
        add(f"<0x{b:02X}>", 6)
    for ch in SPACE + string.ascii_letters + string.digits + PUNCTUATION:
        add(ch)

    def chains(word: str, spaced: bool) -> None:
        lead = SPACE if spaced else ""
        for k in range(1, len(word) + 1):
            add(lead + word[:k])

    for word in words_of(texts):
        chains(word, True)
        chains(word, False)
    r = data.rng(data.FIXED)
    letters = np.array(list(string.ascii_lowercase))
    while len(pieces) < size:
        chains("".join(r.choice(letters, size=int(r.integers(3, 11)))), True)
    return [(text, -float(i), kind)
            for i, (text, kind) in enumerate(pieces.items())]


def write_pngs(pool: np.ndarray, folder: str, level: int,
               threads: int = 4) -> List[str]:
    """Each pool image as a lossless PNG under `folder` (zlib `level`);
    returns the paths in pool order."""
    from PIL import Image

    paths = [os.path.join(folder, f"{i:05d}.png") for i in range(len(pool))]

    def save(i: int) -> None:
        Image.fromarray(pool[i]).save(paths[i], compress_level=level)

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(save, range(len(pool))))
    return paths
