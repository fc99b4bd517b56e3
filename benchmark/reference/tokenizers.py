"""Frozen copies of the two tokenizers the text towers take.

`ClipBpe` is OpenAI CLIP's lowercased byte-level BPE (`clip.tokenize`,
truncate=True): <|startoftext|> ... <|endoftext|> in a fixed row of
`context_length` ids, zero padded. `WordPiece` is BERT's (the Taiyi
tower's `BertTokenizer`): the basic tokenizer (control characters
dropped, lowercase, accents stripped, CJK characters and punctuation
split), greedy longest-match WordPiece, [CLS] ... [SEP] framing, an
attention mask. Both follow the published algorithms and take their
vocabulary from the benchmark (a merges list, a token -> id dict).
"""

from __future__ import annotations

import html
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

_PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")


def byte_to_unicode() -> Dict[int, str]:
    """GPT-2 / CLIP's reversible map of the 256 bytes to printable
    characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    extra = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + extra)
            extra += 1
    return dict(zip(bs, map(chr, cs)))


class ClipBpe:
    def __init__(self, merges: Sequence[Tuple[str, str]],
                 context_length: int = 77):
        import regex

        self.byte_map = byte_to_unicode()
        units = list(self.byte_map.values())
        vocab = units + [u + "</w>" for u in units]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.sot = self.ids["<|startoftext|>"]
        self.eot = self.ids["<|endoftext|>"]
        self.context_length = context_length
        self.pattern = regex.compile(_PATTERN, regex.IGNORECASE)
        self.space = regex.compile(r"\s+")
        self.memo: Dict[str, List[str]] = {}

    def _merge(self, token: str) -> List[str]:
        if token in ("<|startoftext|>", "<|endoftext|>"):
            return [token]
        if token in self.memo:
            return self.memo[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == best[0]
                        and word[i + 1] == best[1]):
                    merged.append(best[0] + best[1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self.memo[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text)).strip()
        text = self.space.sub(" ", text).strip().lower()
        out: List[int] = []
        for token in self.pattern.findall(text):
            token = "".join(self.byte_map[b] for b in token.encode("utf-8"))
            out += [self.ids[piece] for piece in self._merge(token)]
        return out

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [B, context_length] int32, mask of the ids in use)."""
        n = self.context_length
        ids = np.zeros((len(texts), n), np.int32)
        for r, text in enumerate(texts):
            row = [self.sot] + self.encode(text) + [self.eot]
            if len(row) > n:
                row = row[:n - 1] + [self.eot]
            ids[r, :len(row)] = row
        mask = np.zeros_like(ids)
        for r in range(len(texts)):
            mask[r, :int(np.argmax(ids[r])) + 1] = 1
        return ids, mask


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


class WordPiece:
    def __init__(self, vocab: Dict[str, int], max_length: int = 64):
        self.vocab = vocab
        self.max_length = max_length
        self.unk = vocab.get("[UNK]", 0)
        self.cls = vocab.get("[CLS]", 1)
        self.sep = vocab.get("[SEP]", 2)
        self.pad = vocab.get("[PAD]", 0)

    def words(self, text: str) -> List[str]:
        kept = []
        for ch in text:
            if ch.isspace():
                kept.append(" ")
            elif (ord(ch) not in (0, 0xFFFD)
                  and not unicodedata.category(ch).startswith("C")):
                kept.append(ch)
        text = unicodedata.normalize("NFD", "".join(kept).lower())
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
        out, cur = [], ""
        for ch in text:
            if _is_cjk(ord(ch)) or _is_punctuation(ch):
                out += [cur] if cur else []
                out.append(ch)
                cur = ""
            elif ch.isspace():
                out += [cur] if cur else []
                cur = ""
            else:
                cur += ch
        return out + ([cur] if cur else [])

    def pieces(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk]
        out, start = [], 0
        while start < len(word):
            end, found = len(word), None
            while start < end:
                sub = ("##" if start else "") + word[start:end]
                if sub in self.vocab:
                    found = self.vocab[sub]
                    break
                end -= 1
            if found is None:
                return [self.unk]
            out.append(found)
            start = end
        return out

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [B, max_length] int32, attention mask [B, max_length])."""
        n = self.max_length
        ids = np.full((len(texts), n), self.pad, np.int32)
        mask = np.zeros((len(texts), n), np.int32)
        for r, text in enumerate(texts):
            body = [i for w in self.words(text) for i in self.pieces(w)]
            row = [self.cls] + body[:n - 2] + [self.sep]
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
        return ids, mask
