"""Tokenizers for the text towers — full algorithm implementations.

  - CLIPTokenizer: the OpenAI CLIP byte-level BPE (`clip.tokenize`,
    code/test_clip.py:8, CLIP/lab1.py:56). Loads the standard
    `bpe_simple_vocab_16e6.txt(.gz)` merges file when available; a tiny
    synthetic merges list is enough for tests. Produces the fixed
    [B, context_length] int32 layout with <|startoftext|> ... <|endoftext|>
    and zero padding, truncating at context_length with EOT preserved —
    matching clip.tokenize(truncate=True).
  - BertWordPieceTokenizer: the Taiyi Chinese tower's tokenizer
    (BertTokenizer vocab.txt; code/test_taiyi.py:20). Basic tokenizer with
    CJK-character splitting + greedy longest-match WordPiece, [CLS]/[SEP]
    framing and attention masks.

No pretrained files are bundled (zero-egress build environment): point
`from_file`/`from_vocab_file` at the standard artifacts at deploy time.
"""

from __future__ import annotations

import gzip
import html
import unicodedata
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@lru_cache()
def _re():
    """The third-party `regex` module (it has the \\p{L}/\\p{N} classes the
    CLIP pattern needs), imported on first use so that importing this
    module does not need it."""
    import regex

    return regex


_PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""")


@lru_cache()
def _pattern():
    return _re().compile(_PATTERN, _re().IGNORECASE)


# --------------------------------------------------------------------------
# CLIP BPE
# --------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    # The reference stack also runs ftfy.fix_text; unavailable here — html
    # unescape (twice, as clip does) covers the common artifacts.
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return _re().sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """CLIP's lowercased byte-level BPE with <|startoftext|>/<|endoftext|>."""

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 context_length: int = 77):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_file(cls, path: str, context_length: int = 77) -> "CLIPTokenizer":
        """Load the standard CLIP merges file (plain or .gz)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # Standard file layout: header line, then merges 1..49152-256-2+1
        merges = [tuple(m.split()) for m in lines[1:49152 - 256 - 2 + 1]]
        merges = [m for m in merges if len(m) == 2]
        return cls(merges, context_length)

    @classmethod
    def synthetic(cls, words: Iterable[str] = (), context_length: int = 77
                  ) -> "CLIPTokenizer":
        """Tiny tokenizer for tests: merges that join the characters of the
        given words pair-by-pair (left fold)."""
        merges: List[Tuple[str, str]] = []
        seen = set()
        for w in words:
            units = [c for c in w[:-1]] + [w[-1] + "</w>"]
            while len(units) > 1:
                pair = (units[0], units[1])
                if pair not in seen:
                    seen.add(pair)
                    merges.append(pair)
                units = ["".join(pair)] + units[2:]
        return cls(merges, context_length)

    # -- core ------------------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _pattern().findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        # Padding is trailing zeros AFTER the first EOT (id 0 is the real BPE
        # token '!'), so stop at EOT positionally instead of filtering id 0.
        toks = [int(t) for t in tokens]
        if self.eot in toks:
            toks = toks[: toks.index(self.eot)]
        text = "".join(self.decoder[t] for t in toks if t != self.sot)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts, truncate: bool = True) -> np.ndarray:
        """clip.tokenize contract: [B, context_length] int32, zero padded."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > self.context_length:
                if not truncate:
                    raise ValueError(
                        f"input too long for context {self.context_length}"
                    )
                tokens = tokens[: self.context_length]
                tokens[-1] = self.eot
            result[i, : len(tokens)] = tokens
        return result


# --------------------------------------------------------------------------
# BERT WordPiece (Taiyi Chinese text tower)
# --------------------------------------------------------------------------

def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BertWordPieceTokenizer:
    """Lowercasing basic tokenizer + greedy WordPiece (BertTokenizer)."""

    def __init__(self, vocab: Dict[str, int], max_length: int = 64,
                 do_lower_case: bool = True):
        self.vocab = vocab
        self.ids_to_tokens = {v: k for k, v in vocab.items()}
        self.max_length = max_length
        self.do_lower_case = do_lower_case
        self.unk = vocab.get("[UNK]", 0)
        self.cls = vocab.get("[CLS]", 1)
        self.sep = vocab.get("[SEP]", 2)
        self.pad = vocab.get("[PAD]", 0)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "BertWordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    def basic_tokenize(self, text: str) -> List[str]:
        # HF BasicTokenizer._clean_text: drop NUL/replacement/control
        # chars; whitespace (incl. \t\n\r, which ARE category Cc) maps
        # to " " — the isspace test must run before the control filter
        cleaned: List[str] = []
        for ch in text:
            if ch.isspace():
                cleaned.append(" ")
            elif (ord(ch) not in (0, 0xFFFD)
                  and not unicodedata.category(ch).startswith("C")):
                cleaned.append(ch)
        text = "".join(cleaned)
        if self.do_lower_case:
            # HF: lowercase + strip accents (strip_accents defaults to
            # None, which means "strip when lowercasing"): NFD then drop
            # combining marks — "café" must tokenize like "cafe"
            text = unicodedata.normalize("NFD", text.lower())
            text = "".join(ch for ch in text
                           if unicodedata.category(ch) != "Mn")
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                out.append("".join(buf))
                buf.clear()

        for ch in text:
            cp = ord(ch)
            if _is_cjk(cp) or _is_punct(ch):
                flush()
                out.append(ch)
            elif ch.isspace():
                flush()
            else:
                buf.append(ch)
        flush()
        return out

    def wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            # HF WordpieceTokenizer.max_input_chars_per_word
            return [self.unk]
        if word in self.vocab:
            return [self.vocab[word]]
        tokens: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            tokens.append(cur)
            start = end
        return tokens

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in self.basic_tokenize(text):
            ids.extend(self.wordpiece(word))
        return ids

    def __call__(self, texts, max_length: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (input_ids [B, T], attention_mask [B, T]) int32,
        [CLS] ... [SEP] framed, zero padded."""
        if isinstance(texts, str):
            texts = [texts]
        ml = max_length or self.max_length
        ids = np.full((len(texts), ml), self.pad, np.int32)
        mask = np.zeros((len(texts), ml), np.int32)
        for i, text in enumerate(texts):
            toks = [self.cls] + self.encode(text)[: ml - 2] + [self.sep]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return ids, mask
