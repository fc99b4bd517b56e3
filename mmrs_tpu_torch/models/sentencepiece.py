"""Minimal SentencePiece reader + SP-BPE tokenizer (no sentencepiece dep).

The LLaVA verifier's text side uses the LLaMA tokenizer, a SentencePiece
BPE model (`tokenizer.model`). The `sentencepiece` package is not available
in this build environment, so this module parses the serialized ModelProto
directly (a two-field subset: the pieces list and their scores) and
implements the SP-BPE encode/decode algorithm:

  - normalization: spaces -> U+2581 (▁), dummy-prefix ▁ prepended;
  - greedy best-score merging: repeatedly merge the adjacent pair whose
    concatenation is in the vocab with the highest score;
  - byte fallback for unknown characters (<0xXX> pieces, LLaMA-style);
  - decode reverses pieces -> text (▁ -> space, byte pieces -> bytes).

Satisfies the `encode(text) -> List[int]` / `decode(ids) -> str` protocol
of cascade.verifier.LLaVAVerifier (a copy of
mmrs_tpu/models/sentencepiece.py: the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

SPACE = "▁"  # ▁


# --------------------------------------------------------------------------
# Protobuf wire-format subset
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _walk_fields(buf: bytes):
    """Yield (field_number, wire_type, value_bytes_or_int)."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


@dataclass
class Piece:
    text: str
    score: float
    type: int  # 1 NORMAL, 2 UNKNOWN, 3 CONTROL, 6 BYTE


@dataclass
class ModelSpec:
    """The normalizer/trainer options that affect encode semantics.

    Defaults match LLaMA's tokenizer.model (add_dummy_prefix=True,
    remove_extra_whitespaces=False, byte_fallback=True)."""

    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2


def parse_model(data: bytes) -> List[Piece]:
    """Extract the pieces list from a serialized sentencepiece ModelProto."""
    return parse_model_full(data)[0]


def parse_model_full(data: bytes) -> Tuple[List[Piece], ModelSpec]:
    """Pieces + the encode-relevant subset of TrainerSpec/NormalizerSpec.

    Field numbers per sentencepiece_model.proto: ModelProto{pieces=1,
    trainer_spec=2, normalizer_spec=3}; SentencePiece{piece=1, score=2,
    type=3}; NormalizerSpec{add_dummy_prefix=3, remove_extra_whitespaces=4};
    TrainerSpec{unk_id=40, bos_id=41, eos_id=42}."""
    import struct

    pieces: List[Piece] = []
    spec = ModelSpec()
    for field, wire, val in _walk_fields(data):
        if field == 1 and wire == 2:  # repeated SentencePiece
            text, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _walk_fields(val):
                if f2 == 1 and w2 == 2:
                    text = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append(Piece(text, score, ptype))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f2, w2, v2 in _walk_fields(val):
                if w2 != 0:
                    continue
                if f2 == 40:
                    spec.unk_id = v2
                elif f2 == 41:
                    spec.bos_id = v2
                elif f2 == 42:
                    spec.eos_id = v2
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f2, w2, v2 in _walk_fields(val):
                if w2 != 0:
                    continue
                if f2 == 3:
                    spec.add_dummy_prefix = bool(v2)
                elif f2 == 4:
                    spec.remove_extra_whitespaces = bool(v2)
    return pieces, spec


def serialize_model(pieces: List[Piece]) -> bytes:
    """Inverse of parse_model (tests build tiny models with it)."""
    import struct

    def varint(x: int) -> bytes:
        out = b""
        while True:
            b7 = x & 0x7F
            x >>= 7
            if x:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    blob = b""
    for p in pieces:
        body = b"\x0a" + varint(len(p.text.encode())) + p.text.encode()
        body += b"\x15" + struct.pack("<f", p.score)
        body += b"\x18" + varint(p.type)
        blob += b"\x0a" + varint(len(body)) + body
    return blob


# --------------------------------------------------------------------------
# SP-BPE tokenizer
# --------------------------------------------------------------------------

class SentencePieceBPE:
    def __init__(self, pieces: List[Piece], add_bos: bool = True,
                 add_dummy_prefix: bool = True,
                 remove_extra_whitespaces: bool = False):
        self.pieces = pieces
        self.vocab: Dict[str, int] = {p.text: i for i, p in enumerate(pieces)}
        # Control/unknown pieces are never produced by merging raw text
        # (sentencepiece matches them only as user-defined/control symbols),
        # so they are excluded from the merge-score table.
        self.scores = {p.text: p.score for p in pieces
                       if p.type not in (2, 3)}
        self.add_bos = add_bos
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.unk_id = next(
            (i for i, p in enumerate(pieces) if p.type == 2), 0)
        self.bos_id = self.vocab.get("<s>", 1)
        self.eos_id = self.vocab.get("</s>", 2)
        self.byte_ids = {
            i: int(p.text[1:-1], 16)
            for i, p in enumerate(pieces) if p.type == 6
        }
        self.byte_piece = {v: k for k, v in self.byte_ids.items()}

    @classmethod
    def from_file(cls, path: str, **kw) -> "SentencePieceBPE":
        """Load a real tokenizer.model; normalizer options (dummy prefix,
        whitespace handling) come from the file's NormalizerSpec unless
        overridden by kwargs."""
        with open(path, "rb") as f:
            pieces, spec = parse_model_full(f.read())
        kw.setdefault("add_dummy_prefix", spec.add_dummy_prefix)
        kw.setdefault("remove_extra_whitespaces", spec.remove_extra_whitespaces)
        tok = cls(pieces, **kw)
        if 0 <= spec.unk_id < len(pieces):
            tok.unk_id = spec.unk_id
        if 0 <= spec.bos_id < len(pieces):
            tok.bos_id = spec.bos_id
        if 0 <= spec.eos_id < len(pieces):
            tok.eos_id = spec.eos_id
        return tok

    def _encode_symbols(self, symbols: List[str]) -> List[int]:
        """Greedy highest-score adjacent-pair merging (SP BPE)."""
        while len(symbols) > 1:
            best_i, best_score = -1, -float("inf")
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                s = self.scores.get(merged)
                if s is not None and s > best_score:
                    best_i, best_score = i, s
            if best_i < 0:
                break
            symbols = (symbols[:best_i] + [symbols[best_i] + symbols[best_i + 1]]
                       + symbols[best_i + 2:])
        ids: List[int] = []
        for sym in symbols:
            if sym in self.vocab:
                ids.append(self.vocab[sym])
            else:
                # byte fallback per utf-8 byte; unk if no byte pieces
                if self.byte_piece:
                    ids.extend(self.byte_piece[b] for b in sym.encode("utf-8"))
                else:
                    ids.append(self.unk_id)
        return ids

    def encode(self, text: str, add_bos: bool | None = None) -> List[int]:
        if self.remove_extra_whitespaces:
            # SP's remove_extra_whitespaces: trim ends, collapse runs.
            import re

            text = re.sub(" +", " ", text).strip(" ")
        if self.add_dummy_prefix and text:
            # sentencepiece prepends the dummy prefix UNCONDITIONALLY
            # (normalizer.cc), even when the text already starts with a
            # space — " hi" tokenizes as "▁▁hi".
            text = " " + text
        text = text.replace(" ", SPACE)
        ids = self._encode_symbols(list(text))
        bos = self.add_bos if add_bos is None else add_bos
        return ([self.bos_id] + ids) if bos else ids

    def decode(self, ids) -> str:
        out: List[str] = []
        byte_buf: List[int] = []

        def flush_bytes():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if i in (self.bos_id, self.eos_id):
                continue
            if i in self.byte_ids:
                byte_buf.append(self.byte_ids[i])
                continue
            flush_bytes()
            if 0 <= i < len(self.pieces):
                p = self.pieces[i]
                if p.type in (3,):  # control
                    continue
                out.append(p.text)
        flush_bytes()
        text = "".join(out).replace(SPACE, " ")
        return text[1:] if text.startswith(" ") else text
