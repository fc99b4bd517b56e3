"""A frozen copy of SentencePiece's BPE encoding, as LLaMA and Mistral use it.

The text gets the dummy prefix (a space before it), every space becomes
U+2581, and the adjacent pair whose concatenation is a piece with the
highest score is merged until no pair is a piece; a symbol that is no
piece falls back to its UTF-8 bytes (`<0xXX>` pieces). Control and
unknown pieces never take part in merges. The vocabulary is the
benchmark's: (text, score, type) triples in id order, type 1 normal, 2
unknown, 3 control, 6 byte.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

SPACE = "▁"
NORMAL, UNKNOWN, CONTROL, BYTE = 1, 2, 3, 6


class SentencePieceBpe:
    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        self.ids = {text: i for i, (text, _, _) in enumerate(pieces)}
        self.scores = {text: score for text, score, kind in pieces
                       if kind not in (UNKNOWN, CONTROL)}
        self.bytes = {int(text[1:-1], 16): i
                      for i, (text, _, kind) in enumerate(pieces)
                      if kind == BYTE}
        self.bos = self.ids["<s>"]

    def encode(self, text: str, bos: bool) -> List[int]:
        symbols = list((" " + text).replace(" ", SPACE)) if text else []
        while len(symbols) > 1:
            pairs = [(self.scores.get(a + b), i) for i, (a, b)
                     in enumerate(zip(symbols, symbols[1:]))]
            best = max(((s, -i) for s, i in pairs if s is not None),
                       default=None)
            if best is None:
                break
            i = -best[1]
            symbols[i:i + 2] = [symbols[i] + symbols[i + 1]]
        ids = [self.bos] if bos else []
        for sym in symbols:
            if sym in self.ids:
                ids.append(self.ids[sym])
            else:
                ids += [self.bytes[b] for b in sym.encode("utf-8")]
        return ids
