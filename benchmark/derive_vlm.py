"""Arithmetic the verifier cells' readers share: the window's prompts and
the device trace's runs of the decoder's attention launches."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from benchmark import derive

# substrings of the attention kernels' names in the trace
K10, K11, K2 = "chunk_kernel", "decode_kernel", "mha_"


def verifying(run) -> bool:
    return derive.generator(run) == "verify" and run.elapsed > 0


def prompt(run) -> Optional[int]:
    """The median sequence length of the window's answered packs."""
    return int(np.median(run.prompts)) if run.prompts else None


def attention_runs(run, kind: str) -> List[Tuple[int, float]]:
    """(launches, device seconds) of each whole run of `kind` launches in
    the traced slice: a pack's prefill (K10) or its decode steps (K11),
    bounded on both sides by the launches of another attention kernel
    (the tower's K2, the other decoder kernel), so that a run cut by the
    slice's ends is left out."""
    if run.trace is None:
        return []
    seq = []
    for name, a, b in sorted(run.trace.clipped(), key=lambda e: e[1]):
        tag = next((k for k in (K10, K11, K2) if k in name), None)
        if tag is None:
            continue
        if seq and seq[-1][0] == tag:
            seq[-1][1] += 1
            seq[-1][2] += (b - a) / 1e9
        else:
            seq.append([tag, 1, (b - a) / 1e9])
    return [(n, s) for tag, n, s in seq[1:-1] if tag == kind]


def kernel_share(runs: List[Tuple[int, float]], least) -> Optional[float]:
    """100 x the least time over the device time of the runs; `least(n)`
    is the least time of a run of n launches, or None for a run of
    another shape (left out)."""
    total = spent = 0.0
    for n, seconds in runs:
        t = least(n)
        if t is not None:
            total, spent = total + t, spent + seconds
    return 100.0 * total / spent if spent > 0 else None
