"""Capacity planner: quant x flat/IVF x shards from rows/dim/chips/memory.

Counterpart of mmrs_tpu/plan.py. `mmrs-torch plan` predicts the residency
and the Q=1 latency of every rung of the residency ladder before a gallery
is built, and the engine's out-of-memory error at construction points here
(search/engine.py). The formulas are the JAX package's; the four constants
are fitted to one NVIDIA H100 80GB HBM3 at a 700 W power limit, from
`chip_smoke.py` phase 6 (its "planner constants" line):

  EFFECTIVE_SCAN_GBPS   1,048,576 x 512 bf16 gallery bytes over the eager
                        flat Q=1 top-10 (K1 and its merge, host dispatch
                        included);
  IVF_GATHER_EFF        the probed buckets' bytes over the bucket probe's
                        (K7's) time on the card alone at Q=1, C=1024,
                        nprobe=128, as a fraction of EFFECTIVE_SCAN_GBPS;
  IVF_OVERHEAD_MS       the eager IVF Q=1 top-10 at C=1024, nprobe=128,
                        less the formula's transfer terms (centroid scores,
                        probe lists, spill scan, merge, host dispatch);
  HBM_GB_DEFAULT        torch.cuda.get_device_properties(0).total_memory.

Latency predictions are a roofline model (+-35% is the JAX package's
allowance at its pinned points; `chip_smoke.py` phase 4h prints each
rung's prediction beside its measurement); residency predictions are
arithmetic (phase 4h holds them to 2% flat, 10% IVF, of the engines'
tensors). Multi-device rows are the sharded layouts of parallel/ (rows
or IVF slot strips split S ways, centroids replicated: bytes per device /
S); their latency is the same roofline per device, not fitted across
cards.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

# fitted on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 6's
# "planner constants" line; PERF.md's findings keep each run's fit)
EFFECTIVE_SCAN_GBPS = 2708.8    # flat bf16 bytes / eager Q=1 (0.3964 ms)
IVF_GATHER_EFF = 0.78           # K7's probed-byte rate / the scan rate
IVF_OVERHEAD_MS = 0.749         # centroid scores + probe list + merge + host
HBM_GB_DEFAULT = 85.017         # total_memory / 1e9
HBM_HEADROOM = 0.9              # leave 10% for queries and scratch

QUANTS = ("bf16", "int8", "int4")

# quality ladder caveats, surfaced with every option
_QUANT_NOTES = {
    "bf16": "rank-parity default (`mmrs-torch parity --rank-gate`)",
    "int8": "bounded score error (int8 codes, per-row scales)",
    "int4": "CAPACITY rung: coarser scores reorder near-ties; prefer "
            "int8/bf16 for exact top-k ids",
}


def row_bytes(dim: int, quant: str) -> float:
    """Device bytes per gallery row incl. per-row f32 scale."""
    if quant == "bf16":
        return 2.0 * dim
    if quant == "int8":
        return float(dim) + 4.0
    if quant == "int4":
        return dim / 2.0 + 4.0
    raise ValueError(f"unknown quant {quant!r}")


def flat_resident_gb(rows: int, dim: int, quant: str = "bf16",
                     shards: int = 1) -> float:
    """Per-device residency of the flat (exact-scan) gallery."""
    return rows * row_bytes(dim, quant) / shards / 1e9


def ivf_resident_gb(
    rows: int,
    dim: int,
    quant: str = "bf16",
    clusters: int = 0,
    slots_frac: float = 1.3,
    spill_frac: float = 0.05,
    shards: int = 1,
) -> float:
    """Per-device residency of the IVF index: bucket slots (slots_frac x
    rows, slot-sharded over devices) + average cap-rounding waste (~64
    slots/bucket/shard) + replicated centroids + the exact-scanned spill
    strip. spill_frac is corpus-dependent."""
    clusters = clusters or default_clusters(rows)
    rb = row_bytes(dim, quant)
    buckets = slots_frac * rows * rb / shards
    cap_waste = clusters * 64.0 * rb          # per-shard average rounding
    centroids = clusters * dim * 4.0          # replicated on every device
    spill = spill_frac * rows * rb / shards
    return (buckets + cap_waste + centroids + spill) / 1e9


def default_clusters(rows: int) -> int:
    """sqrt-rows rounded to a power of two (index/ivf.py default)."""
    c = max(16, int(rows ** 0.5))
    return 1 << (c - 1).bit_length()


def predict_flat_q1_ms(rows: int, dim: int, quant: str = "bf16",
                       shards: int = 1) -> float:
    gb = flat_resident_gb(rows, dim, quant, shards)
    return gb / (EFFECTIVE_SCAN_GBPS / 1e3)


def predict_ivf_q1_ms(
    rows: int,
    dim: int,
    quant: str = "bf16",
    clusters: int = 0,
    nprobe: int = 32,
    slots_frac: float = 1.3,
    spill_frac: float = 0.05,
    shards: int = 1,
) -> float:
    clusters = clusters or default_clusters(rows)
    rb = row_bytes(dim, quant)
    bucket_gb = (slots_frac * rows + clusters * 64.0) * rb / shards / 1e9
    probed_gb = min(nprobe, clusters) / clusters * bucket_gb
    spill_gb = spill_frac * rows * rb / shards / 1e9
    cent_gb = clusters * dim * 4.0 / 1e9
    scan_rate = EFFECTIVE_SCAN_GBPS / 1e3            # GB per ms
    return (probed_gb / (scan_rate * IVF_GATHER_EFF)
            + (spill_gb + cent_gb) / scan_rate
            + IVF_OVERHEAD_MS)


@dataclass
class PlanOption:
    quant: str
    index: str                  # "flat" | "ivf"
    shards: int
    resident_gb_per_chip: float
    predicted_q1_ms: float
    fits: bool
    exact: bool                 # exact top-k ids (no ANN, no int4)
    note: str = ""

    def describe(self) -> str:
        tag = f"{self.quant}/{self.index}"
        fit = "fits" if self.fits else "OOM"
        return (f"{tag:10s} x{self.shards} chip(s): "
                f"{self.resident_gb_per_chip:6.2f} GB/chip [{fit}], "
                f"Q1 ~{self.predicted_q1_ms:6.2f} ms — {self.note}")


@dataclass
class PlanReport:
    rows: int
    dim: int
    chips: int
    hbm_gb: float
    options: List[PlanOption] = field(default_factory=list)
    recommended: Optional[PlanOption] = None
    min_chips_exact_bf16: int = 0

    def render(self) -> str:
        lines = [
            f"plan: {self.rows:,} rows x {self.dim} dims on "
            f"{self.chips} chip(s) x {self.hbm_gb:.0f} GB HBM "
            f"(budget {HBM_HEADROOM:.0%})",
        ]
        lines += ["  " + o.describe() for o in self.options]
        if self.recommended is not None:
            r = self.recommended
            flags = {"bf16": "", "int8": " --gallery-quant int8",
                     "int4": " --gallery-quant int4"}[r.quant]
            if r.index == "ivf":
                flags += " --ann-nprobe 32"
            if r.shards > 1:
                flags += f" --gallery-shards {r.shards}"
            lines.append(f"recommended: {r.quant}/{r.index}"
                         f" — mmrs-torch search{flags or ' (defaults)'}")
        else:
            lines.append(
                "recommended: NOTHING fits — add chips (bf16 flat needs "
                f">= {self.min_chips_exact_bf16}) or shrink the gallery")
        return "\n".join(lines)


def plan(
    rows: int,
    dim: int,
    chips: int = 1,
    hbm_gb: float = HBM_GB_DEFAULT,
    nprobe: int = 32,
    clusters: int = 0,
    slots_frac: float = 1.3,
    spill_frac: float = 0.05,
    target_ms: float = 0.0,
) -> PlanReport:
    """Enumerate the residency ladder and recommend the highest-quality
    configuration that fits (and meets target_ms, if given)."""
    budget = hbm_gb * HBM_HEADROOM
    options: List[PlanOption] = []
    for quant in QUANTS:
        g = flat_resident_gb(rows, dim, quant, chips)
        options.append(PlanOption(
            quant, "flat", chips, g,
            predict_flat_q1_ms(rows, dim, quant, chips),
            g <= budget, exact=(quant != "int4"),
            note="exact scan; " + _QUANT_NOTES[quant]))
        gi = ivf_resident_gb(rows, dim, quant, clusters, slots_frac,
                             spill_frac, chips)
        options.append(PlanOption(
            quant, "ivf", chips, gi,
            predict_ivf_q1_ms(rows, dim, quant, clusters, nprobe,
                              slots_frac, spill_frac, chips),
            gi <= budget, exact=False,
            note=f"ANN nprobe={nprobe}; " + _QUANT_NOTES[quant]))

    # quality order: exact scans first (bf16 then int8), then bf16 IVF,
    # int8 IVF, and the int4 capacity rungs last
    order = [("bf16", "flat"), ("int8", "flat"), ("bf16", "ivf"),
             ("int8", "ivf"), ("int4", "flat"), ("int4", "ivf")]
    by_key = {(o.quant, o.index): o for o in options}
    recommended = None
    for key in order:
        o = by_key[key]
        if o.fits and (target_ms <= 0 or o.predicted_q1_ms <= target_ms):
            recommended = o
            break
    if recommended is None and target_ms > 0:
        # nothing meets the latency target: fall back to fit-only
        for key in order:
            if by_key[key].fits:
                recommended = by_key[key]
                break

    bf16_gb_total = rows * row_bytes(dim, "bf16") / 1e9
    min_chips = max(1, int(-(-bf16_gb_total // budget)))
    return PlanReport(rows, dim, chips, hbm_gb, options, recommended,
                      min_chips_exact_bf16=min_chips)


def oom_hint(rows: int, dim: int) -> str:
    """Message fragment attached to the engine's out-of-memory errors."""
    return (f"gallery does not fit on this device; run `mmrs-torch plan "
            f"--rows {rows} --dim {dim}` to pick a quant/IVF/shards config "
            "(residency ladder: --gallery-quant int8|int4, --ann-nprobe, "
            "--gallery-shards)")
