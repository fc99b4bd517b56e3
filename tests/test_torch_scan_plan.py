"""The launch plans of the span scans (K1, K4, K5), of the bucket probes
(K7, K8) and of K11 at any G, on the CPU.

K1 (bf16), K4 (int8) and K5 (int4) keep each span's best k by a running
threshold
(`csrc/span_scan.cuh`): a query's 384-entry candidate buffer, seeded with
the best kc of the span's first chunk, takes each later chunk's scores
strictly above the threshold and is compacted to its best kc by a warp
arg-max when it could not take another chunk; the threshold is the kc-th
best kept. Here that select is modelled in plain PyTorch, chunk by chunk as
the kernel runs it, and held against the plain top-k with many ties; the
plan (`ops/topk.span_rows`, `scan_plan` with the rows a partial covers) is
checked to end in one list for every k and gallery size; K7 and K8 are
checked to plan one 256-row partial a chunk of each probed bucket; and
K11's split of G query
heads into launches of its instances (`group_pieces`) to cover every head
once. The kernels themselves run on the card (tests/test_torch_cuda.py).
"""

import contextlib
import numpy as np
import pytest
import torch

from mmrs_tpu_torch.index import ivf
from mmrs_tpu_torch.ops import _cuda, decode_attention, quant, quant4, topk

torch.set_num_threads(2)

N_EDGES = (1, topk.SPAN_MAX - 1, topk.SPAN_MAX, topk.SPAN_MAX + 1, 1 << 20)
KS = (1, 10, 32, 33, 256, 257, 1000, 5000)
SELECT_CAP = 384   # csrc/span_scan.cuh kScanCap: a query's candidate buffer


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _best(v: torch.Tensor, i: torch.Tensor, keep: int):
    """Rows of candidates -> their best `keep` by (score desc, id asc)."""
    _, o = torch.sort(i, dim=-1, stable=True)
    v, i = v.gather(-1, o), i.gather(-1, o)
    _, o = torch.sort(v, dim=-1, descending=True, stable=True)
    return v.gather(-1, o)[..., :keep], i.gather(-1, o)[..., :keep]


def _span_select(scores: torch.Tensor, row0: int, kc: int):
    """One query's span (scores of rows row0 ..) as the kernel keeps it:
    the first chunk's best kc seed the buffer and the threshold; each later
    chunk appends its scores strictly above the threshold, and when the
    buffer could not take another chunk it keeps its best kc and the
    threshold rises to the kc-th."""
    rows = torch.arange(row0, row0 + scores.numel())
    chunk = topk.CHUNK_ROWS
    buf_v, buf_i = _best(scores[:chunk], rows[:chunk], kc)
    thr = float(buf_v[-1]) if buf_v.numel() == kc else float("-inf")
    for c0 in range(chunk, scores.numel(), chunk):
        s, r = scores[c0:c0 + chunk], rows[c0:c0 + chunk]
        take = s > thr
        buf_v = torch.cat([buf_v, s[take]])
        buf_i = torch.cat([buf_i, r[take]])
        if buf_v.numel() > SELECT_CAP - chunk:
            buf_v, buf_i = _best(buf_v, buf_i, kc)
            thr = float(buf_v[kc - 1])
    v, i = _best(buf_v, buf_i, kc)
    return topk._pad(v[None], i[None].int(), kc)


def _span_partials(scores: torch.Tensor, k: int, rows: int):
    """[Q, N] scores -> the scan's partials [Q, ceil(N / rows), kc]: the
    select for kc <= SELECT_MAX, else each chunk's sorted best kc."""
    q, n = scores.shape
    n_parts, kc, _ = topk.scan_plan(n, k, rows)
    vals = torch.empty((q, n_parts, kc))
    ids = torch.empty((q, n_parts, kc), dtype=torch.int32)
    for qi in range(q):
        for p in range(n_parts):
            s = scores[qi, p * rows:(p + 1) * rows]
            if kc <= topk.SELECT_MAX:
                v, i = _span_select(s, p * rows, kc)
            else:
                v, i = _best(s[None], torch.arange(p * rows, p * rows
                                                   + s.numel())[None], kc)
                v, i = topk._pad(v, i.int(), kc)
            vals[qi, p], ids[qi, p] = v[0], i[0]
    return vals, ids


def _merge(vals, ids, k: int, rows: int, n: int):
    """The plan's merge passes over the partials, as the merge kernels run
    them (each pass keeps the best `out` of a group of `per` lists)."""
    q = vals.shape[0]
    for p in topk.scan_plan(n, k, rows)[2]:
        groups = -(-p.lists // p.per)
        extra = groups * p.per - p.lists
        vals = torch.cat([vals, vals.new_full((q, extra, p.length),
                                              float("-inf"))], 1)
        ids = torch.cat([ids, ids.new_full((q, extra, p.length), -1)], 1)
        vals, ids = _best(vals.reshape(q, groups, -1),
                          ids.reshape(q, groups, -1), p.out)
    return topk._pad(vals.reshape(q, -1), ids.reshape(q, -1).int(), k)


@pytest.mark.parametrize("k", [1, 10, 32, 33, 100])
@pytest.mark.parametrize("n,rows", [(600, 256), (2048, 2048), (2049, 2048),
                                    (4113, 1024), (5000, 2048)])
@pytest.mark.parametrize("ties", ["rounded", "identical"])
def test_span_select_model_equals_plain_topk(k, n, rows, ties):
    """Span partials (the threshold select) merged by the plan's passes =
    the plain top-k, ties lowest row first. Rounded scores tie often; a
    gallery of identical rows gives ids 0..k-1 (the strict threshold test
    admits no row after the first chunk)."""
    rows = rows if k <= topk.SELECT_MAX else topk.CHUNK_ROWS
    rng = np.random.default_rng(n + k)
    if ties == "rounded":
        s = np.round(rng.standard_normal((2, n)), 1).astype(np.float32)
    else:
        s = np.full((2, n), 0.25, np.float32)
    scores = torch.from_numpy(s)
    vals, ids = _merge(*_span_partials(scores, k, rows), k, rows, n)
    rv, ri = topk.sorted_topk(scores, k)
    assert torch.equal(ids, ri) and torch.equal(vals, rv)
    if ties == "identical":
        assert ids[0].tolist() == list(range(k))


@pytest.mark.parametrize("k", [10, 32])
def test_span_select_model_rising_scores(k):
    """Scores that rise along the span: every row after the first chunk
    passes the threshold, so the buffer compacts after every chunk."""
    n = 2048
    scores = torch.arange(n, dtype=torch.float32)[None] / n
    v, i = _span_select(scores[0], 0, k)
    assert i[0].tolist() == list(range(n - 1, n - 1 - k, -1))


def test_span_rows():
    assert topk.span_rows(1 << 20, 10) == topk.SPAN_MAX == 2048
    assert topk.span_rows(1 << 20, topk.SELECT_MAX + 1) == topk.CHUNK_ROWS
    for n in (1, 255, 256, 257, 100_000, 131_073, 1 << 18, 5 << 20):
        for k in (1, 10, 32):
            r = topk.span_rows(n, k)
            assert r % topk.CHUNK_ROWS == 0
            assert topk.CHUNK_ROWS <= r <= topk.SPAN_MAX
            # about SPANS lists until the spans reach SPAN_MAX rows
            assert -(-n // r) <= topk.SPANS or r == topk.SPAN_MAX


def _rows_for(n, k):
    """The span the kernels pick, and where k allows it the longest."""
    out = {topk.span_rows(n, k)}
    if k <= topk.SELECT_MAX:
        out.add(topk.SPAN_MAX)
    return sorted(out)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", N_EDGES)
def test_span_plan_ends_in_one_list(n, k):
    for rows in _rows_for(n, k):
        n_parts, kc, passes = topk.scan_plan(n, k, rows)
        assert n_parts == -(-n // rows)
        assert kc == min(k, topk.CHUNK_ROWS)
        lists, length = n_parts, kc
        for p in passes:
            assert (p.lists, p.length) == (lists, length)
            assert p.out == min(k, p.per * p.length)
            lists, length = -(-lists // p.per), p.out
            assert lists < p.lists
        assert lists == 1 and length == min(k, n_parts * kc)


def _record_plans(monkeypatch):
    """Run the scan wrappers' Python on CPU tensors with the launches
    recorded instead of made: [(what, n, rows)] of each scan_and_merge
    call."""
    calls = []

    def fake_scan_and_merge(q, n, k, device, scan, what, rows=topk.CHUNK_ROWS):
        calls.append((what, n, rows))
        return (torch.zeros((q, k)), torch.zeros((q, k), dtype=torch.int32))

    class FakeLib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(topk, "scan_and_merge", fake_scan_and_merge)
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "library", lambda: FakeLib())
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    # the launches' device guards (no card here)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    return calls


def test_chunk_scans_keep_256_row_partials(monkeypatch):
    """The flat scans K1, K4 and K5 plan the span of span_rows (2048 rows
    at N = 2^20, k = 10; one 256-row chunk at k = 33); the bucket probes
    K7 and K8 one 256-row partial a chunk of each probed bucket (n = P *
    ceil(cap / 256) * 256: bucket-major, lists r * n_cc + c)."""
    calls = _record_plans(monkeypatch)
    n, d, k = 1 << 20, 64, 10
    g = torch.zeros((n, d))
    qs = torch.zeros((8, d))
    quant._topk_quant_cuda(*quant.quantize_rows(qs), *quant.quantize_rows(g), k)
    topk._cosine_topk_cuda(qs.bfloat16(), g.bfloat16(), k)
    quant4._topk_int4_cuda(*quant4.prep_queries(qs),
                           *quant4.quantize_rows_int4(g), k)
    c, cap = 4, 300
    probe = torch.zeros((8, 2), dtype=torch.int32)
    ids = torch.zeros((c, cap), dtype=torch.int32)
    ivf._probe_buckets_cuda(qs.bfloat16(), probe, torch.zeros(
        (c, cap, d), dtype=torch.bfloat16), ids, None, k)
    ivf._probe_buckets_q4_cuda(*quant4.prep_queries(qs), probe, torch.zeros(
        (c, cap, d // 2), dtype=torch.uint8), ids, torch.ones((c, cap)), k)
    assert calls == [("cosine_topk_quantized", n, 2048),
                     ("cosine_topk", n, 2048), ("cosine_topk_int4", n, 2048),
                     ("probe_buckets", 2 * 512, topk.CHUNK_ROWS),
                     ("probe_buckets_q4", 2 * 512, topk.CHUNK_ROWS)]
    calls.clear()
    quant._topk_quant_cuda(*quant.quantize_rows(qs), *quant.quantize_rows(g),
                           33)
    topk._cosine_topk_cuda(qs.bfloat16(), g.bfloat16(), 300)
    quant4._topk_int4_cuda(*quant4.prep_queries(qs),
                           *quant4.quantize_rows_int4(g), 33)
    assert calls == [("cosine_topk_quantized", n, topk.CHUNK_ROWS),
                     ("cosine_topk", n, topk.CHUNK_ROWS),
                     ("cosine_topk_int4", n, topk.CHUNK_ROWS)]


@pytest.mark.parametrize("g", range(1, 33))
def test_decode_group_pieces_cover_every_head_once(g):
    pieces = decode_attention.group_pieces(g)
    heads = [h for start, n, _ in pieces for h in range(start, start + n)]
    assert heads == list(range(g))
    assert len(pieces) == -(-g // max(decode_attention._GROUPS))
    for _, n, width in pieces:
        assert width in decode_attention._GROUPS and width >= n
        assert width == min(w for w in decode_attention._GROUPS if w >= n)
    if g in decode_attention._GROUPS:
        assert pieces == ((0, g, g),)
