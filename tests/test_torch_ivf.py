"""The port's IVF index (index/ivf.py, index/stream.py, ops/kmeans.py, the
cluster prototypes) against mmrs_tpu's, on the same seeded numpy inputs.

Tolerances, and why:
  - k-means / prototypes / spherical-k-means EM: 1e-5 (f32 sums in another
    order; the farthest-point seeds and every assignment are equal); the
    silhouette score 1e-3 (a row's distance to itself is the square root
    of f32 round-off);
  - slot maps (bucket_ids, spill_ids, bucket_cap, s_pad), int8 / int4 codes
    and scales: bit for bit, when both packages build from the same
    centroids;
  - K7's plain version against `_probe_buckets_pallas(interpret=True)` and
    `_probe_buckets_xla` on the same probe lists: ids equal, values within
    1e-5 (f32 sums of exact products, in another order);
  - K8's plain version: ids and values equal (exact int32 dots and the
    shared `_score_f32` epilogue).
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmrs_tpu.index import ivf as J
from mmrs_tpu.index import stream as j_stream
from mmrs_tpu.ops import kmeans as j_kmeans
from mmrs_tpu.ops import quant4 as j_quant4
from mmrs_tpu.search import prototypes as j_proto
from mmrs_tpu_torch.index import ivf as T
from mmrs_tpu_torch.index import stream as t_stream
from mmrs_tpu_torch.ops import kmeans as t_kmeans
from mmrs_tpu_torch.ops import quant4 as t_quant4
from mmrs_tpu_torch.ops.normalize import l2_normalize
from mmrs_tpu_torch.ops.topk import cosine_topk
from mmrs_tpu_torch.search import prototypes as t_proto

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _blobs(rng, n, d, n_blobs, sigma=0.15):
    """Clustered unit vectors (tests/test_ivf.py's data)."""
    centers = _normed(rng, n_blobs, d)
    which = rng.integers(0, n_blobs, n)
    x = centers[which] + sigma * rng.standard_normal((n, d)).astype(
        np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _codes_int4_t(packed):
    """The port's [..., D/2] packed rows -> int4 codes [..., D]."""
    lo, hi = t_quant4.planes(packed.reshape(-1, packed.shape[-1]))
    codes = torch.cat([lo.int() - 8, hi.int() // 16], dim=1)
    return codes.reshape(*packed.shape[:-1], -1).numpy()


def _codes_int4_j(words):
    """The JAX package's [..., D/8, N] words -> int4 codes [..., N, D]."""
    words = np.asarray(words)
    lead, (dw, n) = words.shape[:-2], words.shape[-2:]
    flat = np.moveaxis(words.reshape(-1, dw, n), 0, 1).reshape(dw, -1)
    lo, hi = j_quant4._unpack_planes_xla(jnp.asarray(flat))
    lo, hi = np.asarray(lo, np.int32), np.asarray(hi, np.int32)
    codes = np.concatenate([lo - 8, hi // 16], axis=0)        # [D, B * N]
    return codes.T.reshape(*lead, n, -1)


# -- k-means, silhouette, prototypes ------------------------------------------

@pytest.mark.parametrize("n,d,k,seed", [(12, 32, 2, 0), (40, 16, 3, 1),
                                        (9, 64, 4, 2)])
def test_kmeans_and_silhouette_match_jax(n, d, k, seed):
    x = _blobs(np.random.default_rng(seed), n, d, k, sigma=0.4)
    jc, ja = j_kmeans.kmeans(jnp.asarray(x), k=k)
    tc, ta = t_kmeans.kmeans(_t(x), k=k)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    # silhouette: 1e-3, since a row's distance to itself is the square
    # root of f32 round-off (~3e-4), summed in another order
    js = float(j_kmeans.silhouette_score(jnp.asarray(x), ja, k))
    ts = float(t_kmeans.silhouette_score(_t(x), ta, k))
    assert abs(ts - js) <= 1e-3
    # an empty cluster reads +inf as the nearest other one, not 0
    empty = np.zeros(n, np.int64)
    empty[: n // 2] = 1
    assert abs(float(t_kmeans.silhouette_score(_t(x), _t(empty), 3))
               - float(j_kmeans.silhouette_score(jnp.asarray(x),
                                                 jnp.asarray(empty), 3))
               ) <= 1e-3


@pytest.mark.parametrize("strategy,kw", [
    ("cluster", {}),
    ("cluster", {"cluster_k": 3, "balance_ratio": 0.6}),
    ("cluster_scan", {}),
    ("robust_mean", {}),
    ("robust_mean", {"outlier_percentile": 70.0}),
])
def test_prototypes_match_jax(strategy, kw):
    rng = np.random.default_rng(3)
    shots = _blobs(rng, 10, 48, 2, sigma=0.5)
    shots[0] = -shots[1]                           # an outlier
    want = j_proto.build_prototype(jnp.asarray(shots), strategy=strategy,
                                   **kw)
    got = t_proto.build_prototype(_t(shots), strategy=strategy, **kw)
    assert got.shape == (48,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_spherical_kmeans_em_matches_jax_from_the_same_seeds():
    """JAX draws its initial centroids with jax.random.choice; fed the same
    rows, the port's EM gives the same centroids (1e-5)."""
    g = _blobs(np.random.default_rng(4), 900, 32, 12)
    want = np.asarray(J.train_centroids(g, 12, iters=5, seed=3))
    idx = np.asarray(jax.random.choice(jax.random.key(3), jnp.arange(900),
                                       (12,), replace=False))
    x = _t(g) / torch.linalg.norm(_t(g), dim=1, keepdim=True)
    got = T._spherical_kmeans(x, x[idx].clone(), 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the port's own seeding: distinct rows, the same for the same seed
    a = T.train_centroids(g, 12, iters=5, seed=3, device=CPU)
    b = T.train_centroids(g, 12, iters=5, seed=3, device=CPU)
    assert torch.equal(a, b) and a.shape == (12, 32)
    with pytest.raises(ValueError, match="n_clusters"):
        T.train_centroids(g[:5], 12, device=CPU)


def test_sizing_placement_and_auto_cap_match_jax():
    rng = np.random.default_rng(5)
    for n in (1, 7, 100, 10 ** 6, 10 ** 7):
        assert T.auto_clusters(n) == J.auto_clusters(n)
    for c in (1, 8, 100, 1024, 4096):
        assert T.auto_nprobe(c) == J.auto_nprobe(c)
    assign = np.concatenate([rng.integers(0, 3, 700),
                             rng.integers(0, 16, 300)]).astype(np.int32)
    for cover, frac in ((0.98, 1.3), (0.5, 1.3), (0.999, 4.0)):
        assert (T._auto_cap(assign, 16, 1000, cover, frac)
                == J._auto_cap(assign, 16, 1000, cover, frac))
    for cap in (8, 24, 512):
        for a, b in zip(T._placement(assign, 16, cap),
                        J._placement(assign, 16, cap)):
            np.testing.assert_array_equal(a, b)


# -- build: slot maps, codes, scales -------------------------------------------

@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(6)
    g = _blobs(rng, 1500, 64, 16)
    g[100] = g[7]                                  # duplicated rows
    g[900] = g[7]
    cents = np.asarray(J.train_centroids(g, 16, iters=4, seed=0))
    return g, cents, _normed(rng, 5, 64)


RUNGS = [("", jnp.float32, torch.float32), ("", jnp.bfloat16, torch.bfloat16),
         ("int8", jnp.bfloat16, torch.bfloat16),
         ("int4", jnp.bfloat16, torch.bfloat16)]


def _pair(g, cents, quant, jdt, tdt, cap=0):
    ji = J.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                     dtype=jdt, bucket_cap=cap)
    ti = T.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                     dtype=tdt, bucket_cap=cap, device=CPU)
    return ji, ti


def _rows_by_id(bucket_ids, spill_ids, bucket_vals, spill_vals, n):
    """Slot contents [C, cap, ...] / [S, ...] -> [N, ...] in row order."""
    out = np.zeros((n,) + bucket_vals.shape[2:], bucket_vals.dtype)
    for ids, vals in ((bucket_ids.reshape(-1),
                       bucket_vals.reshape(-1, *bucket_vals.shape[2:])),
                      (spill_ids, spill_vals)):
        live = ids >= 0
        out[ids[live]] = vals[live]
    return out


@pytest.mark.parametrize("cap", [0, 8])            # 8: spill-heavy
@pytest.mark.parametrize("quant,jdt,tdt", RUNGS)
def test_build_slot_maps_codes_and_scales_equal_jax(blobs, quant, jdt, tdt,
                                                    cap):
    """Slot maps bit for bit. Row contents bit for bit in every row whose
    L2-normalized f32 values are bit-equal in the two packages (the norm's
    sum order, which XLA picks per backend, decides the last bit of the
    rest, about a quarter of the rows); in the others, scales and f32
    values within four f32 ulps (the norm differs by one, the division and
    the /127 product round again), codes within one step, bf16 values
    within one bf16 ulp."""
    from mmrs_tpu.ops.normalize import l2_normalize as j_l2
    from mmrs_tpu_torch.ops.normalize import l2_normalize as t_l2

    g, cents, _ = blobs
    ji, ti = _pair(g, cents, quant, jdt, tdt, cap)
    assert ti.quant == ji.quant and ti.n_total == 1500 and ti.dim == 64
    assert ti.bucket_cap == ji.bucket_cap
    t_ids, t_sids = ti.bucket_ids.numpy(), ti.spill_ids.numpy()
    j_ids, j_sids = np.asarray(ji.bucket_ids), np.asarray(ji.spill_ids)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_sids, j_sids)
    if cap == 8 and quant != "int4":
        assert int((ti.spill_ids >= 0).sum()) > 1000
    if quant == "int4":
        # the JAX package's lane rounding of cap and s_pad, kept
        assert ti.bucket_cap % 128 == 0 and t_sids.shape[0] % 128 == 0
        assert ti.buckets.shape == (16, ti.bucket_cap, 32)
        t_rows = _rows_by_id(t_ids, t_sids, _codes_int4_t(ti.buckets),
                             _codes_int4_t(ti.spill), 1500)
        j_rows = _rows_by_id(j_ids, j_sids,
                             _codes_int4_j(ji.buckets)[..., :64],
                             _codes_int4_j(ji.spill)[..., :64], 1500)
    else:
        t_rows = _rows_by_id(t_ids, t_sids, ti.buckets.float().numpy(),
                             ti.spill.float().numpy(), 1500)
        j_rows = _rows_by_id(j_ids, j_sids,
                             np.asarray(ji.buckets, np.float32)[..., :64],
                             np.asarray(ji.spill, np.float32)[..., :64],
                             1500)
    same = (np.asarray(jax.jit(j_l2)(jnp.asarray(g)))
            == t_l2(_t(g)).numpy()).all(1)
    assert same.mean() > 0.5
    np.testing.assert_array_equal(t_rows[same], j_rows[same])
    if quant:
        assert np.abs(t_rows - j_rows).max() <= 1
        t_sc = _rows_by_id(t_ids, t_sids, ti.bucket_scales.numpy(),
                           ti.spill_scales.numpy(), 1500)
        j_sc = _rows_by_id(j_ids, j_sids, np.asarray(ji.bucket_scales),
                           np.asarray(ji.spill_scales), 1500)
        np.testing.assert_array_equal(t_sc[same], j_sc[same])
        np.testing.assert_allclose(t_sc, j_sc, rtol=2.0 ** -21, atol=0)
    else:
        np.testing.assert_allclose(
            t_rows, j_rows, atol=0,
            rtol=2.0 ** -7 if tdt == torch.bfloat16 else 2.0 ** -21)


def test_every_row_indexed_once_and_streaming_build_equals_build(blobs):
    g, cents, q = blobs
    a = T.build_ivf(g, n_clusters=16, iters=3, chunk=256, seed=7,
                    dtype=torch.float32, device=CPU)
    ids = torch.cat([a.bucket_ids.reshape(-1), a.spill_ids])
    np.testing.assert_array_equal(np.sort(ids[ids >= 0].numpy()),
                                  np.arange(1500))

    def chunks():
        for s in range(0, 1500, 256):
            rows = g[s:s + 256]
            yield _t(np.concatenate([rows, np.zeros((256 - len(rows), 64),
                                                    np.float32)]))

    b = T.build_ivf_streaming(chunks, 1500, 64, n_clusters=16, iters=3,
                              chunk=256, seed=7, dtype=torch.float32,
                              sample=_t(g), device=CPU)
    assert torch.equal(a.bucket_ids, b.bucket_ids)
    assert set(b.build_seconds) == {"train", "assign", "fill"}
    with pytest.raises(ValueError, match="assignments without centroids"):
        T.build_ivf(g, assignments=np.zeros(1500, np.int32), device=CPU)
    with pytest.raises(ValueError, match="quantize mode"):
        T.build_ivf(g, centroids=cents, quantize="int2", device=CPU)


# -- K7 / K8 plain versions against the JAX probes ------------------------------

def _probe_list(q, ivf_t, p, seed):
    """Per query: a random set of P distinct clusters (the same list goes
    to both packages)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(ivf_t.n_clusters)[:p]
                     for _ in range(q.shape[0])]).astype(np.int32)


def _jax_words(codes):
    """int4 codes [..., N, Dp] -> the JAX package's [..., Dp/8, N] words
    (low half offset by 8 in the low nibbles, high half signed above)."""
    h = codes.shape[-1] // 2
    byte = ((codes[..., :h] + 8) & 0xF) | ((codes[..., h:] & 0xF) << 4)
    w = byte.reshape(*byte.shape[:-1], -1, 4).astype(np.uint32)
    words = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    return np.swapaxes(words.view(np.int32), -1, -2)


def _jax_twin(ti):
    """The port's bucket contents in the JAX package's layout (D padded to
    128 lanes; int4 as packed words), so both probes read the same data."""
    c, cap = ti.bucket_ids.shape
    if ti.quant == "int4":
        codes = np.zeros((c, cap, 128), np.int64)
        codes[..., :ti.dim] = _codes_int4_t(ti.buckets)
        buckets = jnp.asarray(_jax_words(codes))
    else:
        rows = np.zeros((c, cap, 128), np.float32)
        rows[..., :ti.dim] = ti.buckets.float().numpy()
        buckets = jnp.asarray(rows).astype(
            jnp.int8 if ti.quant else jnp.bfloat16)
    scales = (None if ti.bucket_scales is None
              else jnp.asarray(ti.bucket_scales.numpy()))
    return buckets, jnp.asarray(ti.bucket_ids.numpy()), scales


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("p,k", [(3, 7), (16, 25), (1, 1)])
def test_probe_buckets_plain_matches_jax(blobs, quant, jax_impl, p, k):
    g, cents, q = blobs
    ti = T.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                     device=CPU)
    probe = _probe_list(q, ti, p, seed=p)
    qp = jnp.zeros((q.shape[0], 128), jnp.bfloat16).at[:, :64].set(
        jnp.asarray(q).astype(jnp.bfloat16))
    fn = (J._probe_buckets_xla if jax_impl == "xla" else
          lambda *a: J._probe_buckets_pallas(*a, interpret=True))
    jv, jid = fn(qp, jnp.asarray(probe), *_jax_twin(ti), k)
    tv, tid = T.probe_buckets(_t(q).to(torch.bfloat16), _t(probe),
                              ti.buckets, ti.bucket_ids, ti.bucket_scales, k)
    assert tv.shape == (5, k) and tid.dtype == torch.int32
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("p,k", [(3, 7), (16, 25)])
def test_probe_buckets_q4_plain_equals_jax(blobs, jax_impl, p, k):
    g, cents, q = blobs
    ti = T.build_ivf(g, n_clusters=16, centroids=cents, quantize="int4",
                     device=CPU)
    probe = _probe_list(q, ti, p, seed=p + 1)
    qp = jnp.zeros((q.shape[0], 128), jnp.float32).at[:, :64].set(q)
    # under jit, as ivf_topk runs it (the /127 becomes a product)
    jq = jax.jit(j_quant4._prep_queries)(qp)
    fn = (J._probe_buckets_xla_q4 if jax_impl == "xla" else
          lambda *a: J._probe_buckets_pallas_q4(*a, interpret=True))
    jv, jid = fn(*jq, jnp.asarray(probe), *_jax_twin(ti), k)
    tq = t_quant4.prep_queries(_t(q))
    tv, tid = T.probe_buckets_q4(*tq, _t(probe), ti.buckets, ti.bucket_ids,
                                 ti.bucket_scales, k)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_probe_ties_short_lists_and_out_of_order_probes():
    """Duplicated rows tie: the earlier probe rank, then the earlier slot,
    comes first. k past the live slots pads with (-inf, -1), as the JAX
    XLA probe does."""
    rng = np.random.default_rng(8)
    g = _normed(rng, 40, 32)
    g[[5, 17, 33]] = g[2]
    assign = np.arange(40) % 4
    ivf = T.build_ivf(g, n_clusters=4, centroids=_normed(rng, 4, 32),
                      assignments=assign, bucket_cap=16,
                      dtype=torch.float32, device=CPU)
    # rows 2, 5, 17, 33 sit in clusters 2, 1, 1, 1
    probe = torch.tensor([[1, 2, 0], [2, 1, 3]], dtype=torch.int32)
    q = _t(g[[2, 2]])
    v, ids = T.probe_buckets(q, probe, ivf.buckets, ivf.bucket_ids, None,
                             40)
    assert ids[0, :4].tolist() == [5, 17, 33, 2]
    assert ids[1, :4].tolist() == [2, 5, 17, 33]
    assert len(set(v[0, :4].tolist())) == 1
    live = 30          # clusters {1, 2, 0} hold 10 rows each
    assert (ids[0, live:] == -1).all() and torch.isinf(v[0, live:]).all()
    jv, jid = J._probe_buckets_xla(jnp.asarray(g[[2, 2]]),
                                   jnp.asarray(probe.numpy()),
                                   jnp.asarray(ivf.buckets.numpy()),
                                   jnp.asarray(ivf.bucket_ids.numpy()),
                                   None, 40)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jid))


def _owners_loop(probe, tile):
    """The ownership rule as a Python loop over each tile's entries."""
    out = np.zeros(probe.shape, bool)
    for t0 in range(0, probe.shape[0], tile):
        seen = set()
        for qi in range(t0, min(t0 + tile, probe.shape[0])):
            for r in range(probe.shape[1]):
                out[qi, r] = int(probe[qi, r]) not in seen
                seen.add(int(probe[qi, r]))
    return out


@pytest.mark.parametrize("q,p,c", [(1, 5, 8), (8, 16, 20), (13, 7, 6),
                                   (64, 4, 300)])
@pytest.mark.parametrize("kind", ["random", "duplicated"])
def test_bucket_owners_match_a_python_loop(q, p, c, kind):
    """K7's bucket-major rule (`ivf.bucket_owners`): an entry owns its
    bucket iff no earlier entry of its 8-query tile names it; every
    distinct bucket of a tile has exactly one owner."""
    rng = np.random.default_rng(q * p + c)
    probe = rng.integers(-2, c + 2, (q, p)).astype(np.int32)
    if kind == "duplicated":       # whole lists repeated, and repeats inside
        probe[1::2] = probe[0]
        probe[:, -1] = probe[:, 0]
    own = T.bucket_owners(torch.from_numpy(probe)).numpy()
    np.testing.assert_array_equal(own, _owners_loop(probe, T.PROBE_TILE))
    for t0 in range(0, q, T.PROBE_TILE):
        tile = probe[t0:t0 + T.PROBE_TILE]
        assert own[t0:t0 + T.PROBE_TILE].sum() == len(np.unique(tile))


def _bucket_major_model(q, probe, ivf, k):
    """K7's and K8's algorithm in plain PyTorch: the owner of each distinct
    bucket of a tile scores its 256-slot chunks for every query, keeps
    each chunk's best min(k, 256) by (score desc, slot asc), and writes
    them as list r * n_cc + c of every entry (qi, r) naming the bucket,
    carrying r * cap + slot; the lists are merged by (score desc, position
    asc). q: bf16 queries (K7), or f32 queries that int4 buckets' rows
    score by ops/quant4.scores_int4 on their int8 codes (K8)."""
    c_n, cap = ivf.bucket_ids.shape
    q4 = t_quant4.prep_queries(q) if ivf.quant == "int4" else None
    n_cc, kc = -(-cap // 256), min(k, 256)
    qn, p = probe.shape
    own = T.bucket_owners(probe)
    lists = {}
    for qi, r in zip(*np.nonzero(own.numpy())):
        t0 = qi // T.PROBE_TILE * T.PROBE_TILE
        b = int(probe[qi, r])
        ids = (ivf.bucket_ids[b] if 0 <= b < c_n
               else torch.full((cap,), -1, dtype=torch.int32))
        rows = ivf.buckets[b % c_n]
        for q2 in range(t0, min(t0 + T.PROBE_TILE, qn)):
            if q4 is not None:
                scores = t_quant4.scores_int4(
                    *(x[q2:q2 + 1] for x in q4), rows,
                    ivf.bucket_scales[b % c_n])[0]
            else:
                scores = rows.float() @ q[q2].float()
                if ivf.bucket_scales is not None:
                    scores = scores * ivf.bucket_scales[b % c_n]
            scores = torch.where(ids >= 0, scores, float("-inf"))
            for r2 in np.nonzero((probe[q2] == b).numpy())[0]:
                for cc in range(n_cc):
                    sl = scores[cc * 256:(cc + 1) * 256]
                    order = np.lexsort((np.arange(sl.numel()), -sl.numpy()))
                    top = order[:kc]
                    lists[(q2, r2 * n_cc + cc)] = (
                        sl[top], r2 * cap + cc * 256 + torch.from_numpy(top))
    vals = torch.full((qn, k), float("-inf"))
    out = torch.full((qn, k), -1, dtype=torch.int32)
    for q2 in range(qn):
        v = torch.cat([lists[(q2, j)][0] for j in range(p * n_cc)])
        pos = torch.cat([lists[(q2, j)][1] for j in range(p * n_cc)])
        order = np.lexsort((pos.numpy(), -v.numpy()))[:k]
        vals[q2, :len(order)] = v[order]
        for j, o in enumerate(order):
            r2, slot = divmod(int(pos[o]), cap)
            b = int(probe[q2, r2])
            if v[o] > float("-inf") and 0 <= b < c_n:
                out[q2, j] = ivf.bucket_ids[b, slot]
    return vals, out


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
def test_bucket_major_model_equals_the_plain_probe(blobs, quant):
    """The bucket-major partials (positions r * cap + slot, lists r * n_cc
    + c, repeated and shared buckets) merge to the plain probe's answer:
    K7's within 1e-5 (f32 sums in another order), K8's bit for bit (exact
    int32 sums, the same f32 epilogue; its plain version is held against
    JAX above)."""
    g, cents, q = blobs
    ti = T.build_ivf(g, n_clusters=16, centroids=cents, quantize=quant,
                     device=CPU, bucket_cap=300)
    assert ti.bucket_cap % 256                # a ragged last chunk
    probe = _t(_probe_list(q, ti, 6, seed=3))
    probe[1] = probe[0]                       # a shared list
    probe[2, 4] = probe[2, 1]                 # a bucket twice in one list
    qb = _t(q) if quant == "int4" else _t(q).to(torch.bfloat16)
    for k in (1, 10, 300):
        mv, mi = _bucket_major_model(qb, probe, ti, k)
        if quant == "int4":
            tv, tid = T.probe_buckets_q4(*t_quant4.prep_queries(qb), probe,
                                         ti.buckets, ti.bucket_ids,
                                         ti.bucket_scales, k)
            np.testing.assert_array_equal(mv.numpy(), tv.numpy())
        else:
            tv, tid = T.probe_buckets(qb, probe, ti.buckets, ti.bucket_ids,
                                      ti.bucket_scales, k)
            np.testing.assert_allclose(mv.numpy(), tv.numpy(), atol=1e-5,
                                       rtol=0)
        np.testing.assert_array_equal(mi.numpy(), tid.numpy())


# -- ivf_topk -----------------------------------------------------------------

def _assert_ids_equal_where_separated(tv, tid, jv, jid, sep=1e-5):
    """Ids equal at every place whose JAX score is more than `sep` from its
    neighbours'. Two rows whose f32 scores differ by a few ulps may swap,
    since the packages sum the products in another order."""
    jv, jid, tid = np.asarray(jv), np.asarray(jid), tid.numpy()
    gap = np.full(jv.shape, np.inf, np.float32)
    d = np.abs(np.diff(jv, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    separated = (gap > sep) | np.isneginf(jv)      # -inf places hold -1
    assert separated.mean() > 0.9
    np.testing.assert_array_equal(tid[separated], jid[separated])


@pytest.mark.parametrize("quant,jdt,tdt", RUNGS)
def test_ivf_topk_matches_jax(blobs, quant, jdt, tdt):
    """Ids equal where scores are separated; values within 1e-5. (Even int4
    values may differ in the last bit here: a row's scale follows its f32
    L2 norm, whose sum order differs between the packages; fed the same
    buckets, K8's plain version is bit-identical, as tested above.)"""
    g, cents, q = blobs
    for cap in (0, 8):
        ji, ti = _pair(g, cents, quant, jdt, tdt, cap)
        for nprobe, k in ((3, 10), (16, 10), (2, 300)):
            jv, jid = J.ivf_topk(jnp.asarray(q), ji, k=k, nprobe=nprobe,
                                 impl="xla")
            tv, tid = T.ivf_topk(_t(q), ti, k=k, nprobe=nprobe)
            _assert_ids_equal_where_separated(tv, tid, jv, jid)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       atol=1e-5, rtol=0)


def test_full_probe_equals_flat_scans_d48_single_query():
    """nprobe == C probes every bucket: the flat top-k (f32 and bf16 by
    cosine_topk, int4 by cosine_topk_int4), at D = 48 and Q = 1."""
    rng = np.random.default_rng(9)
    g, q = _normed(rng, 300, 48), _normed(rng, 1, 48)
    ivf = T.build_ivf(g, n_clusters=4, iters=2, dtype=torch.float32,
                      device=CPU)
    ev, ei = cosine_topk(_t(q), _t(g), 3)
    av, ai = T.ivf_topk(_t(q), ivf, k=3, nprobe=4)
    assert torch.equal(ai, ei)
    np.testing.assert_allclose(av.numpy(), ev.numpy(), atol=1e-5)
    g, q = _normed(rng, 700, 64), _normed(rng, 4, 64)
    for quant, dt in (("", torch.bfloat16), ("int4", torch.bfloat16)):
        ivf = T.build_ivf(g, n_clusters=8, bucket_cap=64, iters=2,
                          quantize=quant, dtype=dt, device=CPU)
        av, ai = T.ivf_topk(_t(q), ivf, k=10, nprobe=8)
        if quant == "int4":
            # the index quantizes each row after its own l2_normalize
            ev, ei = t_quant4.cosine_topk_int4(
                _t(q), *t_quant4.quantize_rows_int4(l2_normalize(_t(g))),
                10)
            assert torch.equal(av, ev)
        else:
            ev, ei = cosine_topk(_t(q).bfloat16(), _t(g).bfloat16(), 10)
            np.testing.assert_allclose(av.numpy(), ev.numpy(), atol=1e-6)
        assert torch.equal(ai, ei)


def test_tune_nprobe_recall_and_streaming_topk_match_jax(blobs):
    g, cents, q = blobs
    jv, ji = j_stream.streaming_topk(g, q, k=7, chunk_rows=400)
    tv, ti = t_stream.streaming_topk(g, q, k=7, chunk_rows=400, device=CPU)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-5)
    tv, ti = t_stream.streaming_topk(g[:5], q, k=7, device=CPU)
    assert (ti[:, 5:] == -1).all() and np.isinf(tv[:, 5:]).all()

    jx, tx = _pair(g, cents, "", jnp.float32, torch.float32)
    want = J.tune_nprobe(jx, g, target_recall=0.9, k=10, n_queries=16,
                         impl="xla")
    got = T.tune_nprobe(tx, g, target_recall=0.9, k=10, n_queries=16)
    assert got == want
    assert (T.ivf_recall(tx, g, q, k=5, nprobe=2)
            == J.ivf_recall(jx, g, q, k=5, nprobe=2, impl="xla"))


# -- persistence ----------------------------------------------------------------

@pytest.mark.parametrize("quant,jdt,tdt", RUNGS[1:])
def test_sidecars_load_across_packages(blobs, tmp_path, quant, jdt, tdt):
    """A sidecar written by either package loads in the other (same files:
    f32 centroids lane-padded to 128 columns, int32 slot maps, the same
    meta keys) and serves the same ids."""
    g, cents, q = blobs
    ji, ti = _pair(g, cents, quant, jdt, tdt)
    T.save_ivf(str(tmp_path / "t"), ti, embeddings=g)
    J.save_ivf(str(tmp_path / "j"), ji, embeddings=g)
    zt, zj = (np.load(str(tmp_path / s / "ivf.npz")) for s in "tj")
    assert sorted(zt.files) == sorted(zj.files)
    for key in zt.files:
        assert zt[key].dtype == zj[key].dtype
        np.testing.assert_array_equal(zt[key], zj[key])
    assert T.sidecar_meta(str(tmp_path / "t")) == \
        J.sidecar_meta(str(tmp_path / "j"))

    t_from_j = T.load_ivf(str(tmp_path / "j"), g, device=CPU)
    j_from_t = J.load_ivf(str(tmp_path / "t"), g)
    assert t_from_j.quant == quant and j_from_t.quant == quant
    jv, jid = J.ivf_topk(jnp.asarray(q), j_from_t, k=10, nprobe=4,
                         impl="xla")
    tv, tid = T.ivf_topk(_t(q), t_from_j, k=10, nprobe=4)
    _, own = T.ivf_topk(_t(q), ti, k=10, nprobe=4)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert torch.equal(tid, own)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)

    with pytest.raises(ValueError, match="fingerprint"):
        T.load_ivf(str(tmp_path / "j"), np.ascontiguousarray(g[::-1]),
                   device=CPU)
    with pytest.raises(ValueError, match="rebuild"):
        T.load_ivf(str(tmp_path / "j"), g[:100], device=CPU)


def test_extend_and_shrink_sidecar_match_jax(blobs, tmp_path):
    g, cents, _ = blobs
    old = g[:1000]
    ji, ti = (pkg.build_ivf(old, n_clusters=16, centroids=cents,
                            bucket_cap=72, **kw)
              for pkg, kw in ((J, {}), (T, {"device": CPU})))
    dirs = {name: str(tmp_path / name) for name in ("j", "t")}
    J.save_ivf(dirs["j"], ji, embeddings=old)
    T.save_ivf(dirs["t"], ti, embeddings=old)
    mj = J.extend_sidecar(dirs["j"], g)
    mt = T.extend_sidecar(dirs["t"], g, device=CPU)
    assert mt == mj and mt["n_total"] == 1500

    def maps(name):
        z = np.load(os.path.join(dirs[name], "ivf.npz"))
        return {key: z[key] for key in z.files}

    for key, arr in maps("j").items():
        np.testing.assert_array_equal(maps("t")[key], arr)
    T.update_sidecar_meta(dirs["t"], tuned={"nprobe": 4})
    assert T.sidecar_meta(dirs["t"])["tuned"] == {"nprobe": 4}

    kept = np.ones(1500, bool)
    kept[::3] = False
    mj = J.shrink_sidecar(dirs["j"], kept, g[kept])
    mt = T.shrink_sidecar(dirs["t"], kept, g[kept], device=CPU)
    assert mt == mj and "tuned" not in mt
    for key, arr in maps("j").items():
        np.testing.assert_array_equal(maps("t")[key], arr)
    with open(os.path.join(dirs["t"], "ivf.json")) as f:
        assert json.load(f)["n_total"] == int(kept.sum())
    with pytest.raises(ValueError, match="shrank"):
        T.extend_sidecar(dirs["t"], g[:10], device=CPU)
    with pytest.raises(ValueError, match="kept 0 rows"):
        T.shrink_sidecar(dirs["t"], np.zeros(int(kept.sum()), bool),
                         g[:0], device=CPU)
