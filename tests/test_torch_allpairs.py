"""`first_match` / `dedup_groups` (mmrs_tpu_torch/ops/allpairs.py) against
mmrs_tpu's, on the CPU.

The same seeded numpy rows go through the JAX op (its XLA form and its
Pallas kernel in interpret mode, tile 64) and through the port's plain
PyTorch version, which is what the port runs on a CPU tensor; the K9 CUDA
kernel is held against that plain version on the card
(tests/test_torch_cuda.py). Planted pairs sit at cosine 0.995 (copies) and
0.985 (near misses) around tau = 0.99, and every test first checks that no
pair lies within 1e-5 of tau: the f32 sums of the two packages differ only
in their order (~1e-7), so the ids must then be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmrs_tpu.ops import allpairs as j_allpairs
from mmrs_tpu_torch.ops import allpairs

torch.set_num_threads(2)
TAU = 0.99


@pytest.fixture(autouse=True, scope="module")
def _cpu_device():
    """The port's entry points run on the card unless asked for the CPU;
    these tests ask for it, once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMRS_TORCH_DEVICE", "cpu")
        yield


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _near(rng, src, cos):
    """A unit row at exactly `cos` to the unit row `src`."""
    z = rng.standard_normal(src.shape)
    z -= (z @ src) * src
    z /= np.linalg.norm(z)
    return cos * src + np.sqrt(1.0 - cos * cos) * z


def _planted(seed, n, m, d, intra, plant=True):
    """(a [n, d], b [m, d]) f32 with copies at 0.995, near misses at 0.985
    and, within a, a chain A~B, B~C with A !~ C."""
    rng = np.random.default_rng(seed)
    a = _unit_rows(rng, n, d)
    b = a if intra else _unit_rows(rng, m, d)
    if plant:
        pos = rng.permutation(n)
        for k in range(0, 8, 2):                      # copies, any order
            a[pos[k + 1]] = _near(rng, b[pos[k] % m], 0.995)
        for k in range(8, 12, 2):                     # near misses
            a[pos[k + 1]] = _near(rng, b[pos[k] % m], 0.985)
        a[pos[12]] = b[pos[13] % m]                   # an exact copy
        if intra:                                     # chain in one plane
            e0, e1 = a[pos[14]], _near(rng, a[pos[14]], 0.0)
            t = np.arccos(0.995)
            a[pos[15]] = np.cos(t) * e0 + np.sin(t) * e1
            a[pos[16]] = np.cos(2 * t) * e0 + np.sin(2 * t) * e1
        if not intra:                                 # the last column only
            a[pos[17]] = _near(rng, b[m - 1], 0.995)
    return a.astype(np.float32), (a if intra else b).astype(np.float32)


def _as(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else
                       jnp.float32)


def _clear_of_tau(a, b, dtype):
    """No pair's similarity (of the values both packages see) is within
    1e-5 of tau, so f32 sum order cannot flip a decision."""
    av = _as(a, dtype).double().numpy()
    bv = _as(b, dtype).double().numpy()
    gap = float(np.abs(av @ bv.T - TAU).min())
    assert gap > 1e-5, gap


CASES = [  # name, n, m, d, dtype, intra, row_offset, col_offset
    ("cross", 200, 130, 24, "float32", False, 0, 0),
    ("cross", 130, 200, 512, "bfloat16", False, 0, 0),
    ("intra", 150, 150, 24, "float32", True, 0, 0),
    ("intra", 150, 150, 512, "float32", True, 0, 0),
    ("intra", 150, 150, 512, "bfloat16", True, 0, 0),
    # a ring block: global rows 100.., columns 37..
    ("offsets", 150, 100, 24, "float32", True, 100, 37),
    ("offsets", 150, 100, 512, "bfloat16", True, 100, 37),
    ("cross offsets", 70, 90, 24, "float32", False, 64, 128),
]


def _case_inputs(name, n, m, d, intra, row_offset):
    if name == "offsets":    # rows 100..249 against columns 37..136
        rng = np.random.default_rng(7)
        x = _unit_rows(rng, 300, d)
        x[120] = x[40]                              # column before the row
        x[200] = _near(rng, x[130], 0.995)
        x[110] = _near(rng, x[115], 0.995)          # 115 matches 110 only
        x[230] = _near(rng, x[90], 0.985)           # near miss
        x = x.astype(np.float32)
        return x[row_offset:row_offset + n], x[37:37 + m]
    return _planted(n + d, n, m, d, intra)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("name,n,m,d,dtype,intra,row_offset,col_offset",
                         CASES)
def test_first_match_matches_jax(jax_impl, name, n, m, d, dtype, intra,
                                 row_offset, col_offset):
    a, b = _case_inputs(name, n, m, d, intra, row_offset)
    _clear_of_tau(a, b, dtype)
    want = np.asarray(j_allpairs.first_match(
        _jax(a, dtype), _jax(b, dtype), TAU, intra=intra,
        row_offset=row_offset, col_offset=col_offset, impl=jax_impl,
        tile=64))
    got = allpairs.first_match(_as(a, dtype), _as(b, dtype), TAU,
                               intra=intra, row_offset=row_offset,
                               col_offset=col_offset)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() >= 3


@pytest.mark.parametrize("rows_per_block", [1, 7, 64])
def test_plain_row_blocks_do_not_change_the_answer(monkeypatch,
                                                   rows_per_block):
    a, b = _planted(3, 150, 150, 24, True)
    want = np.asarray(j_allpairs.first_match(jnp.asarray(a), jnp.asarray(b),
                                             TAU, intra=True, impl="xla"))
    monkeypatch.setattr(allpairs, "PLAIN_BLOCK_BYTES",
                        4 * 150 * rows_per_block)
    got = allpairs.first_match(torch.from_numpy(a), torch.from_numpy(b),
                               TAU, intra=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,dtype", [(24, "float32"), (512, "bfloat16")])
def test_no_matches_gives_all_minus_one(d, dtype):
    a, b = _planted(11, 90, 70, d, False, plant=False)
    _clear_of_tau(a, b, dtype)
    want = np.asarray(j_allpairs.first_match(
        _jax(a, dtype), _jax(b, dtype), TAU, impl="pallas_interpret",
        tile=64))
    got = allpairs.first_match(_as(a, dtype), _as(b, dtype), TAU)
    assert (want == -1).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_tau_is_rounded_to_f32_like_the_reference():
    # a pair at exactly the f32 value of tau matches; tau just above the
    # f32 value (still the same f32) matches too
    a = np.zeros((2, 8), np.float32)
    a[:, 0] = 1.0
    tau = float(np.float32(1.0)) + 1e-12
    want = np.asarray(j_allpairs.first_match(jnp.asarray(a), jnp.asarray(a),
                                             tau, intra=True, impl="xla"))
    got = allpairs.first_match(torch.from_numpy(a), torch.from_numpy(a),
                               tau, intra=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [-1, 0]


def test_empty_sides():
    a = torch.zeros((0, 8))
    b = torch.ones((5, 8))
    assert allpairs.first_match(a, b, 0.5).shape == (0,)
    assert allpairs.first_match(b, a, 0.5).tolist() == [-1] * 5


@pytest.mark.parametrize("d", [24, 512])
def test_dedup_groups_matches_jax(d):
    a, _ = _planted(5, 150, 150, d, True)
    fm = np.asarray(j_allpairs.first_match(jnp.asarray(a), jnp.asarray(a),
                                           TAU, intra=True, impl="xla"))
    got = allpairs.first_match(torch.from_numpy(a), torch.from_numpy(a),
                               TAU, intra=True)
    keepers, keeper_of = allpairs.dedup_groups(got)
    assert (keepers, keeper_of) == j_allpairs.dedup_groups(fm)
    assert len(keeper_of) >= 4 and len(keepers) + len(keeper_of) == 150


def test_kernel_path_refuses_cpu_tensors_and_unknown_impl():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        allpairs._first_match_cuda(a, a, 0.5, False, 0, 0)
    with pytest.raises(ValueError, match="impl"):
        allpairs.first_match(a, a, 0.5, impl="pallas")


# -- the kernel's f32 route: an exact bf16 split, six products ------------------

def _mixed_rows(seed, n, d, spread):
    """f32 rows, a quarter of whose entries are scaled by 10^(-spread u),
    u uniform in [0, 1): magnitudes down to 10^-spread of the rest."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    scale = np.where(rng.random((n, d)) < 0.25,
                     10.0 ** (-spread * rng.random((n, d))), 1.0)
    x *= scale
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed,n,d,spread", [
    (0, 256, 512, 0), (1, 128, 768, 6), (2, 64, 40, 12), (3, 1, 8, 30)])
def test_split_bf16x3_sums_back_to_the_row_bit_for_bit(seed, n, d, spread):
    x = _mixed_rows(seed, n, d, spread)
    planes = allpairs.split_bf16x3(torch.from_numpy(x))
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, n, d)
    hi, mid, lo = planes.float()
    assert torch.equal((hi + mid) + lo, torch.from_numpy(x))
    # each plane is the rounding of what the ones before it leave
    assert torch.equal(hi, torch.from_numpy(x).bfloat16().float())
    r1 = torch.from_numpy(x) - hi
    assert torch.equal(mid, r1.bfloat16().float())
    assert torch.equal(lo, (r1 - mid).bfloat16().float())


def test_split_products_are_six_of_the_nine_smallest_first():
    prods = allpairs.SPLIT_PRODUCTS
    assert len(prods) == 6 == len(set(prods))
    # dropped: mid.lo, lo.mid, lo.lo; plane i is about 2^-8i of the row
    assert set(prods) == {(i, j) for i in range(3) for j in range(3)
                          if i + j <= 2}
    order = [i + j for i, j in prods]
    assert order == sorted(order, reverse=True)


@pytest.mark.parametrize("seed,n,m,d,spread", [
    (0, 64, 80, 512, 0), (1, 48, 48, 768, 6), (2, 40, 24, 8, 6),
    (3, 32, 32, 512, 12)])
def test_six_term_dot_is_within_the_bound_of_an_f64_dot(seed, n, m, d,
                                                        spread):
    a = _mixed_rows(seed, n, d, spread)
    b = _mixed_rows(seed + 100, m, d, spread)
    pa = allpairs.split_bf16x3(torch.from_numpy(a)).double().numpy()
    pb = allpairs.split_bf16x3(torch.from_numpy(b)).double().numpy()
    six = sum(pa[i] @ pb[j].T for i, j in allpairs.SPLIT_PRODUCTS)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    bound = 3 * 2.0 ** -24 * (np.abs(a.astype(np.float64))
                              @ np.abs(b.astype(np.float64)).T)
    assert (np.abs(six - exact) <= bound).all()
    # the gap is the three dropped products, and bf16 products are exact
    dropped = sum(pa[i] @ pb[j].T for i in range(3) for j in range(3)
                  if (i, j) not in allpairs.SPLIT_PRODUCTS)
    np.testing.assert_allclose(six + dropped, exact, rtol=0, atol=1e-15)


@pytest.mark.parametrize("n,m,d,dtype,planes,k_step", [
    (131_072, 131_072, 512, torch.float32, 3, 32),    # dedup bench
    (131_072, 16_384, 512, torch.float32, 3, 32),     # leakage
    (131_072, 131_072, 512, torch.bfloat16, 1, 64),
    (577, 300, 768, torch.float32, 3, 32),
    (1, 0, 8, torch.bfloat16, 1, 64),
])
def test_first_match_plan_accepts_what_the_kernel_runs(n, m, d, dtype,
                                                       planes, k_step):
    plan = allpairs.first_match_plan(n, m, d, dtype)
    assert (plan.planes, plan.k_step) == (planes, k_step)
    assert (plan.tile_m, plan.tile_n) == (128, 256)
    # a ring stage holds every plane's A and B tile; the ring and the
    # 1024-byte tile alignment fit an SM's 227 KB of shared memory
    smem = allpairs.SMEM_BYTES[planes]
    assert smem == plan.stages * planes * (128 + 256) * 2 * k_step + 1024
    assert smem <= 232448


@pytest.mark.parametrize("n,m,d,dtype,match", [
    (10, 10, 12, torch.float32, "D % 8"),
    (10, 10, 4, torch.bfloat16, "D % 8"),
    (10, 10, 16, torch.float16, "f32 or bf16"),
    (2 ** 31, 10, 16, torch.float32, "N, M < 2"),
    (10, 2 ** 31, 16, torch.bfloat16, "N, M < 2"),
])
def test_first_match_plan_refuses_what_the_kernel_cannot_run(n, m, d, dtype,
                                                             match):
    with pytest.raises(ValueError, match=match):
        allpairs.first_match_plan(n, m, d, dtype)


# -- decisions near tau: the f32 route must keep f32 precision ---------------------

def _near_tau_rows(seed, n, d, margin):
    """f32 unit rows with n // 8 copies at cosines f32(0.99) + margin and
    - margin in turn: made in f64 and rounded once to f32, which moves a
    cosine by about 1e-8."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    perm = rng.permutation(n)
    p = n // 8
    src, dup = perm[:p], perm[p:2 * p]
    cos = float(np.float32(0.99)) + margin * np.where(np.arange(p) % 2, -1, 1)
    z = rng.standard_normal((p, d))
    z -= (z * x[src]).sum(1, keepdims=True) * x[src]
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    x[dup] = cos[:, None] * x[src] + np.sqrt(1 - cos * cos)[:, None] * z
    return x.astype(np.float32)


def _intra_first(scores, band=0.0):
    """Keep-first first match of an [n, n] score matrix at f32(0.99), and
    the rows no earlier score within `band` of tau leaves undecided."""
    tau = float(np.float32(0.99))
    n = scores.shape[0]
    counts = np.arange(n)[None, :] < np.arange(n)[:, None]
    hit = counts & (scores >= tau)
    first = np.where(hit.any(1), hit.argmax(1), -1)
    clear = ~(counts & (np.abs(scores - tau) <= band)).any(1)
    return first, clear


@pytest.mark.parametrize("seed,d", [(0, 512), (1, 768)])
def test_near_tau_pairs_tell_f32_sums_from_shorter_ones(seed, d):
    """Copies 2e-6 either side of tau: the plain version's f32 sums and the
    kernel's six plane products (exact products, summed here in f64) decide
    every row as the f64 dot does; bf16 rows (hi.hi alone) and a sum
    without hi.mid do not, so a check on these rows catches a kernel that
    loses f32 precision."""
    x = _near_tau_rows(seed, 1024, d, 2e-6)
    x64 = x.astype(np.float64)
    want, clear = _intra_first(x64 @ x64.T, band=5e-7)
    assert clear.all() and (want >= 0).sum() >= 1024 // 16
    t = torch.from_numpy(x)
    got = allpairs.first_match(t, t, 0.99, intra=True)
    np.testing.assert_array_equal(got.numpy(), want)
    planes = allpairs.split_bf16x3(t).double().numpy()
    six = sum(planes[i] @ planes[j].T for i, j in allpairs.SPLIT_PRODUCTS)
    np.testing.assert_array_equal(_intra_first(six)[0], want)
    five = six - planes[0] @ planes[1].T
    assert (_intra_first(five)[0] != want).any()
    hi = planes[0]
    assert (_intra_first(hi @ hi.T)[0] != want).any()
    b = t.bfloat16()
    assert (allpairs.first_match(b, b, 0.99, intra=True).numpy()
            != want).any()
