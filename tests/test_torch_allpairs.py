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
        allpairs.first_match(a, a, 0.5, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        allpairs.first_match(a, a, 0.5, impl="pallas")
