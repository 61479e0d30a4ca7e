"""psi_tpu_torch.ops.fm_pallas against psi_tpu.ops.fm_pallas: the Pallas
occ-row gathers run in interpret mode, as tests/test_pallas.py runs them,
against the port's gather (its plain version on the CPU) on the padded
[n+1, 8] table, and the port's gather on the dense [n+1, 4] layout; and
the LF step (`lf_pair`, its plain version on the CPU) against one step of
psi_tpu's Pallas backward search. Integer results: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as jfm
from psi_tpu.ops import fm_pallas as jfp
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_pallas

CPU = torch.device("cpu")
SIZES = (1, 64, 700, 2500)


@pytest.fixture(scope="module")
def fm():
    rng = np.random.RandomState(5)
    strings = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(4)]
    return FMIndex.build_from_strings([s[::-1] for s in strings])


@pytest.fixture(scope="module")
def occ8(fm):
    return jfp.occ_dense_padded(fm)


def test_occ_dense_padded_matches_psi_tpu(fm, occ8):
    got = fm_pallas.occ_dense_padded(fm)
    np.testing.assert_array_equal(got, occ8)
    assert got.dtype == np.int32 and got.shape == (fm.size + 1, 8)
    dense = fm_ops.to_device(fm, CPU, dense_occ=True).occ_dense
    np.testing.assert_array_equal(dense.numpy(), occ8[:, :4])


@pytest.mark.parametrize("M", SIZES)
def test_gather_occ_rows_matches_pallas(fm, occ8, M):
    pos = np.random.RandomState(M).randint(0, fm.size + 1, M).astype(np.int32)
    want = np.asarray(jfp.gather_occ_rows(jnp.asarray(occ8), jnp.asarray(pos),
                                          interpret=True))
    n0 = fm_pallas.gather_occ_rows.launches
    for table in (occ8, np.ascontiguousarray(occ8[:, :4])):
        got = fm_pallas.gather_occ_rows(torch.from_numpy(table),
                                        torch.from_numpy(pos))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want[:, : table.shape[1]])
    assert fm_pallas.gather_occ_rows.launches == n0   # CPU: plain version


@pytest.mark.parametrize("M", SIZES)
def test_gather_occ_rows_blocked_matches_pallas(fm, occ8, M):
    pos = np.random.RandomState(7 + M).randint(0, fm.size + 1, M
                                               ).astype(np.int32)
    pos[: M // 3] = pos[0]                  # repeated pointers stay stable
    want = jfp.gather_occ_rows_blocked(occ8, pos, interpret=True)
    got = fm_pallas.gather_occ_rows_blocked(occ8, pos, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_backward_search_pallas_matches_psi_tpu(fm, occ8):
    """psi_tpu's Pallas backward search (interpret mode) and its XLA
    backward_search_codes against the port's on the padded table."""
    codes = np.random.RandomState(2).randint(1, 5, (48, 11)).astype(np.int32)
    C = fm.C.astype(np.int32)
    jlo, jhi = jfp.backward_search_pallas(
        jnp.asarray(occ8), jnp.asarray(C), jnp.asarray(fm.size, jnp.int32),
        jnp.asarray(codes), interpret=True)
    n0 = fm_pallas.gather_occ_rows.launches
    lo, hi = fm_pallas.backward_search_pallas(
        torch.from_numpy(occ8), torch.from_numpy(C), fm.size,
        torch.from_numpy(codes))
    assert fm_pallas.gather_occ_rows.launches == n0   # CPU: plain version
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    xlo, xhi = jfm.backward_search_codes(jfm.to_device(fm), jnp.asarray(codes))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(xlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(xhi))
    with pytest.raises(ValueError, match="ACGT codes 1..4"):
        fm_pallas.backward_search_pallas(
            torch.from_numpy(occ8), torch.from_numpy(C), fm.size,
            torch.zeros((2, 3), dtype=torch.int32))


@pytest.fixture(scope="module")
def pallas_steps(fm, occ8):
    """psi_tpu's Pallas backward search (interpret mode) of the first j
    columns of one code matrix, for j = 0..K: the ranges after each
    step."""
    codes = np.random.RandomState(8).randint(1, 5, (40, 6)).astype(np.int32)
    C = fm.C.astype(np.int32)
    steps = [(np.zeros(len(codes), np.int32),
              np.full(len(codes), fm.size, np.int32))]
    for j in range(1, codes.shape[1] + 1):
        jlo, jhi = jfp.backward_search_pallas(
            jnp.asarray(occ8), jnp.asarray(C), jnp.asarray(fm.size, jnp.int32),
            jnp.asarray(codes[:, :j]), interpret=True)
        steps.append((np.array(jlo), np.array(jhi)))
    return codes, C, steps


@pytest.mark.parametrize("width", [8, 4])
def test_lf_pair_matches_pallas_step(occ8, pallas_steps, width):
    """lf_pair_plain from psi_tpu's ranges after j steps gives psi_tpu's
    ranges after j + 1, on psi_tpu's padded W=8 table and on the port's
    W=4 layout; the wrapper takes the plain version on the CPU."""
    codes, C, steps = pallas_steps
    occ = torch.from_numpy(np.ascontiguousarray(occ8[:, :width]))
    Ct = torch.from_numpy(C)
    n0 = fm_pallas.lf_pair.launches
    for j in range(codes.shape[1]):
        c = torch.from_numpy(np.ascontiguousarray(codes[:, j]))
        lo, hi = (torch.from_numpy(a) for a in steps[j])
        want = steps[j + 1]
        for got in (fm_pallas.lf_pair_plain(occ, Ct, c, lo, hi),
                    fm_pallas.lf_pair(occ, Ct, c, lo, hi)):
            assert got[0].dtype == got[1].dtype == torch.int32
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert fm_pallas.lf_pair.launches == n0           # CPU: plain version
    assert (steps[-1][1] > steps[-1][0]).any()
