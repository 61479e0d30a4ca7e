"""psi_tpu_torch.ops.fm against psi_tpu.ops.fm on identical state (carried
by psi_tpu_torch.convert.fm_arrays): the device layouts, keys_to_codes,
backward_search_codes on each rank layout with and without the ftab,
find_mems_device, locate_ranges, locate_map_device and count_kmers_device.
Everything is integer: equality is exact, and for SA ranges (R3) `hi - lo`
everywhere and `lo` where the range is not empty."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as jfm
from psi_tpu_torch import convert
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_pallas

CPU = torch.device("cpu")
K = 10
P = 4
LAYOUTS = ("checkpointed", "bitplane", "dense")


@pytest.fixture(scope="module")
def fm():
    """Two strings over ACGT with a few N, indexed reversed as the path
    index is: 21,000 characters, so positions cross many 128-blocks."""
    rng = np.random.RandomState(5)
    strings = ["".join(rng.choice(list("ACGTN"), size=n,
                                  p=[0.24, 0.24, 0.24, 0.24, 0.04]))
               for n in (12_000, 9_000)]
    return FMIndex.build_from_strings([s[::-1] for s in strings])


@pytest.fixture(scope="module")
def jarrays(fm):
    return jfm.to_device(fm, dense_occ=True, bitplanes=True, ftab_bits=P)


def _layout(arrays, layout: str, ftab: bool):
    """The same arrays seen as one rank layout (backward_search_codes and
    find_mems_device pick dense, then bit-planes, then checkpointed)."""
    if layout != "dense":
        arrays = arrays._replace(occ_dense=None)
    if layout == "checkpointed":
        arrays = arrays._replace(planes=None)
    return arrays if ftab else arrays._replace(ftab=None)


def _codes(fm, rng, n_present=700, n_random=1300, k=K):
    """Code rows (fed first to last, so a present row spells a reversed
    substring of the text) of present and random k-mers, N-free."""
    text = fm.codes[: fm.str_starts[1] - 1]
    starts = rng.randint(0, len(text) - k, n_present)
    present = text[starts[:, None] + np.arange(k)][:, ::-1]
    present = present[((present >= 1) & (present <= 4)).all(1)]
    return np.concatenate([present, rng.randint(1, 5, (n_random, k))]
                          ).astype(np.int32)


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def test_layout_arrays_match_psi_tpu(fm, jarrays):
    """Every array of every layout, from the port's to_device and through
    convert.fm_arrays."""
    got = fm_ops.to_device(fm, CPU, dense_occ=True, bitplanes=True,
                           ftab_bits=P)
    for arr in (got, convert.fm_arrays(jarrays, CPU)):
        for name in ("bwt_blocks", "occ", "C", "sa", "occ_dense", "ftab"):
            _eq(getattr(arr, name), getattr(jarrays, name))
        np.testing.assert_array_equal(arr.planes.numpy().view(np.uint32),
                                      np.asarray(jarrays.planes))
        assert arr.n == jarrays.n
        assert arr.bwt_blocks.dtype == torch.uint8
    plain = fm_ops.to_device(fm, CPU)
    assert plain.occ_dense is None and plain.planes is None
    assert plain.ftab is None
    _eq(plain.bwt_blocks, jarrays.bwt_blocks)


def test_keys_to_codes_matches_psi_tpu():
    keys = np.random.RandomState(1).randint(0, 4 ** 16, 500).astype(np.uint64)
    got = fm_ops.keys_to_codes(keys, 16)
    np.testing.assert_array_equal(got, jfm.keys_to_codes(keys, 16))
    assert got.dtype == np.int32 and got.min() >= 1 and got.max() <= 4


@pytest.mark.parametrize("ftab", [False, True], ids=["ftab0", f"ftab{P}"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_search_codes_matches_psi_tpu(fm, jarrays, layout, ftab):
    codes = _codes(fm, np.random.RandomState(12))
    src = _layout(jarrays, layout, ftab)
    jlo, jhi = jfm.backward_search_codes(src, jnp.asarray(codes))
    jlo, jhi = np.asarray(jlo), np.asarray(jhi)
    n0 = fm_pallas.gather_occ_rows.launches
    lo, hi = fm_ops.backward_search_codes(convert.fm_arrays(src, CPU),
                                          torch.from_numpy(codes))
    assert fm_pallas.gather_occ_rows.launches == n0    # CPU: plain version
    assert lo.dtype == hi.dtype == torch.int32
    np.testing.assert_array_equal((hi - lo).numpy(), jhi - jlo)
    found = jhi > jlo
    assert found.sum() > 300
    np.testing.assert_array_equal(lo.numpy()[found], jlo[found])
    for i in np.random.RandomState(3).choice(len(codes), 25, replace=False):
        s = "".join("ACGT"[c - 1] for c in codes[i])
        want_lo, want_hi = fm.backward_search(s[::-1])
        assert int(hi[i] - lo[i]) == want_hi - want_lo


@pytest.mark.parametrize("bad", [0, 5])
def test_backward_search_codes_rejects_non_acgt(fm, bad):
    arrays = fm_ops.to_device(fm, CPU, dense_occ=True)
    codes = torch.ones((4, K), dtype=torch.int32)
    codes[2, 3] = bad
    with pytest.raises(ValueError, match="ACGT codes 1..4"):
        fm_ops.backward_search_codes(arrays, codes)


def _reads(fm, rng, n=120, L=60):
    """Code rows of reads: substrings of the text (so MEMs exist) with
    substitutions, 'N' (code 0), and reads shorter than L (zero pad)."""
    text = fm.codes[: fm.str_starts[1] - 1].astype(np.int32)
    starts = rng.randint(0, len(text) - L, n)
    codes = text[starts[:, None] + np.arange(L)]
    codes = np.where(codes > 4, 0, codes)
    sub = rng.random_sample(codes.shape) < 0.03
    codes = np.where(sub, rng.randint(1, 5, codes.shape), codes)
    codes[rng.random_sample(codes.shape) < 0.01] = 0
    rlens = np.full(n, L, dtype=np.int32)
    rlens[::7] = rng.randint(0, L, len(rlens[::7]))
    codes[np.arange(L)[None, :] >= rlens[:, None]] = 0
    codes[5] = 0                                      # an all-N read
    return codes.astype(np.int32), rlens


@pytest.mark.parametrize("thr,max_mem", [(2**31 - 1, 2**31 - 1), (2, 3)],
                         ids=["unlimited", "thr2-max3"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_find_mems_device_matches_psi_tpu(fm, jarrays, layout, thr, max_mem):
    codes, rlens = _reads(fm, np.random.RandomState(4))
    k, max_out = 8, 60 // 9 + 2
    src = _layout(jarrays, layout, ftab=False)
    want = jfm.find_mems_device(src, jnp.asarray(codes), jnp.asarray(rlens),
                                k, jnp.asarray(thr, jnp.int32),
                                jnp.asarray(max_mem, jnp.int32), max_out)
    got = fm_ops.find_mems_device(convert.fm_arrays(src, CPU),
                                  torch.from_numpy(codes),
                                  torch.from_numpy(rlens), k, thr, max_mem,
                                  max_out)
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[4].sum()) > 50                     # MEMs were emitted


def test_locate_ranges_matches_psi_tpu(fm, jarrays):
    rng = np.random.RandomState(6)
    lo = rng.randint(0, fm.size, 400).astype(np.int32)
    hi = np.minimum(lo + rng.choice([0, 1, 5, 33], 400), fm.size
                    ).astype(np.int32)
    jpos, jmask = jfm.locate_ranges(jarrays, jnp.asarray(lo), jnp.asarray(hi),
                                    16)
    pos, mask = fm_ops.locate_ranges(convert.fm_arrays(jarrays, CPU),
                                     torch.from_numpy(lo),
                                     torch.from_numpy(hi), 16)
    _eq(mask, jmask)
    _eq(pos, jpos)


def test_locate_map_device_matches_psi_tpu(fm, jarrays):
    """SA indices -> (node id, node offset) through a path map of nodes
    of 1-40 characters over the two strings."""
    rng = np.random.RandomState(7)
    lengths = fm.lengths.astype(np.int64)
    seq_off = np.concatenate([[0], np.cumsum(lengths)])
    total = int(seq_off[-1])
    starts = np.unique(np.concatenate([
        [0], seq_off[1:-1], np.cumsum(rng.randint(1, 41, total // 10))]))
    starts = starts[starts < total]
    path_map = {"seq_off": seq_off, "starts": starts,
                "ids": rng.randint(1, 10 ** 6, len(starts)),
                "base": np.where(np.isin(starts, seq_off), rng.randint(0, 5),
                                 0)}
    k = 12
    # SA rows whose suffix has k characters before its string's end
    pos = fm.sa.astype(np.int64)
    sid = np.searchsorted(fm.str_starts, pos, side="right") - 1
    ok = (sid < len(lengths)) & (pos - fm.str_starts[sid] + k
                                 <= lengths[np.minimum(sid, len(lengths) - 1)])
    sa_idx = rng.choice(np.nonzero(ok)[0], 3000).astype(np.int32)
    jid, joff = jfm.locate_map_device(jarrays, jfm.map_to_device(fm, path_map),
                                      jnp.asarray(sa_idx), k)
    maps = fm_ops.map_to_device(fm, path_map, CPU)
    nid, noff = fm_ops.locate_map_device(convert.fm_arrays(jarrays, CPU),
                                         maps, torch.from_numpy(sa_idx), k)
    _eq(nid, jid)
    _eq(noff, joff)


def test_count_kmers_device_matches_psi_tpu(fm):
    rng = np.random.RandomState(8)
    codes = _codes(fm, rng, 300, 300)
    keys = np.unique(((codes.astype(np.uint64) - 1)
                      << (2 * np.arange(K - 1, -1, -1, dtype=np.uint64))
                      ).sum(axis=1, dtype=np.uint64))
    got = fm_ops.count_kmers_device(fm, keys, K, device="cpu")
    np.testing.assert_array_equal(got, jfm.count_kmers_device(fm, keys, K))
    assert (got > 0).sum() > 100
