"""psi_tpu_torch.ops.fm_trie / fm against psi_tpu.ops.fm_trie / fm: the
host schedule, plain-wire prepare and ftab are array-equal; trie_search
through both level routes equals psi_tpu's trie_search with and without
its Pallas kernels (interpret mode), for fused 0 and 1, and the two-pass
route with lo and hi ranked in separate launches (pair=False) equals
psi_tpu's PSI_RANK4_PAIR=0 route; expand_locate equals
_expand_locate_device. int32/int64 throughout: equality is exact."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as jfm
from psi_tpu.ops import fm_fused as jfused
from psi_tpu.ops import fm_stream as jfs
from psi_tpu.ops import fm_trie as jtrie
from psi_tpu_torch import convert
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_stream, fm_trie
from tests.test_torch_cuda import SCHEDULE_CASES, schedule_case

CPU = torch.device("cpu")
K = 12
FTAB_P = 5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(17)
    s = "".join(rng.choice(list("ACGT"), size=45_000))
    fm = FMIndex.build_from_strings([s[::-1], s[3_000:9_000][::-1]])
    lut = {c: i for i, c in enumerate("ACGT")}
    present = [
        sum(lut[ch] << (2 * (K - 1 - j)) for j, ch in enumerate(s[p:p + K]))
        for p in range(0, len(s) - K, 41)
    ]
    keys = np.unique(np.concatenate([
        rng.randint(0, 4 ** K, size=2500).astype(np.uint64),
        np.asarray(present, dtype=np.uint64),
    ]))
    return fm, keys, jfm.build_ftab(fm, FTAB_P)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("level", [0, FTAB_P])
def test_build_schedule_matches(setup, level):
    _, keys, _ = setup
    for got, want in (
        (fm_trie.build_schedule(keys, K, level),
         jtrie.build_schedule(keys, K, level)),
        (fm_trie._build_schedule_np(keys, K), jtrie._build_schedule_np(keys, K)),
    ):
        assert got.sizes == want.sizes and got.k == want.k
        for a, b in zip(got.parents + got.chars, want.parents + want.chars):
            _eq(a, b)
        _eq(got.leaf_perm, want.leaf_perm)
        assert (got.frontier_rows is None) == (want.frontier_rows is None)
        if got.frontier_rows is not None:
            _eq(got.frontier_rows, want.frontier_rows)
    _eq(fm_trie._frontier_at(keys, K, FTAB_P)[1],
        jtrie._frontier_at(keys, K, FTAB_P)[1])


def test_prepare_matches_plain_wire(setup):
    _, keys, ftab = setup
    for ft in (None, ftab):
        got = fm_trie.prepare(keys, K, ft, device=CPU)
        want = jtrie.prepare(keys, K, ft, to_device=False, wire="plain",
                             pack=False)
        _eq(got.parents, want.parents)
        _eq(got.chars, want.chars)
        _eq(got.leaf_perm, want.leaf_perm)
        assert got.n == want.n
        for a, b in ((got.lo0, want.lo0), (got.hi0, want.hi0)):
            assert (a is None) == (b is None)
            if a is not None:
                _eq(a, b)
        conv = convert.prepared_trie(want, CPU)
        for a, b in zip(conv, got):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)


@pytest.mark.parametrize("p", [1, FTAB_P])
def test_build_ftab_matches(setup, p):
    fm, _, _ = setup
    _eq(fm_ops.build_ftab(fm, p), jfm.build_ftab(fm, p))


@pytest.fixture
def small_kernels(monkeypatch):
    """psi_tpu's Pallas kernels with one 1024-position slab per grid step
    and one unrolled parent window (PSI_SLABS, PSI_FSLABS,
    PSI_FUSED_PUNROLL, read at import): the same results, and traces
    small enough for interpret mode. Reloaded back afterwards."""
    for name in ("PSI_SLABS", "PSI_FSLABS", "PSI_FUSED_PUNROLL"):
        monkeypatch.setenv(name, "1")
    importlib.reload(jfs)
    importlib.reload(jfused)
    yield
    for name in ("PSI_SLABS", "PSI_FSLABS", "PSI_FUSED_PUNROLL"):
        monkeypatch.delenv(name)
    importlib.reload(jfs)
    importlib.reload(jfused)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("fused", ["0", "1"])
def test_trie_search_matches_psi_tpu(setup, small_kernels, monkeypatch,
                                     use_pallas, fused):
    fm, keys, ftab = setup
    monkeypatch.setenv("PSI_TRIE_FUSED", fused)
    jarr = jfs.build_stream_arrays(fm)
    prep = jtrie.prepare(keys, K, ftab, wire="plain", pack=False)
    want_lo, want_hi = jtrie.trie_search(
        jarr, keys, K, use_pallas=use_pallas, interpret=use_pallas,
        ftab=ftab, prepared=prep,
    )
    arr = convert.stream_arrays(jarr, CPU)
    for route_fused in (True, False):
        lo, hi = fm_trie.trie_search(arr, keys, K, ftab=ftab,
                                     fused=route_fused)
        _eq(lo, want_lo)
        _eq(hi, want_hi)
    assert (want_hi > want_lo).sum() > 100


def test_trie_search_unpaired_matches_psi_tpu(setup, small_kernels,
                                             monkeypatch):
    """pair=False (rank4_stream at lo, then at hi, then compact, per level)
    against psi_tpu's scan route with PSI_RANK4_PAIR=0 on its Pallas
    kernels; PSI_TRIE_FUSED=0 keeps psi_tpu off its fused kernel. The
    variables are read while tracing, so jit caches are cleared first."""
    fm, keys, ftab = setup
    monkeypatch.setenv("PSI_RANK4_PAIR", "0")
    monkeypatch.setenv("PSI_TRIE_FUSED", "0")
    jax.clear_caches()
    jarr = jfs.build_stream_arrays(fm)
    prep = jtrie.prepare(keys, K, ftab, wire="plain", pack=False)
    want_lo, want_hi = jtrie.trie_search(
        jarr, keys, K, use_pallas=True, interpret=True, ftab=ftab,
        prepared=prep,
    )
    jax.clear_caches()
    arr = convert.stream_arrays(jarr, CPU)
    n0 = fm_stream.rank4_stream.launches
    lo, hi = fm_trie.trie_search(arr, keys, K, ftab=ftab, fused=False,
                                 pair=False)
    assert fm_stream.rank4_stream.launches == n0       # CPU: plain version
    np.testing.assert_array_equal(hi - lo, want_hi - want_lo)
    found = want_hi > want_lo
    assert found.sum() > 100
    np.testing.assert_array_equal(lo[found], want_lo[found])


@pytest.mark.parametrize("gocc", [0, 5])
def test_expand_locate_matches(gocc):
    rng = np.random.RandomState(9)
    s = "".join(rng.choice(list("ACGT"), size=6_000))
    strings = [s, s[1_000:4_000], s[2_500:5_000] + s[:500]]
    fm = FMIndex.build_from_strings([x[::-1] for x in strings])
    lengths = fm.lengths.astype(np.int64)
    seq_off = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=seq_off[1:])
    starts = np.arange(0, int(seq_off[-1]), 97, dtype=np.int64)
    path_map = {"seq_off": seq_off, "starts": starts,
                "ids": np.arange(1, len(starts) + 1),
                "base": np.zeros(len(starts), dtype=np.int64)}
    jfa = jfm.to_device(fm)
    jmaps = jfm.map_to_device(fm, path_map)

    npad, n_leaves = 8192, 7000
    counts = rng.choice([0, 0, 1, 2, 3, 7, 30], size=npad)
    lo = rng.randint(0, fm.size - 30, size=npad).astype(np.int32)
    hi = (lo + counts).astype(np.int32)
    thr = gocc or np.iinfo(np.int32).max
    w = np.where((np.arange(npad) < n_leaves) & (counts <= thr), counts, 0)
    total = int(w.sum())
    cap = 1 << (total - 1).bit_length()
    want, want_total = jtrie._expand_locate_device(
        jfa.sa, jmaps.str_starts, jmaps.lengths, jmaps.seq_off,
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(n_leaves, jnp.int32),
        jnp.asarray(thr, jnp.int32), K, cap,
    )
    sa = convert.fm_sa(jfa, CPU)
    _eq(sa, fm_ops.to_device(fm, CPU).sa)
    maps = convert.map_arrays(jmaps, CPU)
    for a, b in zip(maps, fm_ops.map_to_device(fm, path_map, CPU)):
        assert torch.equal(a, b)
    for c in (cap, total):
        got, got_total = fm_trie.expand_locate(
            sa, maps.str_starts, maps.lengths, maps.seq_off,
            torch.from_numpy(lo), torch.from_numpy(hi), n_leaves, thr, K, c,
        )
        assert int(got_total) == int(want_total) == total
        _eq(got, np.asarray(want)[:c])


@pytest.mark.parametrize("name", SCHEDULE_CASES)
def test_trie_schedule_plain_matches_host(name):
    """The card schedule's plain version against the native host schedule
    (`prepare`'s CPU route), `_build_schedule_np` and psi_tpu's plain-wire
    plan, slot for slot: every level's parents and chars and its size,
    the padding, leaf_perm, and the level-p frontier (the ftab here is
    its row index and a function of it, so lo0 holds the frontier's
    rows)."""
    keys, k, p, ftab = schedule_case(name)
    npad = fm_trie._npad(len(keys), None)
    parents, chars, lo0, hi0, leaf = fm_trie.trie_schedule(
        torch.from_numpy(keys.view(np.int64)), k, p,
        None if ftab is None else torch.from_numpy(ftab), npad)
    host = fm_trie.prepare(keys, k, ftab, device=CPU)
    assert parents.shape == chars.shape == (k - p, npad)
    assert torch.equal(parents, host.parents)
    assert torch.equal(chars, host.chars)
    _eq(leaf.long(), host.leaf_perm)
    for a, b in ((lo0, host.lo0), (hi0, host.hi0)):
        assert (a is None) == (b is None) == (p == 0)
        if a is not None:
            assert torch.equal(a, b)
    want = jtrie.prepare(keys, k, ftab, to_device=False, wire="plain",
                         pack=False)
    assert want.n == len(keys)
    for a, b in ((parents, want.parents), (chars, want.chars),
                 (lo0, want.lo0), (hi0, want.hi0), (leaf, want.leaf_perm)):
        assert (a is None) == (b is None)
        if a is not None:
            _eq(a, b)
    ref = fm_trie._build_schedule_np(keys, k)
    _eq(leaf, ref.leaf_perm)
    for j in range(p, k):
        f = ref.sizes[j]
        _eq(parents[j - p, :f], ref.parents[j])
        _eq(chars[j - p, :f], ref.chars[j])
        assert (parents[j - p, f:] == parents[j - p, f - 1]).all()
        assert (chars[j - p, f:] == chars[j - p, f - 1]).all()
    if p:
        kpref, order = fm_trie._frontier_at(keys, k, p)
        f = len(kpref)
        _eq(lo0[:f], kpref[order])
        _eq(hi0[:f], 3 * kpref[order] + 1)
        assert (lo0[f:] == lo0[f - 1]).all() and (hi0[f:] == hi0[f - 1]).all()
