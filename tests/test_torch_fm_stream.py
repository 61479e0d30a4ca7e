"""psi_tpu_torch.ops.fm_stream against psi_tpu.ops.fm_stream: the payload
layouts and the port's own (payloadR, payloadC); the plain versions of
the rank4_pair, rank4, compact, rank and rank_lf_pair kernels against the
Pallas kernels (interpret mode, every variant) and, at the edges of a
rank (block offsets 0 and 31, position n, ranges inside one block or
across blocks, empty ranges), against the host FM index; and
backward_search_sorted against psi_tpu's, with and without ftab seeds
and at the edges of its ranges.
Inputs are identical, given through psi_tpu_torch.convert. Everything is
int32: equality is exact, and for SA ranges (R3) `hi - lo` everywhere and
`lo` where the range is not empty."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as jfm
from psi_tpu.ops import fm_stream as jfs
from psi_tpu.ops import fm_trie as jtrie
from psi_tpu_torch import convert
from psi_tpu_torch.ops import fm_stream

CPU = torch.device("cpu")
NPAD = 8192


def _fm(seed, lengths=(12_000, 9_000), alphabet="ACGTN"):
    rng = np.random.RandomState(seed)
    p = [0.24, 0.24, 0.24, 0.24, 0.04][: len(alphabet)]
    strings = ["".join(rng.choice(list(alphabet), size=n, p=np.array(p) /
                                  sum(p))) for n in lengths]
    return FMIndex.build_from_strings([s[::-1] for s in strings])


@pytest.fixture(scope="module")
def fm():
    return _fm(5)


def _frontier(n, rng):
    """Monotone lo/hi over [0, n] with empty, small and wide ranges and
    both ends of the text (hi = n reaches the spare block)."""
    lo = np.sort(rng.randint(0, n + 1, size=NPAD)).astype(np.int32)
    width = rng.choice([0, 1, 3, 40, 900], size=NPAD)
    hi = np.minimum(lo + width, n).astype(np.int32)
    lo[0], hi[-1] = 0, n
    return lo, hi


@pytest.mark.parametrize("seed", [5, 6])
def test_payloads_match_psi_tpu(seed):
    fm = _fm(seed)
    ref = jfs.build_stream_arrays(fm)
    got = fm_stream.build_stream_arrays(fm, CPU)
    conv = convert.stream_arrays(ref, CPU)
    for arr in (got, conv):
        np.testing.assert_array_equal(arr.payloadT.numpy(),
                                      np.asarray(ref.payloadT))
        np.testing.assert_array_equal(
            fm_stream.match_format(arr.payloadT.numpy()),
            np.asarray(ref.payloadW))
        np.testing.assert_array_equal(arr.C.numpy(), np.asarray(ref.C))
        assert (arr.n, arr.nblocks) == (ref.n, ref.nblocks)


def _records_numpy(payloadT: np.ndarray) -> np.ndarray:
    """payloadR built in numpy from payloadT alone: per block, the occ
    rows of ACGT and the AND over the three bit planes (or their
    complements, by the bits of c) of its 32 positions."""
    planes = payloadT[6:9].view(np.uint32)
    rec = np.empty((payloadT.shape[1], 8), dtype=np.int32)
    rec[:, 0:4] = payloadT[1:5].T
    for c in range(1, 5):
        match = np.full(payloadT.shape[1], 0xFFFFFFFF, dtype=np.uint32)
        for p in range(3):
            match &= planes[p] if (c >> p) & 1 else ~planes[p]
        rec[:, 3 + c] = match.view(np.int32)
    return rec


@pytest.mark.parametrize("seed", [5, 6])
def test_payload_records(seed):
    """payloadR is psi_tpu's payloadW regrouped by block, equals a numpy
    build from payloadT, holds the BWT's match bits, and convert carries
    it."""
    fm = _fm(seed)
    ref = jfs.build_stream_arrays(fm)
    got = fm_stream.build_stream_arrays(fm, CPU)
    conv = convert.stream_arrays(ref, CPU)
    want = _records_numpy(got.payloadT.numpy())
    nbpad = got.payloadT.shape[1]
    w = np.asarray(ref.payloadW)
    for arr in (got, conv):
        rec = arr.payloadR.numpy()
        assert rec.shape == (nbpad, 8) and arr.payloadR.is_contiguous()
        np.testing.assert_array_equal(rec, want)
        np.testing.assert_array_equal(rec, w.transpose(0, 2, 1).reshape(-1, 8))
    bwt = np.full(nbpad * 32, 255, dtype=np.int64)
    bwt[: fm.size] = fm.bwt
    bits = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for c in range(1, 5):
        words = ((bwt.reshape(nbpad, 32) == c) * bits).sum(axis=1)
        np.testing.assert_array_equal(want[:, 3 + c].view(np.uint32), words)
    blocks = np.arange(got.nblocks)
    for c in range(1, 5):
        np.testing.assert_array_equal(
            want[blocks, c - 1], [fm.rank(c, 32 * b) for b in blocks])


@pytest.mark.parametrize("seed", [5, 6])
def test_char_words(seed):
    """payloadC is psi_tpu's payloadW regrouped by char and block: word
    (c-1, b) is (occ_c, match_c) of block b, as in payloadR; convert
    carries it."""
    fm = _fm(seed)
    ref = jfs.build_stream_arrays(fm)
    w = np.asarray(ref.payloadW)
    nbpad = w.shape[0] * w.shape[2]
    blocks = np.arange(nbpad)
    for arr in (fm_stream.build_stream_arrays(fm, CPU),
                convert.stream_arrays(ref, CPU)):
        words = arr.payloadC.numpy()
        assert words.shape == (4, nbpad, 2) and arr.payloadC.is_contiguous()
        for c in range(1, 5):
            np.testing.assert_array_equal(
                words[c - 1, :, 0], w[blocks >> 7, c - 1, blocks & 127])
            np.testing.assert_array_equal(
                words[c - 1, :, 1], w[blocks >> 7, 3 + c, blocks & 127])
            rec = arr.payloadR.numpy()
            np.testing.assert_array_equal(words[c - 1],
                                          rec[:, [c - 1, 3 + c]])


def _edge_pairs(n, rng, m=4000):
    """lo <= hi pairs at the kernels' edges: empty ranges, ranges inside
    one 32-position block, ranges that straddle one or many blocks, and
    both ends of the text (ranges ending at n, in the spare block); chars
    1..4 each."""
    lo = rng.randint(0, n + 1, size=m)
    width = rng.choice([0, 1, 3, 31, 32, 33, 200], size=m)
    hi = np.minimum(lo + width, n)
    lo[:4], hi[:4] = (0, 0, n, 0), (0, n, n, 1)
    straddle = 32 * rng.randint(1, n // 32, size=200)
    lo[4:204], hi[4:204] = straddle - 1, straddle + 1
    lo[204:216] = n - np.array([0, 1, 2, 5, 30, 31, 32, 33, 63, 64, 100, 500])
    hi[204:216] = n
    chars = np.arange(m) % 4 + 1
    return [torch.from_numpy(a.astype(np.int32)) for a in (chars, lo, hi)]


#: the edges of a rank at which `_edge_select` picks pairs
EDGES = ["offsets", "at_n", "one_block", "straddle", "empty"]


def _edge_select(edge, chars, lo, hi, n):
    """The pairs of `_edge_pairs` at one edge: an end at block offset 0
    or 31; hi at position n; lo < hi in one 32-position block; lo and hi
    in different blocks; lo == hi. Each edge has pairs of all four
    chars."""
    off_lo, off_hi = lo & 31, hi & 31
    mask = {
        "offsets": (off_lo == 0) | (off_lo == 31) | (off_hi == 0)
        | (off_hi == 31),
        "at_n": hi == n,
        "one_block": ((lo >> 5) == (hi >> 5)) & (hi > lo),
        "straddle": (lo >> 5) != (hi >> 5),
        "empty": lo == hi,
    }[edge]
    assert set(chars[mask].tolist()) == {1, 2, 3, 4}
    return chars[mask], lo[mask], hi[mask]


@pytest.mark.parametrize("edge", EDGES)
def test_rank4_plain_edges(fm, edge):
    """rank4_stream on the CPU (its plain version, over payloadR) at both
    ends of the edge pairs is the host FM index's rank of every char."""
    arr = fm_stream.build_stream_arrays(fm, CPU)
    _, lo, hi = _edge_select(edge, *_edge_pairs(fm.size,
                                                np.random.RandomState(4)),
                             fm.size)
    pos = torch.cat([lo, hi])
    n0 = fm_stream.rank4_stream.launches
    got = fm_stream.rank4_stream(arr, pos)
    assert fm_stream.rank4_stream.launches == n0        # CPU: plain version
    assert got.dtype == torch.int32 and got.shape == (4, len(pos))
    assert torch.equal(got, fm_stream.rank4_plain(arr.payloadR, pos))
    want = [[fm.rank(c, int(q)) for q in pos] for c in range(1, 5)]
    np.testing.assert_array_equal(got.numpy(), want)


def test_rank_lf_pair_plain_matches_rank(fm):
    """rank_lf_pair (its plain version on the CPU) is C[c] + rank_plain at
    lo and at hi, and the host FM index's rank."""
    arr = fm_stream.build_stream_arrays(fm, CPU)
    chars, lo, hi = _edge_pairs(fm.size, np.random.RandomState(4))
    n0 = fm_stream.rank_lf_pair.launches
    got = fm_stream.rank_lf_pair(arr, chars, lo, hi)
    assert fm_stream.rank_lf_pair.launches == n0        # CPU: plain version
    plain = fm_stream.rank_lf_pair_plain(arr, chars, lo, hi)
    base = arr.C[chars.long()]
    for g, p, pos in zip(got, plain, (lo, hi)):
        assert g.dtype == torch.int32
        assert torch.equal(g, p)
        assert torch.equal(g, base + fm_stream.rank_plain(arr.payloadT, chars,
                                                          pos))
    for i in list(range(8)) + list(np.random.RandomState(5).choice(
            len(lo), 40, replace=False)):
        c = int(chars[i])
        assert got[0][i] == fm.C[c] + fm.rank(c, int(lo[i]))
        assert got[1][i] == fm.C[c] + fm.rank(c, int(hi[i]))


@pytest.fixture(scope="module")
def small_slabs():
    """psi_tpu.ops.fm_stream with one 1024-position slab per grid step (its
    PSI_SLABS knob, read at import): the same results, and a trace small
    enough for interpret mode. The module is reloaded back afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PSI_SLABS", "1")
        try:
            yield importlib.reload(jfs)
        finally:
            mp.delenv("PSI_SLABS")
            importlib.reload(jfs)


@pytest.fixture(scope="module")
def pallas_rank4(fm, small_slabs):
    """psi_tpu's rank4_pair kernel (interpret mode) on one frontier."""
    ref = jfs.build_stream_arrays(fm)
    lo, hi = _frontier(fm.size, np.random.RandomState(1))
    jlo, jhi = jfs.rank4_pair_stream(ref, jnp.asarray(lo), jnp.asarray(hi),
                                     interpret=True)
    return ref, lo, hi, jlo, jhi


def test_rank4_pair_matches_pallas(fm, pallas_rank4):
    ref, lo, hi, jlo, jhi = pallas_rank4
    rng = np.random.RandomState(1)
    n0 = fm_stream.rank4_pair_stream.launches
    arr = convert.stream_arrays(ref, CPU)
    r4lo, r4hi = fm_stream.rank4_pair_stream(arr, torch.from_numpy(lo),
                                             torch.from_numpy(hi))
    for got, want in ((r4lo, jlo), (r4hi, jhi)):
        want = np.asarray(want).transpose(2, 0, 1, 3, 4).reshape(4, -1)
        np.testing.assert_array_equal(got.numpy(), want)
    # and against the host FM index's own rank
    for i in rng.choice(NPAD, 50, replace=False):
        for c in range(1, 5):
            assert r4hi[c - 1, i] == fm.rank(c, int(hi[i]))
    assert fm_stream.rank4_pair_stream.launches == n0  # CPU: plain version


def _level_schedule(fm, k=10, level=6, n_keys=2500, seed=2):
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(0, 4 ** k, size=n_keys).astype(np.uint64))
    prep = jtrie.prepare(keys, k, None, to_device=False, wire="plain",
                         pack=False)
    return np.asarray(prep.parents)[level], np.asarray(prep.chars)[level]


def test_compact_matches_pallas(fm, pallas_rank4, small_slabs):
    ref, _, _, jr4lo, jr4hi = pallas_rank4
    parent, char = _level_schedule(fm)
    n0 = fm_stream.compact_children.launches
    jlo, jhi = jfs.compact_children(jr4lo, jr4hi, jnp.asarray(parent),
                                    jnp.asarray(char), ref.C, interpret=True)
    flat = [torch.from_numpy(np.ascontiguousarray(
        np.asarray(r).transpose(2, 0, 1, 3, 4).reshape(4, -1)))
        for r in (jr4lo, jr4hi)]
    lo2, hi2 = fm_stream.compact_children(
        *flat, torch.from_numpy(parent), torch.from_numpy(char),
        torch.tensor(np.asarray(ref.C)))
    np.testing.assert_array_equal(lo2.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi2.numpy(), np.asarray(jhi))
    assert fm_stream.compact_children.launches == n0   # CPU: plain version


def _flat4(r4):
    """psi_tpu's [T, SLABS, 4, 8, 128] rank layout as [4, M]."""
    return np.asarray(r4).transpose(2, 0, 1, 3, 4).reshape(4, -1)


@pytest.mark.parametrize("variant", ["flat", "slab", "mxu", "resident"])
def test_rank4_matches_pallas(fm, small_slabs, monkeypatch, variant):
    """rank4_stream against each of psi_tpu's four rank4 kernels (the
    resident one needs payload8, which this small text has), at sorted
    and at scattered positions."""
    ref = small_slabs.build_stream_arrays(fm)
    assert ref.payload8 is not None
    rng = np.random.RandomState(3)
    lo, _ = _frontier(fm.size, rng)
    scattered = rng.permutation(lo)
    monkeypatch.setenv("PSI_RANK4", variant)
    arr = convert.stream_arrays(ref, CPU)
    n0 = fm_stream.rank4_stream.launches
    for pos in (lo, scattered):
        want = small_slabs.rank4_stream(ref, jnp.asarray(pos), interpret=True)
        got = fm_stream.rank4_stream(arr, torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), _flat4(want))
    assert fm_stream.rank4_stream.launches == n0       # CPU: plain version
    for i in rng.choice(NPAD, 20, replace=False):
        for c in range(1, 5):
            assert got[c - 1, i] == fm.rank(c, int(scattered[i]))


def test_compact_flat_matches_pallas(fm, pallas_rank4, small_slabs,
                                     monkeypatch):
    """compact_children against psi_tpu's flat-ring compact kernel
    (PSI_COMPACT=flat), which computes what _compact_kernel does."""
    ref, _, _, jr4lo, jr4hi = pallas_rank4
    parent, char = _level_schedule(fm)
    monkeypatch.setenv("PSI_COMPACT", "flat")
    jlo, jhi = small_slabs.compact_children(
        jr4lo, jr4hi, jnp.asarray(parent), jnp.asarray(char), ref.C,
        interpret=True)
    lo, hi = fm_stream.compact_children(
        *(torch.from_numpy(np.ascontiguousarray(_flat4(r)))
          for r in (jr4lo, jr4hi)),
        torch.from_numpy(parent), torch.from_numpy(char),
        torch.tensor(np.asarray(ref.C)))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("order", ["sorted", "scattered"])
def test_rank_matches_pallas(fm, small_slabs, order):
    """rank_stream against psi_tpu's per-query rank kernel on a batch that
    is not a whole tile, with positions over the whole text and n."""
    ref = small_slabs.build_stream_arrays(fm)
    rng = np.random.RandomState(9)
    m = 3000
    pos = rng.randint(0, fm.size + 1, size=m).astype(np.int32)
    pos[:2] = (0, fm.size)
    if order == "sorted":
        pos = np.sort(pos)
    chars = rng.randint(1, 5, size=m).astype(np.int32)
    want = small_slabs.rank_stream(ref, jnp.asarray(chars), jnp.asarray(pos),
                                   interpret=True)
    n0 = fm_stream.rank_stream.launches
    got = fm_stream.rank_stream(convert.stream_arrays(ref, CPU),
                                torch.from_numpy(chars), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fm_stream.rank_stream.launches == n0         # CPU: plain version
    for i in rng.choice(m, 30, replace=False):
        assert got[i] == fm.rank(int(chars[i]), int(pos[i]))


@pytest.mark.parametrize("ftab_p", [0, 4])
def test_backward_search_sorted_matches_pallas(fm, small_slabs, ftab_p):
    """backward_search_sorted over sorted code rows, fed column 0 first,
    from the root or from the ftab ranges of the first p columns."""
    k = 10
    rng = np.random.RandomState(12)
    text = fm.codes[: fm.str_starts[1] - 1]
    starts = rng.randint(0, len(text) - k, 700)
    # fed first to last, a row spells its k-mer backwards in the text
    present = text[starts[:, None] + np.arange(k)][:, ::-1]
    present = present[(present >= 1).all(1) & (present <= 4).all(1)]
    codes = np.concatenate([present, rng.randint(1, 5, (1300, k))])
    weights = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    keys = np.unique((codes.astype(np.int64) - 1) @ weights)
    codes = (keys[:, None] // weights % 4 + 1).astype(np.int32)
    ref = small_slabs.build_stream_arrays(fm)
    lo0 = hi0 = None
    if ftab_p:
        ftab = jfm.build_ftab(fm, ftab_p)[keys >> (2 * (k - ftab_p))]
        lo0 = np.ascontiguousarray(ftab[:, 0])
        hi0 = np.ascontiguousarray(ftab[:, 1])
    jlo, jhi = small_slabs.backward_search_sorted(
        ref, jnp.asarray(codes[:, ftab_p:]),
        None if lo0 is None else jnp.asarray(lo0),
        None if hi0 is None else jnp.asarray(hi0), interpret=True)
    n0 = fm_stream.rank_lf_pair.launches, fm_stream.rank_stream.launches
    lo, hi = fm_stream.backward_search_sorted(
        convert.stream_arrays(ref, CPU),
        torch.from_numpy(np.ascontiguousarray(codes[:, ftab_p:])),
        None if lo0 is None else torch.from_numpy(lo0),
        None if hi0 is None else torch.from_numpy(hi0))
    assert (fm_stream.rank_lf_pair.launches,           # CPU: plain version
            fm_stream.rank_stream.launches) == n0
    jlo, jhi = np.asarray(jlo), np.asarray(jhi)
    np.testing.assert_array_equal((hi - lo).numpy(), jhi - jlo)
    found = jhi > jlo
    assert found.sum() > 100
    np.testing.assert_array_equal(lo.numpy()[found], jlo[found])
    # and against the host FM index's own search
    for i in rng.choice(len(keys), 40, replace=False):
        s = "".join("ACGT"[c - 1] for c in codes[i])
        want_lo, want_hi = fm.backward_search(s[::-1])
        assert int(hi[i] - lo[i]) == want_hi - want_lo


@pytest.mark.parametrize("edge", ["empty", "at_n", "straddle"])
def test_backward_search_sorted_edges_match_pallas(fm, small_slabs, edge):
    """backward_search_sorted from seeds at the edges of the rank step:
    empty ranges (lo == hi), ranges ending at n (the spare block), and
    ranges whose lo and hi lie in different 32-position blocks, against
    psi_tpu's (interpret mode), compared per R3."""
    k = 3
    rng = np.random.RandomState(21)
    n = fm.size
    m = 1500
    lo0 = rng.randint(0, n, size=m)
    if edge == "empty":
        hi0 = lo0.copy()
        hi0[::2] += 1               # one wide, then empty, in turns
    elif edge == "at_n":
        hi0 = np.full(m, n)
        lo0[: m // 2] = n - rng.randint(0, 64, size=m // 2)
    else:
        blk = rng.randint(1, n // 32, size=m)
        lo0 = 32 * blk - rng.randint(1, 4, size=m)
        hi0 = 32 * blk + rng.randint(0, 200, size=m)
    order = np.lexsort((hi0, lo0))
    lo0, hi0 = (np.ascontiguousarray(a[order].astype(np.int32))
                for a in (lo0, hi0))
    codes = rng.randint(1, 5, size=(m, k)).astype(np.int32)
    ref = small_slabs.build_stream_arrays(fm)
    jlo, jhi = small_slabs.backward_search_sorted(
        ref, jnp.asarray(codes), jnp.asarray(lo0), jnp.asarray(hi0),
        interpret=True)
    lo, hi = fm_stream.backward_search_sorted(
        convert.stream_arrays(ref, CPU), torch.from_numpy(codes),
        torch.from_numpy(lo0), torch.from_numpy(hi0))
    jlo, jhi = np.asarray(jlo), np.asarray(jhi)
    np.testing.assert_array_equal((hi - lo).numpy(), jhi - jlo)
    found = jhi > jlo
    np.testing.assert_array_equal(lo.numpy()[found], jlo[found])
    if edge == "empty":
        empty = hi0 == lo0
        assert empty.sum() > 500 and (jhi[empty] == jlo[empty]).all()
    else:
        assert found.sum() > 50
