"""psi_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card. Every test here needs a CUDA device and skips without one; the
file imports neither jax nor psi_tpu, so on a GPU machine it runs on its
own:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernels are int32 gathers and popcounts: results are bit-equal."""

import numpy as np
import pytest
import torch

from psi_tpu_torch import cli
from psi_tpu_torch.fmindex import FMIndex
from psi_tpu_torch.graphiter import HaplotyperRandomIter
from psi_tpu_torch.pathutil import Path, sequence
from psi_tpu_torch.simulate import make_pangenome_graph
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.graph import Position
from psi_tpu_torch.ops import fm_fused, fm_pallas, fm_stream, fm_trie
from psi_tpu_torch.ops import traverse as trav
from psi_tpu_torch.records import Records, SeedsIndex, seeding
from psi_tpu_torch.seed_finder import SeedFinder

pytestmark = pytest.mark.cuda
K = 12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def index():
    rng = np.random.RandomState(23)
    s = "".join(rng.choice(list("ACGT"), size=60_000))
    fm = FMIndex.build_from_strings([s[::-1], s[7_000:19_000][::-1]])
    lut = {c: i for i, c in enumerate("ACGT")}
    present = [
        sum(lut[ch] << (2 * (K - 1 - j)) for j, ch in enumerate(s[p:p + K]))
        for p in range(0, len(s) - K, 11)
    ]
    keys = np.unique(np.concatenate([
        rng.randint(0, 4 ** K, size=3000).astype(np.uint64),
        np.asarray(present, dtype=np.uint64),
    ]))
    return fm, keys, fm_ops.build_ftab(fm, 5)


#: the trie plan's cases, for the card's schedule kernel here and its
#: plain version in test_torch_fm_trie.py: the padding's edges (8192 and
#: 8193 keys), one key, keys that share 19 of 20 digits, the shortest and
#: longest keys, no ftab, and a chunk's worth of 20-mers at the cells'
#: ftab depth
SCHEDULE_CASES = ["one", "npad_8192", "npad_8193", "prefix_19", "k1",
                  "k32", "no_ftab", "chunk"]


def _random_keys(rng, n, k):
    """n random k-digit keys, sorted and distinct (fewer where they
    collide); at k = 32 every bit of the uint64 is random."""
    hi = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
    lo = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
    keys = (hi << np.uint64(32)) | lo
    if k < 32:
        keys &= np.uint64((1 << (2 * k)) - 1)
    return np.unique(keys)


def schedule_case(name):
    """(keys, k, p, ftab) of a SCHEDULE_CASES case. The ftab (None at p =
    0) holds each row's index and a function of it, so a plan's lo0
    names the frontier's rows."""
    rng = np.random.RandomState(31)
    keys, k, p = {
        "one": (lambda: (np.array([0x2C5F3A91B], dtype=np.uint64), 20, 5)),
        "npad_8192": (lambda: (_random_keys(rng, 9000, 20)[:8192], 20, 5)),
        "npad_8193": (lambda: (_random_keys(rng, 9000, 20)[:8193], 20, 5)),
        "prefix_19": (lambda: (np.uint64(0x3B2A19F0C4)
                               + np.arange(4, dtype=np.uint64), 20, 5)),
        "k1": (lambda: (np.array([0, 2, 3], dtype=np.uint64), 1, 0)),
        "k32": (lambda: (_random_keys(rng, 3000, 32), 32, 7)),
        "no_ftab": (lambda: (_random_keys(rng, 3000, 20), 20, 0)),
        "chunk": (lambda: (_random_keys(rng, 480_000, 20), 20, 11)),
    }[name]()
    rows = np.arange(4 ** p, dtype=np.int32)
    ftab = np.stack([rows, 3 * rows + 1], axis=1) if p else None
    return keys, k, p, ftab


def _same_plan(got, want):
    """Two PreparedTries equal tensor for tensor, on the host."""
    for a, b in ((got.parents, want.parents), (got.chars, want.chars),
                 (got.lo0, want.lo0), (got.hi0, want.hi0)):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.cpu(), b.cpu())
    np.testing.assert_array_equal(got.leaf_perm, want.leaf_perm)
    assert got.n == want.n


@pytest.mark.parametrize("name", SCHEDULE_CASES)
def test_trie_schedule_kernel_matches_plain_and_host(dev, name):
    """csrc/trie_schedule.cu against its plain version and the native
    host schedule, slot for slot; then `prepare` on the card (the kernel
    on its own stream, the keys through pinned memory) against `prepare`
    on the CPU, with the plan's tensors recorded on the caller's stream
    and `plan-device-keys` counting every key."""
    from psi_tpu_torch import stats

    keys, k, p, ftab = schedule_case(name)
    npad = fm_trie._npad(len(keys), None)
    t_keys = torch.from_numpy(keys.view(np.int64))
    t_ftab = None if ftab is None else torch.from_numpy(ftab)
    n0 = fm_trie.trie_schedule.launches
    got = fm_trie.trie_schedule(
        t_keys.to(dev), k, p, None if p == 0 else t_ftab.to(dev), npad)
    torch.cuda.synchronize()
    assert fm_trie.trie_schedule.launches == n0 + 1
    want = fm_trie.trie_schedule_plain(t_keys, k, p, t_ftab, npad)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.device == dev and torch.equal(a.cpu(), b)
    host = fm_trie.prepare(keys, k, ftab, device="cpu")
    assert torch.equal(got[0].cpu(), host.parents)
    assert torch.equal(got[1].cpu(), host.chars)
    np.testing.assert_array_equal(got[4].cpu().numpy(), host.leaf_perm)
    with stats.timeit_ts("prepare-onpath", 7):
        plan = fm_trie.prepare(keys, k, ftab, device=dev)
    assert fm_trie.trie_schedule.launches == n0 + 2
    _same_plan(plan, host)
    assert stats.chunk_totals(7)[1]["plan-device-keys"] == len(keys)
    stats.Timer.reset_all()


def test_prepare_on_the_card_equals_host_on_a_g1k_chunk(dev, tmp_path):
    """One generated chunk of the benchmark's g1k_common cell (its graph,
    path index and prefix table, 100,000 reads): the plan that
    `prepare_onpath` builds on the card equals the host route's,
    tensor for tensor, and the card built it for every distinct key."""
    import json
    import pathlib

    from psi_tpu_torch import stats
    from seedbench.entries import chunk_loop

    root = pathlib.Path(__file__).resolve().parent.parent / "seedbench"
    config = json.loads((root / "configs" / "g1k_common.json").read_text())
    traffic = json.loads((root / "traffic" / "exact.json").read_text())
    traffic["pool_chunks"] = 1
    inputs = chunk_loop.Inputs(config, traffic, 2_718_281_828, str(tmp_path))
    finder = chunk_loop.build_finder(inputs, config, traffic, dev)
    reads = inputs.chunks[0]
    recs = Records([f"r{i}" for i in range(len(reads))], packed=(
        reads.reshape(-1), np.arange(len(reads) + 1) * reads.shape[1]))
    index = finder.index_reads(finder.get_seeds(recs))
    finder.prepare_onpath(index)
    uniq, plan = index._onpath_prep.uniq, index._onpath_prep.trie
    assert plan.parents.device == dev and len(uniq) > 400_000
    ftab = finder._get_ftab()
    assert ftab.shape[0] == 4 ** 11
    _same_plan(plan, fm_trie.prepare(uniq, 20, ftab, device="cpu"))
    assert stats.chunk_totals(0)[1]["plan-device-keys"] == len(uniq)
    stats.Timer.reset_all()


def test_trie_level_kernel_matches_plain(index, dev):
    fm, keys, ftab = index
    arr = fm_stream.build_stream_arrays(fm, dev)
    prep = fm_trie.prepare(keys, K, ftab, device=dev)
    n0 = fm_fused.trie_level.launches
    lo, hi = fm_fused.trie_fused(arr, prep.parents, prep.chars, prep.lo0,
                                 prep.hi0)
    want_lo, want_hi = prep.lo0, prep.hi0
    for j in range(prep.parents.shape[0]):
        want_lo, want_hi = fm_fused.trie_level_plain(
            arr.payloadC, arr.C, prep.parents[j], prep.chars[j], want_lo,
            want_hi)
    torch.cuda.synchronize()
    assert fm_fused.trie_level.launches == n0 + prep.parents.shape[0]
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    assert (hi > lo).any()


def test_two_pass_kernels_match_plain(index, dev):
    fm, keys, ftab = index
    arr = fm_stream.build_stream_arrays(fm, dev)
    prep = fm_trie.prepare(keys, K, ftab, device=dev)
    lo, hi = prep.lo0, prep.hi0
    for j in range(prep.parents.shape[0]):
        n0 = fm_stream.rank4_pair_stream.launches
        r4 = fm_stream.rank4_pair_stream(arr, lo, hi)
        want = fm_stream.rank4_pair_plain(arr, lo, hi)
        assert fm_stream.rank4_pair_stream.launches == n0 + 1
        assert torch.equal(r4[0], want[0]) and torch.equal(r4[1], want[1])
        n0 = fm_stream.compact_children.launches
        lo, hi = fm_stream.compact_children(*r4, prep.parents[j],
                                            prep.chars[j], arr.C)
        want = fm_stream.compact_plain(*r4, prep.parents[j], prep.chars[j],
                                       arr.C)
        assert fm_stream.compact_children.launches == n0 + 1
        assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
    fused = fm_trie._trie_device(arr, prep.parents, prep.chars, prep.lo0,
                                 prep.hi0, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(lo, fused[0]) and torch.equal(hi, fused[1])


def test_rank_kernels_match_plain(index, dev):
    """rank4 and rank on every level's frontier of the unpaired two-pass
    route, which must equal the fused route; then backward_search_sorted
    from the ftab frontier, whose counts must equal the trie's."""
    fm, keys, ftab = index
    arr = fm_stream.build_stream_arrays(fm, dev)
    prep = fm_trie.prepare(keys, K, ftab, device=dev)
    lo, hi = prep.lo0, prep.hi0
    for j in range(prep.parents.shape[0]):
        n0 = fm_stream.rank4_stream.launches
        r4 = (fm_stream.rank4_stream(arr, lo), fm_stream.rank4_stream(arr, hi))
        assert fm_stream.rank4_stream.launches == n0 + 2
        for got, pos in zip(r4, (lo, hi)):
            assert torch.equal(got, fm_stream.rank4_plain(arr.payloadR, pos))
        scattered = lo.flip(0)
        n0 = fm_stream.rank_stream.launches
        got = fm_stream.rank_stream(arr, prep.chars[j], scattered)
        assert fm_stream.rank_stream.launches == n0 + 1
        assert torch.equal(got, fm_stream.rank_plain(
            arr.payloadT, prep.chars[j], scattered))
        lo, hi = fm_stream.compact_children(*r4, prep.parents[j],
                                            prep.chars[j], arr.C)
    fused = fm_trie._trie_device(arr, prep.parents, prep.chars, prep.lo0,
                                 prep.hi0, fused=True)
    assert torch.equal(lo, fused[0]) and torch.equal(hi, fused[1])
    p = 5
    shifts = 2 * np.arange(K - 1, -1, -1, dtype=np.uint64)
    codes = ((keys[:, None] >> shifts) & np.uint64(3)).astype(np.int32) + 1
    rows = ftab[(keys >> np.uint64(2 * (K - p))).astype(np.int64)]
    n0 = fm_stream.rank_lf_pair.launches, fm_stream.rank_stream.launches
    blo, bhi = fm_stream.backward_search_sorted(
        arr, torch.from_numpy(np.ascontiguousarray(codes[:, p:])).to(dev),
        torch.from_numpy(np.ascontiguousarray(rows[:, 0])).to(dev),
        torch.from_numpy(np.ascontiguousarray(rows[:, 1])).to(dev))
    torch.cuda.synchronize()
    assert (fm_stream.rank_lf_pair.launches,
            fm_stream.rank_stream.launches) == (n0[0] + K - p, n0[1])
    tlo, thi = fm_trie.trie_search(arr, keys, K, ftab=ftab)
    np.testing.assert_array_equal((bhi - blo).cpu().numpy(), thi - tlo)


def test_trie_search_matches_host_fm(index, dev):
    fm, keys, ftab = index
    lo, hi = fm_trie.trie_search(fm_stream.build_stream_arrays(fm, dev),
                                 keys, K, ftab=ftab)
    for i in np.random.RandomState(1).choice(len(keys), 300, replace=False):
        s = "".join("ACGT"[(int(keys[i]) >> (2 * (K - 1 - j))) & 3]
                    for j in range(K))
        want_lo, want_hi = fm.backward_search(s[::-1])
        assert hi[i] - lo[i] == want_hi - want_lo
        if want_hi > want_lo:
            assert lo[i] == want_lo


def test_wrappers_reject_bad_cuda_inputs(index, dev):
    fm, _, _ = index
    arr = fm_stream.build_stream_arrays(fm, dev)
    pos64 = torch.zeros(1024, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        fm_stream.rank4_pair_stream(arr, pos64, pos64)
    pos = torch.zeros(2048, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fm_stream.rank4_pair_stream(arr, pos[::2], pos[::2])
    with pytest.raises(ValueError, match="is on cpu"):
        fm_stream.rank4_pair_stream(arr, pos, pos.cpu())


def _edge_pairs(n, rng, dev, m=5000):
    """(chars, lo, hi) int32 on `dev` at the LF-step kernels' edges:
    chars 1..4 each; lo == hi; hi - lo across a 32-position block, across
    a 2-row (W=4) sector and inside both; positions 0 and n."""
    lo = rng.randint(0, n + 1, size=m)
    hi = np.minimum(lo + rng.choice([0, 1, 2, 7, 31, 32, 33, 500], size=m), n)
    lo[:4], hi[:4] = (0, 0, n, 0), (0, n, n, 1)
    blk = 32 * rng.randint(1, n // 32, size=300)
    lo[4:304], hi[4:304] = blk - 1, blk                # across a block
    odd = 2 * rng.randint(1, n // 2, size=300) - 1
    lo[304:604], hi[304:604] = odd, odd + 1            # across a sector
    chars = np.arange(m) % 4 + 1
    return [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (chars, lo, hi)]


def test_rank_lf_pair_kernel_matches_plain(index, dev):
    """rank_lf_pair and the per-query rank, both over payloadR, against
    their plain versions at the edges, one launch each; a misaligned
    record table is refused."""
    fm, _, _ = index
    arr = fm_stream.build_stream_arrays(fm, dev)
    chars, lo, hi = _edge_pairs(fm.size, np.random.RandomState(2), dev)
    n0 = fm_stream.rank_lf_pair.launches, fm_stream.rank_stream.launches
    got = fm_stream.rank_lf_pair(arr, chars, lo, hi)
    ranks = [fm_stream.rank_stream(arr, chars, pos) for pos in (lo, hi)]
    torch.cuda.synchronize()
    assert (fm_stream.rank_lf_pair.launches,
            fm_stream.rank_stream.launches) == (n0[0] + 1, n0[1] + 2)
    want = fm_stream.rank_lf_pair_plain(arr, chars, lo, hi)
    base = arr.C[chars.long()]
    for g, w, r, pos in zip(got, want, ranks, (lo, hi)):
        assert torch.equal(g, w)
        assert torch.equal(r, fm_stream.rank_plain(arr.payloadT, chars, pos))
        assert torch.equal(g, base + r)
    for i in range(4):
        c = int(chars[i])
        assert int(got[1][i]) == fm.C[c] + fm.rank(c, int(hi[i]))
    off = arr._replace(payloadR=arr.payloadR.reshape(-1)[1:-7].reshape(-1, 8))
    with pytest.raises(ValueError, match="aligned"):
        fm_stream.rank_lf_pair(off, chars, lo, hi)
    with pytest.raises(ValueError, match=r"must be \[M\]"):
        fm_stream.rank_lf_pair(arr, chars, lo, hi[:-1])


@pytest.mark.parametrize("odd", [False, True])
def test_trie_level_and_rank4_kernels_at_edges(index, dev, odd):
    """trie_level over payloadC (each edge pair a parent with its four
    children, c-major) and rank4 over payloadR (at every lo and hi)
    against their plain versions at the edges, one launch each and none
    for an empty rank4 batch, with an even and an odd number of items (the
    last thread's single item); misaligned tables and pairs are
    refused."""
    fm, _, _ = index
    arr = fm_stream.build_stream_arrays(fm, dev)
    _, lo, hi = _edge_pairs(fm.size, np.random.RandomState(3), dev)
    m = len(lo)
    parent = torch.arange(m, dtype=torch.int32, device=dev).repeat(4)
    char = torch.arange(1, 5, dtype=torch.int32,
                        device=dev).repeat_interleave(m)
    pos = torch.cat([lo, hi])
    if odd:
        parent, char, pos = parent[:-1], char[:-1], pos[:-1]
    out = (torch.empty_like(parent), torch.empty_like(parent))
    n0 = fm_fused.trie_level.launches, fm_stream.rank4_stream.launches
    fm_fused.trie_level(arr.payloadC, arr.C, parent, char, lo, hi, *out)
    r4 = fm_stream.rank4_stream(arr, pos)
    empty = fm_stream.rank4_stream(arr, pos[:0])
    torch.cuda.synchronize()
    assert (fm_fused.trie_level.launches,
            fm_stream.rank4_stream.launches) == (n0[0] + 1, n0[1] + 1)
    want = fm_fused.trie_level_plain(arr.payloadC, arr.C, parent, char, lo,
                                     hi)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert torch.equal(r4, fm_stream.rank4_plain(arr.payloadR, pos))
    assert empty.shape == (4, 0)
    for i in range(4):
        for c in range(1, 5):
            assert int(r4[c - 1, m + i]) == fm.rank(c, int(hi[i]))
            assert int(out[1][(c - 1) * m + i]) == (fm.C[c]
                                                     + fm.rank(c, int(hi[i])))
    off_c = arr.payloadC.reshape(-1)[1:-7].reshape(4, -1, 2)
    off_r = arr.payloadR.reshape(-1)[1:-7].reshape(-1, 8)
    with pytest.raises(ValueError, match="payloadC is not 8-byte aligned"):
        fm_fused.trie_level(off_c, arr.C, parent, char, lo, hi, *out)
    with pytest.raises(ValueError, match="parent is not 8-byte aligned"):
        fm_fused.trie_level(arr.payloadC, arr.C, parent[1:], char[1:], lo, hi,
                            out[0][1:], out[1][1:])
    with pytest.raises(ValueError, match="payloadR is not 32-byte aligned"):
        fm_stream.rank4_stream(arr._replace(payloadR=off_r), pos)
    with pytest.raises(ValueError, match="pos is not 8-byte aligned"):
        fm_stream.rank4_stream(arr, pos[1:])


def test_compact_kernel_at_edges(index, dev):
    """compact over rank tables of 3001 parents: every parent at every
    char 1..4 (c-major, parents 0 and Mprev - 1 included), cut to M = 0,
    1, 3, 5 and counts that end inside a warp or a block, against its
    plain version and the host FM index, one launch each and none for
    M = 0. The kernel loads the schedule one item a thread, so a view
    that starts at an odd item ([1:]) is taken as it is; schedules of two
    lengths are refused."""
    fm, _, _ = index
    arr = fm_stream.build_stream_arrays(fm, dev)
    rng = np.random.RandomState(6)
    mprev = 3001
    lo = rng.randint(0, fm.size + 1, size=mprev)
    hi = np.minimum(lo + rng.choice([0, 1, 31, 32, 900], size=mprev), fm.size)
    lo[0], hi[-1] = 0, fm.size
    lo_t, hi_t = (torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in (lo, hi))
    r4 = fm_stream.rank4_pair_stream(arr, lo_t, hi_t)
    parent = torch.arange(mprev, dtype=torch.int32, device=dev).repeat(4)
    char = torch.arange(1, 5, dtype=torch.int32,
                        device=dev).repeat_interleave(mprev)
    for m in (0, 1, 3, 5, 4098, 4 * mprev - 1, 4 * mprev):
        n0 = fm_stream.compact_children.launches
        got = fm_stream.compact_children(*r4, parent[:m], char[:m], arr.C)
        torch.cuda.synchronize()
        assert fm_stream.compact_children.launches == n0 + (m > 0)
        want = fm_stream.compact_plain(*r4, parent[:m], char[:m], arr.C)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for c in range(1, 5):
        for p in (0, mprev - 1):
            i = (c - 1) * mprev + p
            assert int(got[0][i]) == fm.C[c] + fm.rank(c, int(lo[p]))
            assert int(got[1][i]) == fm.C[c] + fm.rank(c, int(hi[p]))
    got = fm_stream.compact_children(*r4, parent[1:], char[1:], arr.C)
    want = fm_stream.compact_plain(*r4, parent[1:], char[1:], arr.C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match=r"must be \[M\]"):
        fm_stream.compact_children(*r4, parent, char[:-4], arr.C)


@pytest.mark.parametrize("order", ["scattered", "sorted"])
@pytest.mark.parametrize("width", [4, 8])
def test_occ_gather_kernel_at_edges(index, dev, width, order):
    """The row gather at positions 0 and R - 1, repeated, and random
    ones with duplicates, for M = 0, 1, 2, 3 and a large odd M, one
    launch each and none for M = 0; positions from a view that starts at
    an odd item ([1:]) are taken as they are (one position a lane;
    test_occ_gather_rejects_bad_inputs refuses a misaligned table)."""
    fm, _, _ = index
    occ8 = torch.from_numpy(fm_pallas.occ_dense_padded(fm)).to(dev)
    occ = occ8 if width == 8 else occ8[:, :4].contiguous()
    R = occ.shape[0]
    rng = np.random.RandomState(10 + width)
    pos = rng.randint(0, R, size=20001)
    pos[:6] = (0, R - 1, R - 1, 0, 0, R - 1)
    pos[6:1006] = pos[6]                        # one row 1000 times
    if order == "sorted":
        pos = np.sort(pos)
    pos = torch.from_numpy(pos.astype(np.int32)).to(dev)
    for m in (0, 1, 2, 3, len(pos)):
        n0 = fm_pallas.gather_occ_rows.launches
        got = fm_pallas.gather_occ_rows(occ, pos[:m])
        torch.cuda.synchronize()
        assert fm_pallas.gather_occ_rows.launches == n0 + (m > 0)
        assert torch.equal(got, fm_pallas.gather_occ_rows_plain(occ, pos[:m]))
    assert torch.equal(got[pos == R - 1], occ[R - 1].expand(
        int((pos == R - 1).sum()), width))
    assert torch.equal(fm_pallas.gather_occ_rows(occ, pos[1:]),
                       fm_pallas.gather_occ_rows_plain(occ, pos[1:]))


@pytest.mark.parametrize("width", [4, 8])
def test_occ_lf_pair_kernel_matches_plain(index, dev, width):
    """lf_pair on the dense and the padded table against lf_pair_plain at
    the edges and on an empty batch."""
    fm, _, _ = index
    occ8 = torch.from_numpy(fm_pallas.occ_dense_padded(fm)).to(dev)
    occ = occ8 if width == 8 else occ8[:, :4].contiguous()
    C = torch.from_numpy(fm.C.astype(np.int32)).to(dev)
    chars, lo, hi = _edge_pairs(fm.size, np.random.RandomState(width), dev)
    for m in (0, 1, 257, len(lo)):
        n0 = fm_pallas.lf_pair.launches
        got = fm_pallas.lf_pair(occ, C, chars[:m], lo[:m], hi[:m])
        torch.cuda.synchronize()
        assert fm_pallas.lf_pair.launches == n0 + (m > 0)
        want = fm_pallas.lf_pair_plain(occ, C, chars[:m], lo[:m], hi[:m])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for i in range(4):
        c = int(chars[i])
        assert int(got[1][i]) == fm.C[c] + fm.rank(c, int(hi[i]))
    with pytest.raises(ValueError, match="W in"):
        fm_pallas.lf_pair(occ8[:, :6].contiguous(), C, chars, lo, hi)
    with pytest.raises(ValueError, match="int32"):
        fm_pallas.lf_pair(occ, C, chars, lo.long(), hi)


@pytest.mark.parametrize("order", ["scattered", "sorted"])
@pytest.mark.parametrize("width", [4, 8])
def test_occ_gather_kernel_matches_plain(index, dev, width, order):
    """occ_gather on the dense table ([n+1, 4]) and the padded one
    ([n+1, 8]) at M = 0, 1, 257 and at a backward search's positions."""
    fm, keys, _ = index
    occ8 = torch.from_numpy(fm_pallas.occ_dense_padded(fm)).to(dev)
    occ = occ8 if width == 8 else occ8[:, :4].contiguous()
    rng = np.random.RandomState(width)
    for m in (0, 1, 257, 2 * len(keys)):
        pos = torch.from_numpy(rng.randint(0, fm.size + 1, m).astype(
            np.int32)).to(dev)
        if order == "sorted":
            pos = torch.sort(pos).values
        n0 = fm_pallas.gather_occ_rows.launches
        got = fm_pallas.gather_occ_rows(occ, pos)
        torch.cuda.synchronize()
        assert fm_pallas.gather_occ_rows.launches == n0 + (m > 0)
        assert got.shape == (m, width) and got.dtype == torch.int32
        assert torch.equal(got, fm_pallas.gather_occ_rows_plain(occ, pos))
    arrays = fm_ops.to_device(fm, dev, dense_occ=True)
    assert torch.equal(arrays.occ_dense, occ8[:, :4])
    codes = torch.from_numpy(fm_ops.keys_to_codes(keys, K)).to(dev)
    n0 = fm_pallas.lf_pair.launches, fm_pallas.gather_occ_rows.launches
    lo, hi = fm_ops.backward_search_codes(arrays, codes)
    assert (fm_pallas.lf_pair.launches,
            fm_pallas.gather_occ_rows.launches) == (n0[0] + K, n0[1])
    plo, phi = fm_pallas.backward_search_pallas(occ8, arrays.C, fm.size,
                                                codes)
    assert torch.equal(lo, plo) and torch.equal(hi, phi)
    ref = fm_ops.backward_search_codes(arrays._replace(occ_dense=None), codes)
    assert torch.equal(hi - lo, ref[1] - ref[0])


def test_occ_gather_rejects_bad_inputs(index, dev):
    fm, _, _ = index
    occ = torch.from_numpy(fm_pallas.occ_dense_padded(fm)).to(dev)
    pos = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        fm_pallas.gather_occ_rows(occ, pos.long())
    with pytest.raises(ValueError, match="W in"):
        fm_pallas.gather_occ_rows(occ[:, :6].contiguous(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        fm_pallas.gather_occ_rows(occ[:, :4], pos)
    with pytest.raises(ValueError, match="aligned"):
        fm_pallas.gather_occ_rows(occ.reshape(-1)[1:-7].reshape(-1, 8), pos)
    with pytest.raises(ValueError, match="is on cpu"):
        fm_pallas.gather_occ_rows(occ.cpu(), pos)
    with pytest.raises(ValueError, match=r"positions must be \[M\]"):
        fm_pallas.gather_occ_rows(occ, pos.reshape(8, 8))
    with pytest.raises(ValueError, match="ACGT codes"):
        fm_ops.backward_search_codes(
            fm_ops.to_device(fm, dev, dense_occ=True),
            torch.zeros((4, K), dtype=torch.int32, device=dev))


def test_gather_route_and_mems_cuda_match_cpu(dev):
    """The gather route's backward search (backward_search_codes over the
    finder's dense occ table, from the ftab) on the chunk's distinct keys
    and the MEM API on the card give the CPU's ranges and hits, and the
    search launched the LF-step kernel once per LF step."""
    graph = make_pangenome_graph(30_000, 0.02, seed=8)
    itr = HaplotyperRandomIter(graph, seed=12)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    rng = np.random.RandomState(4)
    reads = hs[rng.randint(0, len(hs) - 100, 800)[:, None] + np.arange(100)]
    recs = Records([f"r{i}" for i in range(800)],
                   [r.tobytes().decode() for r in reads])
    out = {}
    for device in ("cuda", "cpu"):
        finder = SeedFinder(graph, 20, device=device)
        finder.create_path_index(1, patched=False)
        index = finder.index_reads(finder.get_seeds(recs))
        codes = torch.from_numpy(fm_ops.keys_to_codes(
            np.unique(index.sorted_keys), 20)).to(device)
        n0 = fm_pallas.lf_pair.launches
        lo, hi = fm_ops.backward_search_codes(finder._get_fm_arrays(), codes)
        launched = fm_pallas.lf_pair.launches - n0
        mems = finder.find_mems_arrays(recs)
        out[device] = (lo.cpu().numpy(), hi.cpu().numpy(),
                       np.sort(mems, order=list(mems.dtype.names)), launched)
    (lo, hi, mems, launched), (clo, chi, cmems, claunched) = (out["cuda"],
                                                             out["cpu"])
    assert launched == 20 - finder._ftab_bits() and claunched == 0
    found = hi > lo
    assert found.sum() > 0 and len(mems) > 0
    np.testing.assert_array_equal(hi - lo, chi - clo)
    np.testing.assert_array_equal(lo[found], clo[found])
    assert mems.tobytes() == cmems.tobytes()


def test_cli_cuda_matches_cpu(tmp_path, dev):
    graph = make_pangenome_graph(30_000, 0.02, seed=8)
    gpath = str(tmp_path / "graph.npz")
    graph.save(gpath)
    itr = HaplotyperRandomIter(graph, seed=12)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    rng = np.random.RandomState(4)
    reads = hs[rng.randint(0, len(hs) - 100, 1200)[:, None] + np.arange(100)]
    fq = tmp_path / "reads.fastq"
    with open(fq, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * 100))
    streams = []
    n0 = fm_fused.trie_level.launches
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.bin"
        assert cli.main([gpath, "-f", str(fq), "-l", "20", "-n", "1", "-P",
                         "-c", "400", "--device", device, "-o", str(out),
                         "-q", "-Q"]) == 0
        hits = np.fromfile(out, dtype="<i8").reshape(-1, 4)
        streams.append(hits[np.lexsort(hits.T[::-1])])
    assert fm_fused.trie_level.launches > n0
    assert len(streams[0]) > 0
    assert streams[0].tobytes() == streams[1].tobytes()


def _offpath_case(k, n_reads=40, seed=3):
    """A bubble graph with an 'N' in one label, every locus a start, and
    a SeedsIndex of k-mers of a random haplotype with 1% substitutions."""
    rng = np.random.RandomState(seed)
    graph = make_pangenome_graph(3000, 0.05, indel_frac=0.4, seed=seed)
    graph.labels = graph.labels.copy()
    graph.labels[rng.randint(0, len(graph.labels))] = ord("N")
    itr = HaplotyperRandomIter(graph, seed=seed + 1)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = sequence(hap)
    starts = rng.randint(0, len(hs) - 3 * k, n_reads)
    reads = Records([f"r{i}" for i in range(n_reads)],
                    [hs[p: p + 3 * k] for p in starts])
    index = SeedsIndex(seeding(reads, k, k))
    loci = [Position(n, o) for n in range(1, graph.node_count + 1)
            for o in range(graph.node_length(n))]
    sn = np.array([p.node_id() for p in loci], dtype=np.int32)
    so = np.array([p.offset() for p in loci], dtype=np.int32)
    return graph, index, sn, so


def test_range_refine_kernels_match_plain(dev):
    """range_refine4 against its plain version at every depth, at the
    edges (0, V, empty ranges, block ends) and at random, with an odd
    count and an empty batch (no launch); bad depths, shapes and a
    misaligned occ table are refused."""
    _, index, _, _ = _offpath_case(12, n_reads=400)
    seeds = trav.seeds_to_device(index, dev)
    rng = np.random.RandomState(7)
    V, m = index.size, 5001
    lo = rng.randint(0, V + 1, m)
    hi = np.minimum(lo + rng.choice([0, 1, 31, 32, 33, V], m), V)
    lo[:4], hi[:4] = (0, 0, V, 31), (V, 0, V, 32)
    lo, hi = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (lo, hi))
    for depth in range(index.k):
        n0 = trav.range_refine4.launches
        got4 = trav.range_refine4(seeds, depth, lo, hi)
        empty = trav.range_refine4(seeds, depth, lo[:0], hi[:0])
        torch.cuda.synchronize()
        assert trav.range_refine4.launches == n0 + 1
        want4 = trav.range_refine4_plain(seeds, depth, lo, hi)
        for g, w in zip(got4, want4):
            assert torch.equal(g, w)
        assert empty[0].shape == (0, 4)
    with pytest.raises(ValueError, match="depth"):
        trav.range_refine4(seeds, index.k, lo, hi)
    with pytest.raises(ValueError, match=r"must be \[N\]"):
        trav.range_refine4(seeds, 0, lo, hi[:-1])
    buf = torch.zeros(seeds.occ.numel() + 1, dtype=torch.int32, device=dev)
    off = seeds._replace(occ=buf[1:].view(seeds.occ.shape))
    with pytest.raises(ValueError, match="aligned"):
        trav.range_refine4(off, 0, lo, hi)


def _start_state(seeds, sn, so, cap, d):
    """traverse_device's state before its first step, on device d."""
    starts = [np.resize(np.pad(a, (0, cap - len(a))), cap) for a in (sn, so)]
    return trav.TraverseState(
        locus_idx=torch.arange(cap, dtype=torch.int32, device=d),
        node=torch.from_numpy(starts[0]).to(d),
        off=torch.from_numpy(starts[1]).to(d),
        lo=torch.zeros(cap, dtype=torch.int32, device=d),
        hi=torch.full((cap,), seeds.size, dtype=torch.int32, device=d),
        overflow=torch.zeros((), dtype=torch.bool, device=d),
        tstats=torch.zeros(3, dtype=torch.int64, device=d))


def _assert_same_step(got, want):
    """Two (state, new_n, n2) results equal over the whole cap."""
    (gs, *gc), (ws, *wc) = got, want
    for a, b in zip((*gs, *gc), (*ws, *wc), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", [12, 32])
def test_traverse_step_kernel_matches_plain(dev, k):
    """traverse_step (one launch) against traverse_step_plain on the card
    at every step's inputs of the plain traversal, over the whole cap:
    the state, overflow, TraverserStats, new_n and n2 are bit-equal; the
    injected 'N' kills a child on some step."""
    graph, index, sn, so = _offpath_case(k)
    cap = 1 << 13
    g, seeds = trav.graph_to_device(graph, dev), trav.seeds_to_device(index,
                                                                       dev)
    slot = torch.arange(cap, device=dev)
    state, n_used, killed_by_n = _start_state(seeds, sn, so, cap, dev), len(
        sn), False
    for t in range(k):
        n0 = trav.traverse_step.launches
        got = trav.traverse_step(g, seeds, t, state, n_used, cap)
        assert trav.traverse_step.launches == n0 + 1
        want = trav.traverse_step_plain(g, seeds, t, state, n_used, cap)
        _assert_same_step(got, want)
        _, _, node, off, valid = trav._fork(g, state.node, state.off, n_used,
                                            slot, cap)
        killed_by_n |= bool((valid & (trav._label(g, node, off) == 4)).any())
        state, _, n_used = want
    assert killed_by_n and int(n_used) > 0


@pytest.mark.parametrize("case", ["empty", "full", "overflow", "ragged"])
def test_traverse_step_kernel_at_edges(dev, case):
    """traverse_step against traverse_step_plain over the whole cap at
    step 1 of a traversal cut to a cap where the frontier is empty, its
    children fill the cap exactly (new_n == cap), overflow it (children
    past the cap dropped), or leave a ragged last tile and padding; a cap
    of 0 or a wrong dtype is refused."""
    graph, index, sn, so = _offpath_case(12)
    g, seeds = trav.graph_to_device(graph, dev), trav.seeds_to_device(index,
                                                                       dev)
    big = 1 << 13
    state, n_used, _ = trav.traverse_step_plain(
        g, seeds, 0, _start_state(seeds, sn, so, big, dev), len(sn), big)
    _, new_n, _ = trav.traverse_step_plain(g, seeds, 1, state, n_used, big)
    n_used, new_n = int(n_used), int(new_n)
    assert n_used + 8 < new_n < big
    cap = {"empty": big, "full": new_n, "overflow": new_n - 5,
           "ragged": n_used + 3}[case]
    if case == "empty":
        n_used = 0
    cut = state._replace(**{f: getattr(state, f)[:cap].contiguous()
                            for f in ("locus_idx", "node", "off", "lo", "hi")})
    got = trav.traverse_step(g, seeds, 1, cut, n_used, cap)
    want = trav.traverse_step_plain(g, seeds, 1, cut, n_used, cap)
    _assert_same_step(got, want)
    if case == "full":
        assert int(got[1]) == cap and not got[0].overflow
    if case == "overflow":
        assert int(got[1]) > cap and got[0].overflow
    if case == "empty":
        assert int(got[1]) == int(got[2]) == 0
    with pytest.raises(ValueError, match="cap"):
        trav.traverse_step(g, seeds, 1, cut, n_used, 0)
    with pytest.raises(ValueError, match="int32"):
        trav.traverse_step(g, seeds, 1, cut._replace(lo=cut.lo.long()),
                           n_used, cap)


def _approx_state(seeds, sn, so, cap, d, max_mm):
    """traverse_device_approx's state before its first step, on device
    d."""
    st = _start_state(seeds, sn, so, cap, d)
    return trav.ApproxState(
        *st[:5], budget=torch.full((cap,), max_mm, dtype=torch.int32,
                                   device=d), overflow=st.overflow)


def _approx_launches():
    return trav.traverse_step_approx.launches, trav.range_refine4.launches


@pytest.mark.parametrize("max_mm", [1, 2])
def test_traverse_step_approx_kernel_matches_plain(dev, max_mm):
    """traverse_step_approx (range_refine4 over the parents, then one step
    launch) against traverse_step_approx_plain on the card at every
    step's inputs of the plain traversal at a cap of 2^13, over the whole
    cap: the six state arrays, overflow, new_n and n2 are bit-equal. The
    steps include one that overflows only at the char fork (new_n <= cap
    < n2), one that overflows at the graph fork (new_n > cap), node ends
    of outdegree > 1 (more graph children than parents) and the injected
    'N' killing a child."""
    graph, index, sn, so = _offpath_case(12)
    cap = 1 << 13
    g, seeds = trav.graph_to_device(graph, dev), trav.seeds_to_device(index,
                                                                       dev)
    slot = torch.arange(cap, device=dev)
    state, n_used = _approx_state(seeds, sn, so, cap, dev, max_mm), len(sn)
    seen = set()
    for t in range(12):
        n0 = _approx_launches()
        got = trav.traverse_step_approx(g, seeds, t, state, n_used, cap)
        assert _approx_launches() == (n0[0] + 1, n0[1] + 1)
        want = trav.traverse_step_approx_plain(g, seeds, t, state, n_used,
                                               cap)
        _assert_same_step(got, want)
        _, _, node, off, valid = trav._fork(g, state.node, state.off, n_used,
                                            slot, cap)
        if (valid & (trav._label(g, node, off) == 4)).any():
            seen.add("N")
        parents, new_n, n2 = min(int(n_used), cap), int(want[1]), int(want[2])
        if new_n > parents:
            seen.add("fork")
        if new_n > cap:
            seen.add("graph overflow")
        elif n2 > cap:
            seen.add("char overflow")
        state, _, n_used = want
    assert seen == {"N", "fork", "graph overflow", "char overflow"}
    assert 0 < int(n_used) < cap


@pytest.mark.parametrize("case", ["empty", "cap16", "graph_overflow"])
def test_traverse_step_approx_kernel_at_edges(dev, case):
    """traverse_step_approx against its plain step over the whole cap at
    step 4 of a one-mismatch traversal (at 2^13 slots its parents fork at
    node ends and fit), its overflow flag cleared, cut to a cap where the
    frontier is empty (n_used = 0: every slot the padding record), to 16
    slots (one partial tile, n_used past the cap, survivors and padding),
    or between the parents and their graph children (children past the
    cap dropped); a cap of 0, a wrong dtype and a wrong budget shape are
    refused."""
    graph, index, sn, so = _offpath_case(12)
    g, seeds = trav.graph_to_device(graph, dev), trav.seeds_to_device(index,
                                                                       dev)
    big = 1 << 13
    state, n_used = _approx_state(seeds, sn, so, big, dev, 1), len(sn)
    for t in range(4):
        state, _, n_used = trav.traverse_step_approx_plain(
            g, seeds, t, state, n_used, big)
    _, new_n, _ = trav.traverse_step_approx_plain(g, seeds, 4, state, n_used,
                                                  big)
    n_used, new_n = int(n_used), int(new_n)
    assert n_used + 8 < new_n < big
    cap = {"empty": big, "cap16": 16, "graph_overflow": new_n - 5}[case]
    if case == "empty":
        n_used = 0
    cut = state._replace(
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        **{f: getattr(state, f)[:cap].contiguous()
           for f in trav.ApproxState._fields[:6]})
    got = trav.traverse_step_approx(g, seeds, 4, cut, n_used, cap)
    want = trav.traverse_step_approx_plain(g, seeds, 4, cut, n_used, cap)
    _assert_same_step(got, want)
    if case == "empty":
        assert int(got[1]) == int(got[2]) == 0 and not got[0].overflow
    elif case == "cap16":
        assert 0 < int(got[2]) < cap
    else:
        assert int(got[1]) > cap and got[0].overflow
    with pytest.raises(ValueError, match="cap"):
        trav.traverse_step_approx(g, seeds, 4, cut, n_used, 0)
    with pytest.raises(ValueError, match="int32"):
        trav.traverse_step_approx(g, seeds, 4, cut._replace(
            budget=cut.budget.long()), n_used, cap)
    with pytest.raises(ValueError, match=r"must be \["):
        trav.traverse_step_approx(g, seeds, 4, cut._replace(
            budget=cut.budget[:-1]), n_used, cap)


@pytest.mark.parametrize("k", [12, 32])
def test_traversals_cuda_match_cpu(dev, k):
    """traverse_device and traverse_device_approx (m = 1), the k steps of
    each under sync debug mode "error" (no host sync), on the card equal
    their runs on the CPU over the whole cap, with k traverse_step, k
    traverse_step_approx and k range_refine4 launches; the device
    WalkTree probe on the card equals the host probe and the exact
    traversal's survivors."""
    graph, index, sn, so = _offpath_case(k)
    cap = 1 << 13
    snp, sop = (np.resize(np.pad(a, (0, cap - len(a))), cap) for a in (sn, so))
    out = {}
    for d in (dev, torch.device("cpu")):
        g, sa = trav.graph_to_device(graph, d), trav.seeds_to_device(index, d)
        args = (g, sa, torch.from_numpy(snp).to(d),
                torch.from_numpy(sop).to(d), len(sn), k, cap)
        n0 = trav.traverse_step.launches, *_approx_launches()
        if d.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            exact = trav.traverse_device(*args)
            approx = trav.traverse_device_approx(*args, 1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launched = (trav.traverse_step.launches - n0[0],
                    *(a - b for a, b in zip(_approx_launches(), n0[1:])))
        out[d.type] = ([a.cpu().numpy() for a in exact],
                       [a.cpu().numpy() for a in approx], launched)
    (ex, ap, launched), (cex, cap_, claunched) = out["cuda"], out["cpu"]
    assert launched == (k, k, k) and claunched == (0, 0, 0)
    for a, b in zip((*ex, *ap), (*cex, *cap_)):
        np.testing.assert_array_equal(a, b)
    nu = int(ex[3])
    assert nu > 0 and not ex[4]
    tree = trav.enumerate_walks(graph, sn, so, k)
    host = trav.walks_match(tree, index.sorted_keys)
    got = trav.walks_match_device(trav.tree_to_device(tree, dev),
                                  index.sorted_keys)
    for a, b in zip(got, host, strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(host[:3], ex[:3]):
        np.testing.assert_array_equal(a, b[:nu])
    assert host[3:] == tuple(int(v) for v in ex[5])


def test_offpath_routes_cuda_match_cpu(dev, monkeypatch):
    """seeds_all_arrays on the card equals it on the CPU on the WalkTree
    route, the device traversal (PSI_TRAV_CACHE=0) and the mismatch
    route (m = 1): the exact traversal launched traverse_step k times,
    the mismatch route range_refine4 k times per attempt and
    traverse_step_approx as often, and no traverse_step."""
    graph = make_pangenome_graph(30_000, 0.02, seed=8)
    itr = HaplotyperRandomIter(graph, seed=12)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    rng = np.random.RandomState(4)
    reads = hs[rng.randint(0, len(hs) - 100, 300)[:, None] + np.arange(100)]
    recs = Records([f"r{i}" for i in range(300)],
                   [r.tobytes().decode() for r in reads])
    finders = {}
    for device in ("cuda", "cpu"):
        finders[device] = SeedFinder(graph, 20, device=device)
        finders[device].create_path_index(1, patched=False)
    for cache, mm in (("1", 0), ("0", 0), ("1", 1)):
        monkeypatch.setenv("PSI_TRAV_CACHE", cache)
        rows = {}
        for device, finder in finders.items():
            finder.seed_mismatches = mm
            seeds = finder.get_seeds(recs)
            index = finder.index_reads(seeds)
            n0 = trav.traverse_step.launches, *_approx_launches()
            on, off = finder.seeds_all_arrays(seeds, index, split=True)
            launched = (trav.traverse_step.launches - n0[0],
                        *(a - b for a, b in zip(_approx_launches(), n0[1:])))
            rows[device] = [np.sort(a, order=list(a.dtype.names))
                            for a in (on, off)]
            if device == "cuda":
                if mm:
                    assert launched[0] == 0 and launched[1] % 20 == 0
                    assert launched[1] == launched[2] > 0
                else:
                    assert launched == (20 if cache == "0" else 0, 0, 0)
        assert len(rows["cuda"][1]) > 0
        for a, b in zip(rows["cuda"], rows["cpu"]):
            assert a.tobytes() == b.tobytes()


def _probe_keys(rng, n, kind):
    """n sorted int64 keys (about n for the stress kinds): random over
    [0, 2^40), each four times (`duplicates`), all but the first in one
    directory bucket (`one_bucket`), three clusters far apart
    (`gaps`), or repeated on both sides of bucket boundaries, multiples of
    2^30 (`dup_boundary`: the directory's top buckets of this span are
    2^27 wide)."""
    if kind == "duplicates":
        return np.repeat(np.sort(rng.randint(0, 1 << 40, n // 4)), 4)
    if kind == "one_bucket":
        return np.concatenate([[0], (1 << 40) + np.sort(
            rng.randint(0, 1 << 12, n - 1))])
    if kind == "gaps":
        return np.sort(np.concatenate([
            rng.randint(0, 1000, n // 3),
            rng.randint(0, 1000, n // 3) + (1 << 45),
            rng.randint(0, 1 << 20, n - 2 * (n // 3)) + (1 << 61)]))
    if kind == "dup_boundary":
        edge = np.sort(rng.choice(1 << 13, n // 5, replace=False)) << 30
        return np.sort(np.concatenate([edge - 1, edge - 1, edge, edge,
                                       edge + 1]))
    return np.sort(rng.randint(0, 1 << 40, n))


def _probe_case(rng, n, B, kind="random"):
    """Sorted int64 keys with int32 row columns (_probe_keys), and B
    queries of which half, where there are rows, aim at one (near its key,
    with its pair), and a few fall before the first key and after the
    last."""
    pk = _probe_keys(rng, n, kind)
    n = len(pk)
    cols = [rng.randint(0, 50, n).astype(np.int32) for _ in range(2)]
    lo = rng.randint(0, 500, n).astype(np.int32)
    cols += [lo, lo + rng.randint(0, 100, n).astype(np.int32)]
    qkey = rng.randint(-(1 << 20), (1 << 40) + 5, B)
    q = [rng.randint(0, 50, B).astype(np.int32) for _ in range(2)]
    if n:
        aim = rng.randint(0, n, B // 2)
        qkey[: B // 2] = pk[aim] + rng.randint(0, 3, B // 2)
        for j in range(2):
            q[j][: B // 2] = cols[j][aim]
        if kind != "random":
            near = pk[rng.randint(0, n, B - B // 2)]
            qkey[B // 2:] = near + rng.randint(-3, 4, B - B // 2)
        if B >= 200:
            qkey[-200:-100] = pk[0] - rng.randint(1, 50, 100)
            qkey[-100:] = pk[-1] + rng.randint(0, 50, 100)
    s_lo = rng.randint(-50, 600, B).astype(np.int32)
    q += [s_lo, (s_lo + rng.randint(-40, 200, B)).astype(np.int32)]
    return [pk.astype(np.int64), *cols], [qkey.astype(np.int64), *q]


@pytest.mark.parametrize("case", ["random", "n0", "n1", "duplicates",
                                  "negative", "b_empty", "one_bucket",
                                  "gaps", "dup_boundary"])
def test_dindex_probe_kernel_matches_plain(dev, case):
    """probe_bisect's kernel, over the tables of make_tables, against
    probe_bisect_plain and probe_sort on the card: random, an empty index
    (no launch, all false), one row, duplicate keys, negative s_hi, B not
    a multiple of the block, an empty batch (no launch), and the key
    directory's stress cases (one bucket, mostly empty buckets, duplicates
    across bucket boundaries). The directory's search in torch gives the
    same; tables without a directory
    and wrong dtypes or shapes raise."""
    from psi_tpu_torch.ops import dindex_probe as dp

    rng = np.random.RandomState(11)
    n = {"random": 200_003, "n0": 0, "n1": 1, "duplicates": 4001,
         "negative": 3000, "b_empty": 500}.get(case, 20_000)
    B = 0 if case == "b_empty" else (1 << 16) + 77
    tabs, qs = _probe_case(rng, n, B, kind=case)
    if case == "negative":
        qs[4] = -rng.randint(0, 100, B).astype(np.int32)
        qs[3] = qs[4] - rng.randint(0, 50, B).astype(np.int32)
    t = dp.make_tables(*(torch.from_numpy(a).to(dev) for a in tabs))
    q = [torch.from_numpy(a).to(dev) for a in qs]
    n0 = dp.probe_bisect.launches
    got = dp.probe_bisect(t, *q)
    torch.cuda.synchronize()
    assert dp.probe_bisect.launches == n0 + (n > 0 and B > 0)
    want = dp.probe_bisect_plain(t, *q)
    assert got.dtype == torch.bool and got.shape == (B,)
    assert torch.equal(got, want) and torch.equal(dp.probe_sort(t, *q), want)
    if n:
        assert torch.equal(dp.directory_search(t, q[0]),
                           torch.searchsorted(t.pk, q[0], right=True))
    cpu = dp.probe_bisect(dp.ProbeTables(*map(torch.from_numpy, tabs)),
                          *map(torch.from_numpy, qs))
    assert torch.equal(got.cpu(), cpu)
    if case in ("random", "duplicates", "one_bucket", "gaps",
                "dup_boundary"):
        assert 0 < int(got.sum()) < B
    if case in ("n0", "negative"):
        assert not got.any()
    with pytest.raises(ValueError, match="int64"):
        dp.probe_bisect(t, q[0].int(), *q[1:])
    with pytest.raises(ValueError, match=r"\[B\]"):
        dp.probe_bisect(t, q[0], q[1].reshape(1, -1), *q[2:])
    bare = dp.ProbeTables(t.pk, *(c.contiguous() for c in t[1:5]))
    with pytest.raises(ValueError, match="make_tables"):
        dp.probe_bisect(bare, *q)      # columns without a directory


def test_dindex_verify_batch_device_matches_host(dev, monkeypatch):
    """verify_batch_device on the card (the kernel, and the sort variant)
    equals the NumPy probe on pairs of a simulated pan-genome."""
    from psi_tpu_torch.dindex import DistanceIndex
    from psi_tpu_torch.ops import dindex_probe as dp
    from psi_tpu_torch.tools import pairs
    from psi_tpu_torch.tools.ggsim import simulate_haplotypes

    graph = make_pangenome_graph(200_000, 0.004, seed=1)
    coords = pairs.hap_coords(graph, [h for _, h in simulate_haplotypes(
        graph, 2, seed=7)])
    pr = pairs.sample_pairs(coords, 1 << 15, 900, seed=3)
    v, o = pairs.loci(coords, pr["hap_a"], pr["pos_a"])
    u, p = pairs.loci(coords, pr["hap_b"], pr["pos_b"])
    idx = DistanceIndex.build(graph, 250, 450)
    want = idx.verify_batch(graph, v, o, u, p)
    assert 0 < want.sum() < len(want)
    for variant in ("bisect", "sort"):
        monkeypatch.setenv("PSI_DINDEX_PROBE", variant)
        n0 = dp.probe_bisect.launches
        got = idx.verify_batch_device(graph, v, o, u, p)
        assert dp.probe_bisect.launches == n0 + (variant == "bisect")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dmax", [450, 2000])
def test_dindex_device_build_matches_native(dev, dmax):
    """The path-doubling build on the card is byte-identical to the native
    DP at two horizons."""
    from psi_tpu_torch import native
    from psi_tpu_torch.dindex import contract_chains
    from psi_tpu_torch.ops import dindex_build

    graph = make_pangenome_graph(500_000, 0.004, seed=1)
    sup = contract_chains(np.diff(graph.label_offsets), graph.out_indptr,
                          graph.out_indices)
    want = native.dindex_super_build(*sup[3:], dmax)
    info = {}
    got = dindex_build.build_super_device(*sup[3:], dmax, device=dev,
                                          info=info)
    assert len(want[1]) > 0 and info["rounds"] > 1
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _mesh_hits(devices, dev, mm):
    g = make_pangenome_graph(20_000, 0.03, seed=3)
    itr = HaplotyperRandomIter(g, seed=4)
    hap = Path(g)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = sequence(hap)
    rng = np.random.RandomState(5)
    reads = Records([f"r{i}" for i in range(400)],
                    [hs[p:p + 80] for p in rng.randint(0, len(hs) - 80, 400)])
    f = SeedFinder(g, 20, devices=devices, seed_mismatches=mm, device=dev)
    f.create_path_index(1, patched=False)
    seeds = f.get_seeds(reads)
    index = f.index_reads(seeds)
    f.prepare_onpath(index)
    n0 = (fm_fused.trie_level.launches, trav.traverse_step.launches,
          trav.range_refine4.launches)
    hits = f.seeds_all_arrays(seeds, index)
    n1 = (fm_fused.trie_level.launches, trav.traverse_step.launches,
          trav.range_refine4.launches)
    order = ["node_id", "node_offset", "read_id", "read_offset",
             "match_len", "gocc"]
    return np.sort(hits, order=order), [b - a for a, b in zip(n0, n1)], f


@pytest.mark.parametrize("mm", [0, 1])
def test_mesh_card_named_twice_matches_single(dev, mm):
    """SeedFinder on a mesh naming the card twice: the sharded chain and
    the loci-sharded traversal (or with one mismatch range_refine4) on
    the card, the single-device finder's lexsorted hits, with the level
    kernels launched once a level a shard."""
    multi, launches, f = _mesh_hits((dev, dev), dev, mm)
    single, _, _ = _mesh_hits(1, dev, mm)
    assert f._get_mesh().size == 2 and len(single) > 0
    np.testing.assert_array_equal(multi, single)
    levels, steps, refine4 = launches
    assert levels > 0 and levels % 2 == 0
    assert (refine4 if mm else steps) % (2 * 20) == 0
    assert (refine4 if mm else steps) > 0


def test_launch_on_a_second_card_while_the_first_is_current():
    """With cuda:0 current, a kernel on cuda:1's tensors runs on cuda:1
    (the launch enters its tensors' device) and matches plain."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.RandomState(3)
    occ = torch.from_numpy(np.cumsum(rng.randint(0, 2, (5001, 4)),
                                     axis=0).astype(np.int32))
    C = torch.tensor([0, 1, 9, 17, 25, 33, 41], dtype=torch.int32)
    c = torch.from_numpy(rng.randint(1, 5, 3000).astype(np.int32))
    lo = torch.from_numpy(rng.randint(0, 5001, 3000).astype(np.int32))
    hi = torch.from_numpy(rng.randint(0, 5001, 3000).astype(np.int32))
    want = fm_pallas.lf_pair_plain(occ, C, c, lo, hi)
    one = torch.device("cuda", 1)
    with torch.cuda.device(0):
        got = fm_pallas.lf_pair(*(t.to(one) for t in (occ, C, c, lo, hi)))
    for g, w in zip(got, want):
        assert g.device == one
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_chr_scale_config_kernels_match_plain(dev):
    """The chromosome-scale configuration (tools/chr_scale) at 120 kbp on
    the card: 4 components, k = 30, 6 patched paths with context 30, loci
    every 10 bp. trie_level once a level over the chunk's trie and
    traverse_step once a step over the uncovered loci of every component,
    each bit-equal to its plain version over the whole frontier."""
    from psi_tpu_torch.tools import chr_scale

    graph = chr_scale.make_graph(0.12)
    finder = chr_scale.make_finder(graph, dev)
    chr_scale.build_index(finder)
    k = chr_scale.SEED_LEN
    seqs = chr_scale.draw_reads(chr_scale.label_text(graph), 2000,
                                np.random.RandomState(chr_scale.READS_SEED))
    index = finder.index_reads(finder.get_seeds(
        Records([f"r{i}" for i in range(len(seqs))], seqs)))
    finder.prepare_onpath(index)
    prep = index._onpath_prep.trie
    arr = finder._get_stream_arrays()
    levels = prep.parents.shape[0]
    assert levels == k - finder._ftab_bits()
    n0 = fm_fused.trie_level.launches
    lo, hi = fm_fused.trie_fused(arr, prep.parents, prep.chars, prep.lo0,
                                 prep.hi0)
    want_lo, want_hi = prep.lo0, prep.hi0
    for j in range(levels):
        want_lo, want_hi = fm_fused.trie_level_plain(
            arr.payloadC, arr.C, prep.parents[j], prep.chars[j], want_lo,
            want_hi)
    torch.cuda.synchronize()
    assert fm_fused.trie_level.launches == n0 + levels
    assert torch.equal(lo, want_lo) and torch.equal(hi, want_hi)
    assert (hi > lo).any()

    sn, so = finder._get_loci_np()
    assert len(np.unique(np.searchsorted(
        [nodes[0] for _, nodes in graph.paths], sn, "right"))) == 4
    cap = 1 << 13
    g = finder._get_graph_arrays()
    seeds = trav.seeds_to_device(index, dev)
    state, n_used = _start_state(seeds, sn, so, cap, dev), len(sn)
    for t in range(k):
        n0 = trav.traverse_step.launches
        got = trav.traverse_step(g, seeds, t, state, n_used, cap)
        assert trav.traverse_step.launches == n0 + 1
        want = trav.traverse_step_plain(g, seeds, t, state, n_used, cap)
        _assert_same_step(got, want)
        state, _, n_used = want


def test_gchar3_config_kernels_match_plain(dev, monkeypatch, tmp_path):
    """The 3 Gchar configuration (tools/gchar3) at 1 Mbp on the card,
    under PSI_SA_DISK=1: 16 components, a bubble every ~1 kbp, k = 30,
    one unpatched path a region, loci every 10 bp and then at every bp.
    gchar3.run on the card gives the index counts and lexsorted hits of
    the run on the cpu, with trie_level once a level and, on the device
    traversal, traverse_step once a step; then trie_level over the
    chunk's trie and traverse_step over every component's loci, each
    bit-equal to its plain version over the whole frontier."""
    from psi_tpu_torch.tools import gchar3

    monkeypatch.setenv("PSI_SA_DISK", "1")
    monkeypatch.setenv("PSI_TRAV_CACHE", "0")
    keep, cpu_keep = {}, {}
    res = gchar3.run(0.001, 2000, dev, workdir=str(tmp_path / "cuda"),
                     keep=keep, log=lambda msg: None)
    cpu = gchar3.run(0.001, 2000, "cpu", workdir=str(tmp_path / "cpu"),
                     graph=keep["graph"], keep=cpu_keep, log=lambda msg: None)
    for key in ("nodes", "fm_chars", "loci", "dindex_intervals",
                "distinct_keys", "on_hits", "off_hits"):
        assert res[key] == cpu[key], key
    quad = ["node_id", "node_offset", "read_id", "read_offset"]
    for part in ("on", "off"):
        got, want = keep[part][quad], cpu_keep[part][quad]
        assert np.array_equal(np.sort(got), np.sort(want)), part
    finder, index = keep["finder"], keep["index"]
    k = gchar3.SEED_LEN
    levels = k - finder._ftab_bits()
    route = res["off_path_route"]
    assert route["route"] == "traverse_device"
    assert res["on_path_launches"]["fm_fused.trie_level"] == levels
    assert res["off_path_launches"]["traverse.traverse_step"] == (
        k * route["attempts"])

    finder.prepare_onpath(index)
    prep = index._onpath_prep.trie
    arr = finder._get_stream_arrays()
    lo, hi = prep.lo0, prep.hi0
    for j in range(levels):
        out = (torch.empty_like(lo), torch.empty_like(hi))
        fm_fused.trie_level(arr.payloadC, arr.C, prep.parents[j],
                            prep.chars[j], lo, hi, *out)
        want = fm_fused.trie_level_plain(arr.payloadC, arr.C, prep.parents[j],
                                         prep.chars[j], lo, hi)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        lo, hi = want
    assert (hi > lo).any()

    sn, so = finder._get_loci_np()
    assert len(np.unique(np.searchsorted(
        [nodes[0] for _, nodes in keep["graph"].paths], sn, "right"))) == 16
    cap = 1 << (len(sn) - 1).bit_length()
    g = finder._get_graph_arrays()
    seeds = trav.seeds_to_device(index, dev)
    state, n_used = _start_state(seeds, sn, so, cap, dev), len(sn)
    for t in range(k):
        n0 = trav.traverse_step.launches
        got = trav.traverse_step(g, seeds, t, state, n_used, cap)
        assert trav.traverse_step.launches == n0 + 1
        want = trav.traverse_step_plain(g, seeds, t, state, n_used, cap)
        _assert_same_step(got, want)
        state, _, n_used = want


def _two_card_chunks(stats_obj, seed_mismatches):
    """Two 800-read chunks of the CLI's stages through a finder on the
    card: (finder, the second chunk's index, its on- and off-path hits)."""
    graph = make_pangenome_graph(30_000, 0.02, seed=8)
    itr = HaplotyperRandomIter(graph, seed=12)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    rng = np.random.RandomState(4)
    reads = hs[rng.randint(0, len(hs) - 100, 800)[:, None] + np.arange(100)]
    seqs = [r.tobytes().decode() for r in reads]
    finder = SeedFinder(graph, 20, stats=stats_obj, device="cuda",
                        seed_mismatches=seed_mismatches)
    finder.create_path_index(1, patched=False)
    for offset in (0, 800):
        recs = Records([f"r{i}" for i in range(800)], seqs,
                       rec_offset=offset)
        seeds = finder.get_seeds(recs)
        index = finder.index_reads(seeds)
        finder.prepare_onpath(index)
        on, off = finder.seeds_all_arrays(seeds, index, split=True)
    return finder, index, on, off


@pytest.mark.parametrize("trav_cache", ["1", "0"])
def test_chunk_spans_and_copies_on_the_card(dev, monkeypatch, trav_cache):
    """One chunk of the CLI's stages on the card (the WalkTree probe or
    the device traversal off path): every stage's span tagged with the
    chunk, and its host-device copies counted, the keys' upload, the
    leaf_perm's and the query's downloads among them; the card built the
    plan of every key."""
    from psi_tpu_torch import stats
    from psi_tpu_torch.stats import SeedFinderStats, Timer

    monkeypatch.setenv("PSI_TRAV_CACHE", trav_cache)
    Timer.reset_all()
    finder, index, on, off = _two_card_chunks(
        SeedFinderStats(), seed_mismatches=0)
    assert len(on) and len(off)
    secs, counts = stats.chunk_totals(800)
    assert {"seeding", "index-reads", "prepare-onpath", "plan-keys",
            "plan-schedule", "plan-upload", "seeds-on-paths", "onpath-keys",
            "onpath-trie",
            "onpath-locate", "onpath-join", "seeds-off-path",
            "offpath-fetch", "offpath-columns"} <= set(secs)
    plan = index._onpath_prep.trie
    assert counts["plan-device-keys"] == plan.n
    assert counts["h2d-bytes"] > 8 * plan.n
    assert counts["d2h-bytes"] >= 4 * (plan.n + plan.parents.shape[1])
    Timer.reset_all()


def test_mismatch_chunk_spans_and_counters_on_the_card(dev):
    """One chunk with seed_mismatches=1 on the card: the exact route's
    spans time the Hamming ball and the approximate traversal, the card
    planned every key of the ball (plan-ball-keys = plan-device-keys),
    neither ball sorted a row (no ball-dedup-rows), approx-slots is k x
    the cap of every attempt of the approximate traversal, and
    approx-step-launches k an attempt."""
    from psi_tpu_torch import stats
    from psi_tpu_torch.stats import SeedFinderStats, Timer

    Timer.reset_all()
    n0 = trav.range_refine4.launches
    finder, index, on, off = _two_card_chunks(
        SeedFinderStats(), seed_mismatches=1)
    assert len(on) and len(off) and trav.range_refine4.launches > n0
    secs, counts = stats.chunk_totals(800)
    assert {"plan-keys", "onpath-keys", "offpath-fetch"} <= set(secs)
    plan = index._onpath_prep.trie
    assert counts["plan-ball-keys"] == counts["plan-device-keys"] == plan.n
    assert "ball-dedup-rows" not in counts
    cap, attempts = (finder.last_traversal[n] for n in ("cap", "attempts"))
    assert counts["approx-slots"] == 20 * sum(cap >> i
                                              for i in range(attempts))
    assert counts["approx-step-launches"] == 20 * attempts
    Timer.reset_all()
