"""psi_tpu_torch.ops.traverse against psi_tpu.ops.traverse on graphs with
an injected 'N' (R2), on the CPU: the WalkTree, its host and device
probes and the hit columns are array-equal for k < 32, and at k = 32 the
probes match psi_tpu's device traversal (where psi_tpu's own WalkTree
loses states whose prefix range end wraps past 2^64, R1); the device
arrays, the range refine (plain versions, which the CPU wrappers run),
the exact traversal's plain step after every depth, the exact and
mismatch-tolerant frontier traversals over the whole cap (overflow
included, on a dense graph too), the packed layout, the retrying
`traverse` and the host BFS mirror are equal to psi_tpu's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psi_tpu.graph import Position
from psi_tpu.graphiter import HaplotyperRandomIter
from psi_tpu.ops import traverse as jtrav
from psi_tpu.pathutil import Path, sequence
from psi_tpu.records import Records, SeedsIndex, seeding
from psi_tpu.simulate import make_pangenome_graph
from psi_tpu_torch.ops import traverse as trav


def _graph_reads(seed, k, n_reads=30, t_first=False, rate=0.05):
    rng = np.random.RandomState(seed)
    graph = make_pangenome_graph(1500, rate, indel_frac=0.4, seed=seed)
    graph.labels = graph.labels.copy()     # an 'N' kills walks through it
    graph.labels[rng.randint(0, len(graph.labels))] = ord("N")
    itr = HaplotyperRandomIter(graph, seed=seed + 1)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = sequence(hap)
    starts = rng.randint(0, len(hs) - k, n_reads)
    if t_first:
        # reads whose first char is T: the k=32 prefix ranges that wrap
        ts = np.array([p for p in range(len(hs) - k) if hs[p] == "T"])
        starts = np.concatenate([starts, rng.choice(ts, n_reads)])
    reads = Records([f"r{i}" for i in range(len(starts))],
                    [hs[p: p + k] for p in starts])
    index = SeedsIndex(seeding(reads, k, k))
    loci = [Position(n, o) for n in range(1, graph.node_count + 1)
            for o in range(graph.node_length(n))]
    sn = np.array([p.node_id() for p in loci], dtype=np.int32)
    so = np.array([p.offset() for p in loci], dtype=np.int32)
    return graph, index, loci, sn, so


@pytest.mark.parametrize("seed", [3, 11])
def test_walk_tree_matches_psi_tpu(seed):
    k = int(np.random.RandomState(seed).randint(6, 16))
    graph, index, loci, sn, so = _graph_reads(seed, k)
    got = trav.enumerate_walks(graph, sn, so, k)
    want = jtrav.enumerate_walks(graph, sn, so, k)
    assert got.k == want.k and got.n_init == want.n_init
    assert got.n_nodes == want.n_nodes
    np.testing.assert_array_equal(got.ccount0, want.ccount0)
    np.testing.assert_array_equal(got.locus, want.locus)
    for field in ("parent", "okn", "klo", "ccount"):
        for a, b in zip(getattr(got, field), getattr(want, field),
                        strict=True):
            np.testing.assert_array_equal(a, b)
    res = trav.walks_match(got, index.sorted_keys)
    ref = jtrav.walks_match(want, index.sorted_keys)
    for a, b in zip(res, ref, strict=True):
        np.testing.assert_array_equal(a, b)
    assert len(res[0]) > 0
    cols = trav.traverse_columnar_from_states(index, loci, *res[:3], k)
    ref_cols = jtrav.traverse_columnar_from_states(index, loci, *ref[:3], k)
    for a, b in zip(cols, ref_cols, strict=True):
        np.testing.assert_array_equal(a, b)
    assert trav.enumerate_walks(graph, sn, so, k, node_cap=10) is None


def test_walks_match_k32_matches_traverse_device():
    k = 32
    graph, index, loci, sn, so = _graph_reads(5, k, t_first=True)
    tree = trav.enumerate_walks(graph, sn, so, k)
    li, lo, hi, gd, ended, ended_len = trav.walks_match(
        tree, index.sorted_keys
    )
    g = jtrav.graph_to_device(graph)
    sa = jtrav.seeds_to_device(index)
    cap = 1 << 13
    dli, dlo, dhi, nu, ov, ts = jtrav.traverse_device(
        g, sa, jnp.asarray(np.resize(sn, cap)),
        jnp.asarray(np.resize(so, cap)),
        jnp.asarray(len(loci), dtype=jnp.int32), k, cap,
    )
    assert not bool(ov)
    nu = int(nu)
    np.testing.assert_array_equal(li, np.asarray(dli)[:nu])
    np.testing.assert_array_equal(lo, np.asarray(dlo)[:nu])
    np.testing.assert_array_equal(hi, np.asarray(dhi)[:nu])
    assert (gd, ended, ended_len) == tuple(int(v) for v in np.asarray(ts))
    # survivors whose seed starts with T (top key bits 3) are present:
    # exactly the states a wrapping `klo + width` bound would drop
    first = index.sorted_keys[lo] >> np.uint64(2 * k - 2)
    assert (first == 3).any()


def _device_tree_probe(tree, keys):
    return trav.walks_match_device(trav.tree_to_device(tree, "cpu"), keys)


@pytest.mark.parametrize("seed,k", [(3, 9), (11, 14), (5, 32)])
def test_walks_match_device_matches_walks_match(seed, k):
    """The device probe (on the CPU) returns the host probe's survivors,
    order and TraverserStats, at k = 32 too."""
    graph, index, loci, sn, so = _graph_reads(seed, k, t_first=k == 32)
    tree = trav.enumerate_walks(graph, sn, so, k)
    want = trav.walks_match(tree, index.sorted_keys)
    got = _device_tree_probe(tree, index.sorted_keys)
    assert len(want[0]) > 0
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_device_arrays_match_psi_tpu():
    """graph_to_device and seeds_to_device (occ derived from the planes)
    equal psi_tpu's arrays; the derived occ equals the host index's on
    every row the rank reads."""
    graph, index, _, _, _ = _graph_reads(3, 11)
    got, want = trav.graph_to_device(graph, "cpu"), jtrav.graph_to_device(graph)
    for name in ("labels", "label_offsets", "out_indptr", "out_indices"):
        a = getattr(got, name)
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, name)))
    assert got.max_out == want.max_out and (got.labels == 4).any()
    sa, jsa = trav.seeds_to_device(index, "cpu"), jtrav.seeds_to_device(index)
    assert sa.size == jsa.size == index.size
    np.testing.assert_array_equal(sa.planes.numpy(), np.asarray(jsa.planes))
    occ = trav.occ_from_planes(sa.planes)
    assert occ.dtype == torch.int32
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jsa.occ))
    rows = index.size // 32 + 1
    np.testing.assert_array_equal(occ.numpy()[:, :rows], index.occ[:, :rows])


def _refine_inputs(index, rng, n=3000):
    """int32 lo <= hi in [0, V] at the edges (0, V, empty, one key, block
    ends) and at random, and chars 0..3."""
    V = index.size
    lo = rng.randint(0, V + 1, n)
    hi = np.minimum(lo + rng.choice([0, 1, 2, 31, 32, 33, V], n), V)
    lo[:4], hi[:4] = (0, 0, V, 31), (V, 0, V, 32)
    c = rng.randint(0, 4, n)
    return [a.astype(np.int32) for a in (lo, hi, c)]


def test_range_refine_matches_psi_tpu():
    """range_refine_plain (the rank of traverse_step_plain) and
    range_refine4 (its CPU wrapper, which runs the plain version and
    counts no launch) equal psi_tpu's _range_refine at every depth, per
    char and for all four chars."""
    graph, index, _, _, _ = _graph_reads(11, 13, n_reads=400)
    sa, jsa = trav.seeds_to_device(index, "cpu"), jtrav.seeds_to_device(index)
    lo, hi, c = _refine_inputs(index, np.random.RandomState(1))
    n0 = trav.range_refine4.launches
    for depth in range(index.k):
        want = jtrav._range_refine(jsa, depth, jnp.asarray(lo),
                                   jnp.asarray(hi), jnp.asarray(c))
        got = trav.range_refine_plain(sa, depth,
                                      *map(torch.from_numpy, (lo, hi, c)))
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        lo4, hi4 = trav.range_refine4(sa, depth, torch.from_numpy(lo),
                                      torch.from_numpy(hi))
        assert lo4.shape == (len(lo), 4) and lo4.dtype == torch.int32
        for ch in range(4):
            w = jtrav._range_refine(jsa, depth, jnp.asarray(lo),
                                    jnp.asarray(hi),
                                    jnp.full(len(lo), ch, dtype=jnp.int32))
            np.testing.assert_array_equal(lo4[:, ch].numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(hi4[:, ch].numpy(), np.asarray(w[1]))
    assert trav.range_refine4.launches == n0


def _starts(sn, so, cap):
    return [np.resize(np.pad(a, (0, cap - len(a))), cap) for a in (sn, so)]


def _both_traversals(graph, index, sn, so, k, cap, max_mm=0):
    """psi_tpu's and the port's traverse_device (or _approx), on the same
    zero-padded starts: two tuples of numpy arrays."""
    snp, sop = _starts(sn, so, cap)
    g, sa = jtrav.graph_to_device(graph), jtrav.seeds_to_device(index)
    tg, tsa = trav.graph_to_device(graph, "cpu"), trav.seeds_to_device(
        index, "cpu")
    jargs = (g, sa, jnp.asarray(snp), jnp.asarray(sop),
             jnp.asarray(len(sn), dtype=jnp.int32), k, cap)
    targs = (tg, tsa, torch.from_numpy(snp), torch.from_numpy(sop), len(sn),
             k, cap)
    if max_mm:
        want = jtrav.traverse_device_approx(*jargs, max_mm)
        got = trav.traverse_device_approx(*targs, max_mm)
    else:
        want = jtrav.traverse_device(*jargs)
        got = trav.traverse_device(*targs)
    return (tuple(np.asarray(a) for a in got),
            tuple(np.asarray(a) for a in want))


@pytest.mark.parametrize("seed,k", [(3, 12), (5, 32)])
def test_traverse_device_matches_psi_tpu(seed, k):
    """Survivors, their order, n_used and TraverserStats equal psi_tpu's
    over the whole cap (padding slots included), and the survivors equal
    the WalkTree probe's (the port's, which holds at k = 32)."""
    graph, index, loci, sn, so = _graph_reads(seed, k, t_first=k == 32)
    got, want = _both_traversals(graph, index, sn, so, k, 1 << 13)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    li, lo, hi, nu, ov, ts = got
    assert not ov and nu > 0 and ts.dtype == np.int64
    probe = trav.walks_match(trav.enumerate_walks(graph, sn, so, k),
                             index.sorted_keys)
    for a, b in zip((li, lo, hi), probe[:3]):
        np.testing.assert_array_equal(a[:nu], b)
    assert tuple(ts) == probe[3:]


_STEP_CASES = {12: (3, False), 32: (5, True)}   # k: (seed, t_first)


@pytest.fixture(scope="module")
def plain_steps():
    """Per k of _STEP_CASES: the graph case, the cap, and the state and
    n_used after every step of traverse_step_plain chained from the
    start (the CPU wrapper traverse_step runs it), on the CPU."""
    out = {}
    for k, (seed, t_first) in _STEP_CASES.items():
        graph, index, loci, sn, so = _graph_reads(seed, k, t_first=t_first)
        cap = 1 << 13
        snp, sop = _starts(sn, so, cap)
        g, sa = trav.graph_to_device(graph, "cpu"), trav.seeds_to_device(
            index, "cpu")
        state = trav.TraverseState(
            locus_idx=torch.arange(cap, dtype=torch.int32),
            node=torch.from_numpy(snp), off=torch.from_numpy(sop),
            lo=torch.zeros(cap, dtype=torch.int32),
            hi=torch.full((cap,), index.size, dtype=torch.int32),
            overflow=torch.zeros((), dtype=torch.bool),
            tstats=torch.zeros(3, dtype=torch.int64))
        n_used, after = len(sn), []
        for t in range(k):
            state, new_n, n_used = trav.traverse_step(g, sa, t, state, n_used,
                                                      cap)
            after.append((state, new_n, n_used))
        out[k] = (graph, index, sn, so, cap, after)
    return out


@pytest.mark.parametrize("k,depth", [(k, d) for k in _STEP_CASES
                                     for d in range(1, k + 1)])
def test_traverse_step_plain_matches_psi_tpu(plain_steps, k, depth):
    """The state after `depth` plain steps (chained by traverse_step on
    the CPU) equals psi_tpu's traverse_device run with k = depth, over the
    whole cap: locus_idx, lo, hi, n_used, overflow and TraverserStats; the
    step's new_n is the count of children it formed."""
    graph, index, sn, so, cap, after = plain_steps[k]
    state, new_n, n_used = after[depth - 1]
    snp, sop = _starts(sn, so, cap)
    want = jtrav.traverse_device(
        jtrav.graph_to_device(graph), jtrav.seeds_to_device(index),
        jnp.asarray(snp), jnp.asarray(sop),
        jnp.asarray(len(sn), dtype=jnp.int32), depth, cap)
    got = (state.locus_idx, state.lo, state.hi, n_used, state.overflow,
           state.tstats)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert new_n.dtype == n_used.dtype == torch.int64
    assert int(n_used) <= min(int(new_n), cap)


@pytest.mark.parametrize("seed,k", [(7, 12), (9, 20)])
def test_traverse_device_dense_graph_overflows_then_fits(seed, k):
    """On a dense graph (a bubble every ~7 bp) the traversal overflows
    its first cap, the next power of two above the loci (the flag and
    every array over the whole cap equal psi_tpu's), then fits at twice
    that cap, equal to psi_tpu's and to the WalkTree probe; `traverse`
    retries from the first cap to the same hits as psi_tpu's."""
    graph, index, loci, sn, so = _graph_reads(seed, k, n_reads=60,
                                              rate=0.15)
    cap = 1 << (len(sn) - 1).bit_length()
    for c, overflows in ((cap, True), (2 * cap, False)):
        got, want = _both_traversals(graph, index, sn, so, k, c)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        assert bool(got[4]) == overflows
    li, lo, hi, nu, _, ts = got
    probe = trav.walks_match(trav.enumerate_walks(graph, sn, so, k),
                             index.sorted_keys)
    for a, b in zip((li, lo, hi), probe[:3]):
        np.testing.assert_array_equal(a[:nu], b)
    assert nu > 0 and tuple(ts) == probe[3:]
    g, sa = trav.graph_to_device(graph, "cpu"), trav.seeds_to_device(
        index, "cpu")
    hits = _sorted_hits(trav.traverse(graph, g, sa, index, loci, k, cap=cap))
    np.testing.assert_array_equal(hits, _sorted_hits(jtrav.traverse(
        graph, jtrav.graph_to_device(graph), jtrav.seeds_to_device(index),
        index, loci, k, cap=cap)))
    assert len(hits) > 0


def test_traverse_device_overflow_matches_psi_tpu():
    """At a cap the first fork overflows (exactly the loci), the flag and
    every array equal psi_tpu's."""
    graph, index, loci, sn, so = _graph_reads(3, 12)
    got, want = _both_traversals(graph, index, sn, so, 12, len(sn))
    assert got[4] and want[4]
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_mm", [0, 1])
def test_traverse_device_packed_layout(max_mm):
    """One [3*cap + 5] vector (locus_idx | lo | hi | n_used, overflow,
    tstats), int64, equal to psi_tpu's int32 vector and to the unpacked
    outputs."""
    graph, index, loci, sn, so = _graph_reads(11, 10)
    cap = 1 << 13
    snp, sop = _starts(sn, so, cap)
    tg, tsa = trav.graph_to_device(graph, "cpu"), trav.seeds_to_device(
        index, "cpu")
    targs = (tg, tsa, torch.from_numpy(snp), torch.from_numpy(sop), len(sn),
             10, cap)
    packed = trav.traverse_device_packed(*targs, max_mm).numpy()
    want = np.asarray(jtrav.traverse_device_packed(
        jtrav.graph_to_device(graph), jtrav.seeds_to_device(index),
        jnp.asarray(snp), jnp.asarray(sop),
        jnp.asarray(len(sn), dtype=jnp.int32), 10, cap, max_mm))
    assert packed.shape == (3 * cap + 5,) and packed.dtype == np.int64
    np.testing.assert_array_equal(packed, want)
    outs = (trav.traverse_device_approx(*targs, max_mm) if max_mm
            else trav.traverse_device(*targs))
    for i, a in enumerate(outs[:3]):
        np.testing.assert_array_equal(packed[i * cap: (i + 1) * cap], a)
    np.testing.assert_array_equal(packed[3 * cap: 3 * cap + 2],
                                  [int(outs[3]), int(outs[4])])
    if not max_mm:
        np.testing.assert_array_equal(packed[3 * cap + 2:], outs[5])
    else:
        assert not packed[3 * cap + 2:].any()


@pytest.mark.parametrize("max_mm", [1, 2])
def test_traverse_device_approx_matches_psi_tpu(max_mm):
    """The mismatch-tolerant traversal over the whole cap equals
    psi_tpu's: survivors, order, budget-chosen chars, n_used and the
    overflow flag (the forks per read character overflow this cap)."""
    graph, index, loci, sn, so = _graph_reads(3, 12)
    got, want = _both_traversals(graph, index, sn, so, 12, 1 << 13, max_mm)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    assert got[3] > 0 and got[4]


def _approx_step_model(g, seeds, t, state, n_used, cap):
    """csrc/traverse_step_approx.cu's contract, parent by parent in
    NumPy: range_refine4 over the parent state, each parent's graph
    children in edge order, a survivor per (graph child, char) in char
    order, survivors past the cap dropped, and every slot from n2 on the
    record of graph child slot cap - 1 with char 0. Returns (fields [6,
    cap], new_n, n2, overflow)."""
    lo4, hi4 = (a.numpy() for a in trav.range_refine4_plain(
        seeds, t, state.lo, state.hi))
    labels, loff, indptr, indices = (a.numpy().astype(np.int64) for a in (
        g.labels, g.label_offsets, g.out_indptr, g.out_indices))
    locus, node, off, budget = (getattr(state, f).numpy().astype(np.int64)
                                for f in ("locus_idx", "node", "off",
                                          "budget"))
    n_used = min(max(int(n_used), 0), cap)

    def parent(s, in_use):
        sn = max(node[s], 1)
        at_end = in_use and off[s] >= loff[sn] - loff[sn - 1]
        count = (indptr[sn] - indptr[sn - 1] if at_end else 1) if in_use \
            else 0
        return at_end, count

    def child(s, at_end, j):
        nb = 0
        if len(indices):
            e = indptr[max(node[s], 1) - 1] + j
            nb = indices[min(max(e, 0), len(indices) - 1)]
        cn, co = (nb, 0) if at_end else (node[s], off[s])
        c = labels[min(max(loff[max(cn, 1) - 1] + co, 0), len(labels) - 1)]
        return cn, co, c

    def record(s, cn, co, c, r):
        return (locus[s], cn, co + 1, lo4[s, r], hi4[s, r],
                budget[s] - (r != min(max(c, 0), 3)))

    out = np.zeros((6, cap), dtype=np.int64)
    new_n = n2 = 0
    pad = None
    for s in range(n_used):
        at_end, count = parent(s, True)
        for j in range(min(count, max(0, cap - new_n))):
            cn, co, c = child(s, at_end, j)
            if new_n + j == cap - 1:
                pad = record(s, cn, co, c, 0)
            for r in range(4):
                if (c < 4 and lo4[s, r] < hi4[s, r]
                        and budget[s] >= (r != min(max(c, 0), 3))):
                    if n2 < cap:
                        out[:, n2] = record(s, cn, co, c, r)
                    n2 += 1
        new_n += count
    if new_n < cap:
        s = cap - 1
        at_end, count = parent(s, s < n_used)
        pad = record(s, *child(s, at_end, s - (new_n - count)), 0)
    out[:, n2:] = np.asarray(pad)[:, None]
    overflow = bool(state.overflow) or new_n > cap or n2 > cap
    return out, new_n, n2, overflow


@pytest.mark.parametrize("max_mm", [1, 2])
def test_traverse_step_approx_plain_loop_matches_device_approx(max_mm):
    """k steps of traverse_step_approx_plain chained from the start equal
    traverse_device_approx over the whole cap, and each step equals the
    step kernel's contract (`_approx_step_model`: the rank over the parent
    state, the survivors in (graph child, char) order, the padding
    record) whole cap, counts and overflow included, through the cap's
    overflow; on the CPU route no step kernel launches and the
    approx-step-launches counter stays at 0."""
    from psi_tpu_torch import stats

    graph, index, loci, sn, so = _graph_reads(3, 12)
    cap, k = 1 << 13, 12
    snp, sop = (torch.from_numpy(a) for a in _starts(sn, so, cap))
    g, sa = trav.graph_to_device(graph, "cpu"), trav.seeds_to_device(
        index, "cpu")
    n0 = trav.traverse_step_approx.launches, trav.range_refine4.launches
    with stats.timeit_ts("seeds-off-path", chunk=9_122 + max_mm):
        got = trav.traverse_device_approx(g, sa, snp, sop, len(sn), k, cap,
                                          max_mm)
    _, counters = stats.chunk_totals(9_122 + max_mm)
    assert counters.get("approx-step-launches", 0) == 0
    assert (trav.traverse_step_approx.launches,
            trav.range_refine4.launches) == n0
    state = trav.ApproxState(
        locus_idx=torch.arange(cap, dtype=torch.int32), node=snp, off=sop,
        lo=torch.zeros(cap, dtype=torch.int32),
        hi=torch.full((cap,), index.size, dtype=torch.int32),
        budget=torch.full((cap,), max_mm, dtype=torch.int32),
        overflow=torch.zeros((), dtype=torch.bool))
    n_used, overflowed = len(sn), []
    for t in range(k):
        want = _approx_step_model(g, sa, t, state, n_used, cap)
        state, new_n, n_used = trav.traverse_step_approx_plain(
            g, sa, t, state, n_used, cap)
        fields = np.stack([getattr(state, f).numpy() for f in
                           trav.ApproxState._fields[:6]])
        assert fields.dtype == np.int32 and n_used.dtype == torch.int64
        np.testing.assert_array_equal(fields, want[0])
        assert (int(new_n), int(n_used), bool(state.overflow)) == want[1:]
        overflowed.append(bool(state.overflow))
    assert any(overflowed) and not overflowed[0] and int(n_used) > 0
    for a, b in zip(got, (state.locus_idx, state.lo, state.hi,
                          n_used.to(torch.int32), state.overflow),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _sorted_hits(raw):
    a = np.array(raw, dtype=np.int64).reshape(-1, 5)
    return a[np.lexsort(a.T[::-1])]


def test_traverse_and_traverse_host_match_psi_tpu():
    """`traverse` (device traversal with overflow retry: the 1024 cap
    doubles) and the host BFS mirror, exact and with 1 and 2 mismatches,
    give psi_tpu's hit multisets; exact, the two routes agree."""
    graph, index, loci, sn, so = _graph_reads(11, 11)
    g, sa = trav.graph_to_device(graph, "cpu"), trav.seeds_to_device(
        index, "cpu")
    got = _sorted_hits(trav.traverse(graph, g, sa, index, loci, 11, cap=1024))
    want = _sorted_hits(jtrav.traverse(
        graph, jtrav.graph_to_device(graph), jtrav.seeds_to_device(index),
        index, loci, 11, cap=1024))
    np.testing.assert_array_equal(got, want)
    assert len(got) > 0
    for m in (0, 1, 2):
        host = _sorted_hits(trav.traverse_host(graph, index, loci, 11, m))
        np.testing.assert_array_equal(host, _sorted_hits(
            jtrav.traverse_host(graph, index, loci, 11, max_mismatches=m)))
        if m == 0:
            np.testing.assert_array_equal(host, got)
        else:
            assert len(host) > len(got)
