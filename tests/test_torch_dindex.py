"""psi_tpu_torch's distance index against psi_tpu's on the CPU: the chain
contraction, the super DP and the cyclic node-mode fallback, the scalar
and batched verification, the probe variants against psi_tpu's JAX
probes, the torch path-doubling build against the native DP, save and
load across the two packages, merge, and the SeedFinder lifecycle.
Inputs are random DAGs (test_dindex.py's pattern) and simulated
pan-genomes, made from numpy seeds; every comparison is exact."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from psi_tpu import cli as jcli
from psi_tpu.dindex import DistanceIndex as JIndex
from psi_tpu.dindex import contract_chains as jcontract
from psi_tpu.graph import Graph as JGraph
from psi_tpu.ops import dindex_probe as jprobe
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu.simulate import make_pangenome_graph as jmake_graph
from psi_tpu_torch import cli, native
from psi_tpu_torch.dindex import DistanceIndex, contract_chains
from psi_tpu_torch.graph import Graph
from psi_tpu_torch.ops import dindex_build, dindex_probe
from psi_tpu_torch.seed_finder import SeedFinder
from psi_tpu_torch.simulate import make_pangenome_graph

COLS = ("src_indptr", "dst", "iv_lo", "iv_hi")


def _parts(rng, n, cyclic=False):
    nodes = {
        i + 1: "".join(rng.choice(list("ACGT"), size=rng.randint(1, 12)))
        for i in range(n)
    }
    edges = []
    for v in range(1, n):
        for _ in range(rng.randint(1, 3)):
            edges.append((v, int(rng.randint(v + 1, n + 1))))
    if cyclic:     # every node reaches node n, so these close cycles
        edges += [(n, int(rng.randint(1, n // 2))) for _ in range(3)]
    return nodes, edges


def _graphs(seed, n, cyclic=False):
    """The same random DAG (or, cyclic, with back edges) as a psi_tpu and
    a port Graph."""
    nodes, edges = _parts(np.random.RandomState(seed), n, cyclic)
    return (Graph.from_parts(nodes=nodes, edges=edges, paths=[("ref", [1])]),
            JGraph.from_parts(nodes=nodes, edges=edges, paths=[("ref", [1])]))


def _same_index(got, want):
    assert (got.mode, got.dmin, got.dmax, got.n_nodes) == \
        (want.mode, want.dmin, want.dmax, want.n_nodes)
    for name in COLS + (("sup", "head", "tail") if want.mode == "super"
                        else ()):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def _queries(rng, g, M):
    n = g.node_count
    ids = np.arange(1, n + 1)
    v = ids[rng.randint(0, n, M)]
    u = ids[rng.randint(0, n, M)]
    nl = np.diff(g.label_offsets)
    o = (rng.rand(M) * nl[v - 1]).astype(np.int64)
    p = (rng.rand(M) * nl[u - 1]).astype(np.int64)
    return v, o, u, p


@pytest.mark.parametrize("seed", range(4))
def test_contract_chains_matches_psi_tpu(seed):
    g, _ = _graphs(seed, int(np.random.RandomState(seed).randint(20, 120)))
    got = contract_chains(np.diff(g.label_offsets), g.out_indptr,
                          g.out_indices)
    want = jcontract(np.diff(g.label_offsets), g.out_indptr, g.out_indices)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("builder", ["native", "python"])
@pytest.mark.parametrize("cyclic", [False, True])
def test_build_matches_psi_tpu(builder, cyclic, monkeypatch):
    """The super DP (native and its Python mirror) on random DAGs, and the
    node-mode BFS fallback (native and Python) on cyclic graphs."""
    import psi_tpu.native as jnat

    for seed in range(3):
        g, jg = _graphs(10 + seed, 90, cyclic)
        if builder == "python":
            for mod in (native, jnat):
                monkeypatch.setattr(mod, "dindex_super_build",
                                    lambda *a, **k: None)
                monkeypatch.setattr(mod, "dindex_build", lambda *a, **k: None)
        got, want = DistanceIndex.build(g, 4, 70), JIndex.build(jg, 4, 70)
        assert got.mode == ("node" if cyclic else "super")
        assert len(got.dst) > 0
        _same_index(got, want)
        monkeypatch.undo()


@pytest.mark.parametrize("cyclic", [False, True])
def test_verify_matches_psi_tpu(cyclic, monkeypatch):
    """verify_batch and the scalar verify on 2,000 pairs, and the device
    probe on the CPU (both variants), equal psi_tpu's answers."""
    g, jg = _graphs(31, 130, cyclic)
    idx, jidx = DistanceIndex.build(g, 5, 90), JIndex.build(jg, 5, 90)
    rng = np.random.RandomState(6)
    v, o, u, p = _queries(rng, g, 2000)
    want = jidx.verify_batch(jg, v, o, u, p)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(idx.verify_batch(g, v, o, u, p), want)
    for variant in ("bisect", "sort"):
        monkeypatch.setenv("PSI_DINDEX_PROBE", variant)
        got = idx.verify_batch_device(g, v, o, u, p, device="cpu")
        np.testing.assert_array_equal(got, want)
    for i in range(2000):
        args = int(v[i]), int(o[i]), int(u[i]), int(p[i])
        assert idx.verify(g, *args) == jidx.verify(jg, *args)


@pytest.mark.parametrize("variant", ["bisect", "sort"])
def test_verify_batch_device_cpu_matches_psi_tpu(variant, monkeypatch):
    """PSI_DINDEX_PROBE picks the variant in both packages; the port's
    device probe on the CPU equals psi_tpu's JAX probe and the host
    probe, and an index with no rows answers by arithmetic alone."""
    monkeypatch.setenv("PSI_DINDEX_PROBE", variant)
    g, jg = _graphs(17, 150)
    idx, jidx = DistanceIndex.build(g, 5, 90), JIndex.build(jg, 5, 90)
    v, o, u, p = _queries(np.random.RandomState(3), g, 4000)
    want = jidx.verify_batch_device(jg, v, o, u, p)
    np.testing.assert_array_equal(
        idx.verify_batch_device(g, v, o, u, p, device="cpu"), want)
    np.testing.assert_array_equal(idx.verify_batch(g, v, o, u, p), want)
    # one chain: a single supernode, no rows
    nodes = {1: "ACGTACGT", 2: "GGA", 3: "TTTTCA"}
    edges = [(1, 2), (2, 3)]
    chain = Graph.from_parts(nodes=nodes, edges=edges, paths=[("r", [1])])
    jchain = JGraph.from_parts(nodes=nodes, edges=edges, paths=[("r", [1])])
    e, je = DistanceIndex.build(chain, 2, 9), JIndex.build(jchain, 2, 9)
    assert len(e.dst) == 0
    v, o, u, p = _queries(np.random.RandomState(4), chain, 300)
    want = je.verify_batch_device(jchain, v, o, u, p)
    assert want.any()
    np.testing.assert_array_equal(
        e.verify_batch_device(chain, v, o, u, p, device="cpu"), want)


_PROBE_CASES = ["random", "one_row", "edges", "duplicates", "one_bucket",
                "gaps", "dup_boundary"]


def _probe_keys(rng, case):
    """Sorted int64 keys of a probe case. The last three stress the key
    directory: every key but the first in one bucket; three clusters far
    apart, so most buckets are empty; and keys repeated on both sides of
    bucket boundaries (multiples of 2^30, which the directory's 2^27-wide
    buckets of this span split at)."""
    if case == "one_bucket":
        return np.concatenate([[0], (1 << 40) + np.sort(
            rng.randint(0, 1 << 12, 2999))])
    if case == "gaps":
        return np.sort(np.concatenate([
            rng.randint(0, 1000, 1000), rng.randint(0, 1000, 1000) + (1 << 45),
            rng.randint(0, 1 << 20, 1000) + (1 << 61)]))
    if case == "dup_boundary":
        edge = np.sort(rng.choice(1 << 10, 600, replace=False)) << 30
        return np.sort(np.concatenate([edge - 1, edge - 1, edge, edge,
                                       edge + 1]))
    n = {"random": 3000, "one_row": 1, "edges": 500, "duplicates": 400}[case]
    pk = np.sort(rng.randint(0, 10 ** 6, n))
    if case == "duplicates":
        pk = np.sort(np.repeat(pk[: n // 4], 4))
    return pk


def _probe_inputs(case):
    """Sorted keys with row columns, and queries, for a probe case."""
    rng = np.random.RandomState(_PROBE_CASES.index(case) + 1)
    pk = _probe_keys(rng, case).astype(np.int64)
    n, B = len(pk), 1000
    cols = [rng.randint(0, 40, n).astype(np.int32) for _ in range(2)]
    lo = rng.randint(0, 50, n).astype(np.int32)
    cols += [lo, (lo + rng.randint(0, 30, n)).astype(np.int32)]
    # half the queries aim at a row: near its key, with its pair, around
    # its interval; the rest are random (near a row's key where the keys
    # leave most of their span empty)
    idx = rng.randint(0, n, B)
    rest = (pk[rng.randint(0, n, B - B // 2)] + rng.randint(-3, 4, B - B // 2)
            if case in _PROBE_CASES[4:]
            else rng.randint(-5, 10 ** 6 + 5, B - B // 2))
    qkey = np.concatenate([pk[idx[: B // 2]] + rng.randint(0, 3, B // 2),
                           rest])
    # before the first key and after the last
    qkey[B // 2:B // 2 + 100] = pk[0] - rng.randint(1, 50, 100)
    qkey[B // 2 + 100:B // 2 + 200] = pk[-1] + rng.randint(0, 50, 100)
    q = [np.where(np.arange(B) < B // 2, c[idx], rng.randint(0, 40, B)
                  ).astype(np.int32) for c in cols[:2]]
    s_lo = (cols[2][idx] + rng.randint(-30, 30, B)).astype(np.int32)
    q += [s_lo, (s_lo + rng.randint(-10, 40, B)).astype(np.int32)]
    return [pk, *cols], [qkey.astype(np.int64), *q]


@pytest.mark.parametrize("case", _PROBE_CASES)
def test_probe_variants_match_psi_tpu(case):
    """probe_bisect (its plain version on the CPU), probe_bisect_plain and
    probe_sort against psi_tpu's JAX probe_bisect and probe_sort, which
    take the keys as 31-bit halves; and what the kernel reads, built by
    make_tables: the key directory (its buckets, and its search in torch,
    directory_search, against torch.searchsorted), and the row records,
    whose checks at the directory's r give the same answers."""
    tabs, qs = _probe_inputs(case)
    halves = []
    for key in (tabs[0], qs[0]):
        halves += [jnp.asarray((key >> 31).astype(np.int32)),
                   jnp.asarray((key & 0x7FFFFFFF).astype(np.int32))]
    jargs = (*halves[:2], *map(jnp.asarray, tabs[1:]), *halves[2:],
             *map(jnp.asarray, qs[1:]))
    want = np.asarray(jprobe.probe_bisect(*jargs))
    np.testing.assert_array_equal(np.asarray(jprobe.probe_sort(*jargs)), want)
    assert want.any() and not want.all()
    t = dindex_probe.ProbeTables(*map(torch.as_tensor, tabs))
    q = [torch.as_tensor(x) for x in qs]
    n0 = dindex_probe.probe_bisect.launches
    for fn in (dindex_probe.probe_bisect, dindex_probe.probe_bisect_plain,
               dindex_probe.probe_sort):
        got = fn(t, *q)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn.__name__)
    assert dindex_probe.probe_bisect.launches == n0     # CPU: plain version

    d = dindex_probe.make_tables(*map(torch.as_tensor, tabs))
    n = len(tabs[0])
    assert d.rows.shape == (n, 4) and d.rows.is_contiguous()
    for j, col in enumerate(tabs[1:]):
        np.testing.assert_array_equal(d.rows[:, j].numpy(), col)
    split = _check_directory(d)
    r = dindex_probe.directory_search(d, q[0])
    assert torch.equal(r, torch.searchsorted(d.pk, q[0], right=True))
    got = dindex_probe._checks(d, r, *q[1:])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dindex_probe.probe_bisect(d, *q).numpy(),
                                  want)
    if case == "one_bucket":     # the one big bucket splits
        assert split == 1
    if case == "gaps":           # most top buckets are empty
        empty = (d.top[:, 0] == d.top[:, 1]) & (d.top[:, 2] < 0)
        assert empty.float().mean() > 0.9 and split > 0


def _check_directory(d) -> int:
    """The two-level key directory's invariants: the top buckets are
    key_buckets' (their first rows, the key range of each), a bucket of
    more than SPLIT_ROWS rows splits into 2^m sub-buckets whose first rows
    rise from the bucket's first row to its end and hold the rows of their
    sub-bucket id, and the rest hold their end. Returns the split
    buckets."""
    dp = dindex_probe
    n = d.pk.shape[0]
    starts, shift = dp.key_buckets(d.pk, min(dp.DIR_BITS, n.bit_length() + 1))
    top, sub = d.top.long(), d.sub.long()
    assert shift == d.shift and top.shape == (starts.numel() - 1, 4)
    assert torch.equal(top[:, 0], starts[:-1])
    count = starts.diff()
    split = top[:, 2] >= 0
    assert torch.equal(split, count > dp.SPLIT_ROWS)
    assert torch.equal(top[~split, 1], starts[1:][~split])
    k0 = int(d.pk[0])
    for j in torch.nonzero(split).flatten().tolist():
        off, s, m = int(top[j, 2]), int(top[j, 3]) & 0xFF, int(top[j, 3]) >> 8
        assert m == max(1, min(16, int(np.ceil(np.log2(
            int(count[j]) / dp.SUB_ROWS)))))
        first = sub[top[j, 1]:top[j, 1] + (1 << m) + 1]
        assert first[0] == starts[j] and first[-1] == starts[j + 1]
        assert (first.diff() >= 0).all()
        edge = ((k0 >> shift) + j) << shift
        keys = d.pk[starts[j]:starts[j + 1]]
        sid = ((keys - edge) >> s) - off
        assert torch.equal(sid, torch.repeat_interleave(
            torch.arange(1 << m), first.diff()))
    return int(split.sum())


def test_probe_empty_index():
    """n = 0: every variant answers all false (psi_tpu's index returns
    before its probe there)."""
    t = dindex_probe.ProbeTables(torch.zeros(0, dtype=torch.int64),
                                 *(torch.zeros(0, dtype=torch.int32),) * 4)
    q = [torch.arange(7, dtype=torch.int64)] + [
        torch.zeros(7, dtype=torch.int32)] * 4
    for fn in (dindex_probe.probe_bisect, dindex_probe.probe_bisect_plain,
               dindex_probe.probe_sort):
        assert not fn(t, *q).any() and fn(t, *q).shape == (7,)


def _super_inputs(graph):
    sup, head, tail, sup_len, ip, ix = contract_chains(
        np.diff(graph.label_offsets), graph.out_indptr, graph.out_indices)
    return sup_len, ip, ix


@pytest.mark.parametrize("dmax", [1, 60, 450, 2000])
@pytest.mark.parametrize("join_cap", [None, 5000])
def test_device_build_matches_native(dmax, join_cap):
    """The torch path doubling on the CPU is byte-identical to psi_tpu's
    native DP on a simulated pan-genome, in one join or in pieces."""
    g = make_pangenome_graph(60_000, 0.006, seed=5)
    jg = jmake_graph(60_000, 0.006, seed=5)
    import psi_tpu.native as jnat

    sup_len, ip, ix = _super_inputs(g)
    want = jnat.dindex_super_build(*jcontract(
        np.diff(jg.label_offsets), jg.out_indptr, jg.out_indices)[3:], dmax)
    info = {}
    got = dindex_build.build_super_device(sup_len, ip, ix, dmax, device="cpu",
                                          join_cap=join_cap, info=info)
    assert len(want[1]) > 0
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert 1 <= info["rounds"] <= int(dmax).bit_length() + 1
    if join_cap and dmax > 60:
        assert info["pieces"] > info["rounds"]


def test_device_build_orders_by_three_passes_past_int64():
    """Where (src, dst, lo) does not fit one int64 key (S^2 (cap + 1) >=
    2^62, a genome-scale supernode count), three stable sorts give the
    composite key's order."""
    rng = np.random.RandomState(5)
    src, dst = (torch.from_numpy(rng.randint(0, 300, 5000)) for _ in "ab")
    lo = torch.from_numpy(rng.randint(0, 60, 5000))
    key = (src * 300 + dst) * 61 + lo
    wide = dindex_build._order(src, dst, lo, 1 << 31, 60)
    assert torch.equal(key[wide], torch.sort(key).values)
    assert torch.equal(key[dindex_build._order(src, dst, lo, 300, 60)],
                       key[wide])


def test_device_build_through_build_matches_psi_tpu(monkeypatch):
    """PSI_DINDEX_BUILD=device in both packages (the port on the CPU, as
    the finder's device) gives psi_tpu's index; a join over the cap
    raises instead of falling back to the native DP."""
    g, jg = _graphs(23, 120)
    want = JIndex.build(jg, 2, 60)
    monkeypatch.setenv("PSI_DINDEX_BUILD", "device")
    monkeypatch.setattr(native, "dindex_super_build", None)  # not reached
    got = DistanceIndex.build(g, 2, 60, device="cpu")
    _same_index(got, want)
    finder = SeedFinder(g, 12, device="cpu")
    finder.create_distance_index(2, 60)
    _same_index(finder.dindex, want)
    with pytest.raises(RuntimeError, match="join cap"):
        dindex_build.build_super_device(*_super_inputs(g), 60, device="cpu",
                                        join_cap=1)


def test_device_entry_points_default_to_the_card(monkeypatch):
    """Without a GPU the device build and verify_batch_device raise: they
    run on the card unless told otherwise."""
    g, _ = _graphs(2, 40)
    idx = DistanceIndex.build(g, 2, 30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, o, u, p = _queries(np.random.RandomState(1), g, 50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        idx.verify_batch_device(g, v, o, u, p)
    monkeypatch.setenv("PSI_DINDEX_BUILD", "device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistanceIndex.build(g, 2, 30)
    with pytest.raises(ValueError, match="PSI_DINDEX_PROBE"):
        monkeypatch.setenv("PSI_DINDEX_PROBE", "gather")
        idx.verify_batch_device(g, v, o, u, p, device="cpu")


def test_device_tables_once_per_index_and_device(monkeypatch):
    """The probe tables, with the row records and key directory, are
    uploaded once per index and device; a merged index has its own."""
    g, _ = _graphs(8, 80)
    idx = DistanceIndex.build(g, 3, 40)
    dev = torch.device("cpu")
    t1 = idx._device_tables(dev)
    assert idx._device_tables(dev) is t1
    assert t1.pk.dtype == torch.int64 and t1.src.dtype == torch.int32
    np.testing.assert_array_equal(t1.pk.numpy(), idx._pair_keys())
    # the kernel's row records and key directory come with the upload
    assert t1.rows.shape == (len(idx.dst), 4) and t1.top.shape[1] == 4
    np.testing.assert_array_equal(t1.rows[:, 1].numpy(), idx.dst)
    merged = idx.merge(DistanceIndex.build(g, 41, 60))
    assert getattr(merged, "_dev", None) is None
    assert merged._device_tables(dev) is not t1


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_save_load_across_packages(direction, big, tmp_path, monkeypatch):
    """An artifact saved by either package loads in the other array-equal
    and probe-equal, with the big columns spilled to memory-mapped side
    files under PSI_DINDEX_MMAP_BYTES (read when the class is made, so
    set here on the class)."""
    g, jg = _graphs(21, 80)
    idx, jidx = DistanceIndex.build(g, 2, 40), JIndex.build(jg, 2, 40)
    if big:
        monkeypatch.setattr(DistanceIndex, "BIG_COL_BYTES", 8)
        monkeypatch.setattr(JIndex, "BIG_COL_BYTES", 8)
    path = str(tmp_path / "d.npz")
    saver, loader = ((idx, JIndex) if direction == "torch_to_jax"
                     else (jidx, DistanceIndex))
    saver.save(path)
    assert (tmp_path / "d.dst.npy").exists() == big
    back = loader.load(path)
    if big:
        assert isinstance(back.dst, np.memmap)
    _same_index(back, jidx if direction == "torch_to_jax" else idx)
    v, o, u, p = _queries(np.random.RandomState(9), g, 1000)
    np.testing.assert_array_equal(back.verify_batch(g, v, o, u, p),
                                  idx.verify_batch(g, v, o, u, p))
    other = str(tmp_path / "other.npz")
    (idx if direction == "jax_to_torch" else jidx).save(other)
    with np.load(path) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("r1,r2", [
    ((8, 12), (13, 20)),   # adjacent ranges
    ((8, 15), (12, 25)),   # overlapping ranges
    ((5, 30), (10, 20)),   # containment
])
def test_merge_matches_psi_tpu(r1, r2):
    """merge equals psi_tpu's merge and the direct build at the union."""
    for seed in range(3):
        g, jg = _graphs(100 + seed, 100)
        got = DistanceIndex.build(g, *r1).merge(DistanceIndex.build(g, *r2))
        want = JIndex.build(jg, *r1).merge(JIndex.build(jg, *r2))
        _same_index(got, want)
        lo, hi = min(r1[0], r2[0]), max(r1[1], r2[1])
        direct = DistanceIndex.build(g, lo, hi)
        for name in COLS:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(direct, name))


def test_merge_rejects_gap_and_modes():
    g, _ = _graphs(7, 60)
    with pytest.raises(ValueError, match="non-contiguous"):
        DistanceIndex.build(g, 5, 8).merge(DistanceIndex.build(g, 20, 30))
    cg, _ = _graphs(7, 60, cyclic=True)
    with pytest.raises(ValueError, match="different modes"):
        DistanceIndex.build(g, 5, 8).merge(DistanceIndex.build(cg, 9, 12))


def test_seed_finder_lifecycle_matches_psi_tpu(tmp_path):
    """create_path_index with an insert size builds the index, the
    artifact of serialize_path_index is array-equal to psi_tpu's, and
    load_path_index opens it (no rebuild) or, when it is missing, builds
    and saves it again; verify_distance agrees with psi_tpu's."""
    g = make_pangenome_graph(20_000, 0.01, seed=3)
    jg = jmake_graph(20_000, 0.01, seed=3)
    finder = SeedFinder(g, 12, device="cpu")
    jfinder = JSeedFinder(jg, 12)
    for f in (finder, jfinder):
        f.create_path_index(1, patched=False, dmin=100, dmax=300)
    _same_index(finder.dindex, jfinder.dindex)
    prefix, jprefix = str(tmp_path / "t"), str(tmp_path / "j")
    assert finder.serialize_path_index(prefix)
    assert jfinder.serialize_path_index(jprefix)
    path = SeedFinder.get_dindex_path(prefix, 100, 300)
    assert path.endswith("t_dist_mat_m100M300.npz")
    with np.load(path) as a, np.load(
            JSeedFinder.get_dindex_path(jprefix, 100, 300)) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    loaded = SeedFinder(g, 12, device="cpu")
    built = []
    orig = DistanceIndex.build
    try:
        DistanceIndex.build = staticmethod(
            lambda *a, **k: built.append(a) or orig(*a, **k))
        assert loaded.load_path_index(prefix, dmin=100, dmax=300)
        assert built == []
        _same_index(loaded.dindex, finder.dindex)
        import os

        os.remove(path)
        again = SeedFinder(g, 12, device="cpu")
        assert again.load_path_index(prefix, dmin=100, dmax=300)
        assert len(built) == 1 and os.path.exists(path)
    finally:
        DistanceIndex.build = orig
    _same_index(again.dindex, finder.dindex)
    rng = np.random.RandomState(2)
    v, o, u, p = _queries(rng, g, 300)
    for i in range(300):
        args = int(v[i]), int(o[i]), int(u[i]), int(p[i])
        assert loaded.verify_distance(*args) == jfinder.verify_distance(*args)


def _cli(main, gpath, fq, out_dir, tag, extra=()):
    out, rep = out_dir / f"{tag}.bin", out_dir / f"{tag}.json"
    assert main([gpath, "-f", fq, "-l", "16", "-n", "1", "-P", "-c", "200",
                 "-o", str(out), "--report", str(rep), "-q", "-Q",
                 *extra]) == 0
    hits = np.fromfile(out, dtype="<i8").reshape(-1, 4)
    with open(rep) as fh:
        return hits[np.lexsort(hits.T[::-1])], json.load(fh)


def test_cli_insert_size_matches_psi_tpu(tmp_path, monkeypatch):
    """psikt -m/-M with -I (the path index prefix): the port's CLI (cpu) writes the artifact
    array-equal to psi_tpu's CLI, a second run loads it and builds
    nothing, and the hit stream is the one without -m/-M."""
    monkeypatch.setenv("HOME", str(tmp_path))
    graph = make_pangenome_graph(20_000, 0.01, seed=8)
    gpath = str(tmp_path / "g.npz")
    graph.save(gpath)
    rng = np.random.RandomState(3)
    text = graph.labels.tobytes()
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as fh:
        for i, s in enumerate(rng.randint(0, len(text) - 80, 400)):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, text[s:s + 80], b"I" * 80))
    fq = str(fq)
    plain, _ = _cli(cli.main, gpath, fq, tmp_path, "plain", ("--device", "cpu"))
    assert len(plain) > 0
    dist = ("-m", "150", "-M", "400")
    for main, tag in ((cli.main, "t"), (jcli.main, "j")):
        prefix = str(tmp_path / tag)
        extra = (*dist, "-I", prefix, "--device", "cpu")
        hits, _ = _cli(main, gpath, fq, tmp_path, tag, extra)
        assert hits.tobytes() == plain.tobytes()
    with np.load(str(tmp_path / "t_dist_mat_m150M400.npz")) as a, \
            np.load(str(tmp_path / "j_dist_mat_m150M400.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert len(a["dst"]) > 0
    built = []
    orig = DistanceIndex.build
    monkeypatch.setattr(DistanceIndex, "build", staticmethod(
        lambda *a, **k: built.append(a) or orig(*a, **k)))
    again, _ = _cli(cli.main, gpath, fq, tmp_path, "again",
                    (*dist, "-I", str(tmp_path / "t"), "--device", "cpu"))
    assert built == [] and again.tobytes() == plain.tobytes()
