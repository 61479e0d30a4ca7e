"""The slice as a whole: psi_tpu_torch's CLI with --device cpu against
psi_tpu's CLI (its chained stream route and its defaults) on a small
synthetic pan-genome, at gocc thresholds 0 and 5: equal lexsorted binary
hit streams and equal report seedhits, with hits both on and off the
indexed paths. The port's one on-path route, the chain, against each of
psi_tpu's on-path routes (the gather route and the trie search with a
host locate, which PSI_STREAM and PSI_DEVICE_LOCATE pick for psi_tpu
only), planned by prepare_onpath or by the query, with the native join
and the NumPy one; the MEM and whole-read APIs against psi_tpu's, in
process. The off-path routes (the WalkTree, the device traversal under
PSI_TRAV_CACHE=0 or past PSI_TRAV_CACHE_CAP, the host BFS mirror) and the
mismatch routes (--mismatches 1 and 2) against psi_tpu's, on a graph with
an injected 'N'. Plus the cases the port does not cover yet, which
raise."""

import json

import numpy as np
import pytest
import torch

from psi_tpu import cli as jcli
from psi_tpu.graphiter import HaplotyperRandomIter
from psi_tpu.pathutil import Path, sequence
from psi_tpu.records import Records as JRecords
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu.simulate import make_pangenome_graph
from psi_tpu.stats import SeedFinderStats as JStats
from psi_tpu_torch import cli
from psi_tpu_torch import simulate as tsim
from psi_tpu_torch.ops import fm_fused
from psi_tpu_torch.ops import traverse as trav
from psi_tpu_torch.records import Records
from psi_tpu_torch.seed_finder import SeedFinder
from psi_tpu_torch.stats import SeedFinderStats


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A bubble graph (saved as .npz, which both CLIs load) and FASTQ
    reads of a random haplotype with 1% substitutions."""
    tmp = tmp_path_factory.mktemp("slice")
    graph = make_pangenome_graph(40_000, 0.02, seed=8)
    gpath = str(tmp / "graph.npz")
    graph.save(gpath)
    itr = HaplotyperRandomIter(graph, seed=12)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    rng = np.random.RandomState(4)
    n, L = 1500, 100
    reads = hs[rng.randint(0, len(hs) - L, n)[:, None] + np.arange(L)]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = np.where(rng.random_sample(reads.shape) < 0.01,
                     bases[rng.randint(0, 4, reads.shape)], reads)
    fq = tmp / "reads.fastq"
    with open(fq, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * L))
    return tmp, gpath, str(fq)


def _run(main, tmp, gpath, fq, tag, gocc, extra=(), paths=1):
    out, rep = tmp / f"{tag}.bin", tmp / f"{tag}.json"
    argv = [gpath, "-f", fq, "-l", "20", "-n", str(paths), "-P", "-c", "600",
            "-r", str(gocc), "-o", str(out), "--report", str(rep),
            "-q", "-Q", *extra]
    assert main(argv) == 0
    hits = np.fromfile(out, dtype="<i8").reshape(-1, 4)
    with open(rep) as fh:
        return hits[np.lexsort(hits.T[::-1])], json.load(fh)


# one path leaves every alt allele off the index (off-path hits); eight
# paths put most k-mers on the index 6-8 times, where -r 5 filters them
@pytest.mark.parametrize("gocc,paths", [(0, 1), (5, 8)])
def test_cli_matches_psi_tpu(dataset, monkeypatch, gocc, paths):
    tmp, gpath, fq = dataset
    n0 = fm_fused.trie_level.launches
    got, rep = _run(cli.main, tmp, gpath, fq, f"torch{gocc}", gocc,
                    ("--device", "cpu"), paths)
    assert rep["device"] == "cpu" and len(rep["chunks"]) == 3
    assert sum(c["hits_on"] for c in rep["chunks"]) > 0
    assert rep["seedhits"] == len(got)
    if gocc:
        unfiltered, _ = _run(cli.main, tmp, gpath, fq, "torch_all", 0,
                             ("--device", "cpu"), paths)
        assert 0 < len(got) < len(unfiltered)
    else:
        assert sum(c["hits_off"] for c in rep["chunks"]) > 0
    for env in ({"PSI_STREAM": "1", "PSI_DEVICE_LOCATE": "1"}, {}):
        with monkeypatch.context() as mp:
            for name in ("PSI_STREAM", "PSI_DEVICE_LOCATE"):
                mp.delenv(name, raising=False)
            for name, value in env.items():
                mp.setenv(name, value)
            want, jrep = _run(jcli.main, tmp, gpath, fq, f"jax{gocc}", gocc,
                              ("--device", "cpu"), paths)
        assert got.tobytes() == want.tobytes(), env
        assert rep["seedhits"] == jrep["seedhits"]
    assert fm_fused.trie_level.launches == n0     # CPU: plain versions


@pytest.fixture(scope="module")
def finders():
    """psi_tpu's and the port's SeedFinder (CPU) on the same bubble
    graph, one path indexed, and the same reads: substrings of a random
    haplotype with 1% substitutions, a few 'N's, and short reads."""
    graph = make_pangenome_graph(20_000, 0.02, seed=8)
    tgraph = tsim.make_pangenome_graph(20_000, 0.02, seed=8)
    itr = HaplotyperRandomIter(graph, seed=12)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    rng = np.random.RandomState(5)
    n, L = 300, 80
    reads = hs[rng.randint(0, len(hs) - L, n)[:, None] + np.arange(L)]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = np.where(rng.random_sample(reads.shape) < 0.01,
                     bases[rng.randint(0, 4, reads.shape)], reads)
    reads[rng.random_sample(reads.shape) < 0.002] = ord("N")
    seqs = [r.tobytes().decode() for r in reads]
    seqs[3] = seqs[3][:15]
    seqs[4] = "N" * 40
    names = [f"r{i}" for i in range(n)]
    jf = JSeedFinder(graph, 16)
    tf = SeedFinder(tgraph, 16, device="cpu")
    for f in (jf, tf):
        f.create_path_index(1, patched=False)
    return jf, tf, JRecords(names, seqs), Records(names, seqs)


def _rows(arr):
    """Lexsorted (node, offset, read, read offset, length, gocc) rows."""
    if arr is None or not len(arr):
        return np.zeros((0, 6), dtype=np.int64)
    cols = np.stack([arr[f].astype(np.int64) for f in
                     ("node_id", "node_offset", "read_id", "read_offset",
                      "match_len", "gocc")], axis=1)
    return cols[np.lexsort(cols.T[::-1])]


def _seed_rows(seeds):
    cols = np.array([(s.node_id, s.node_offset, s.read_id, s.read_offset,
                      s.match_len, s.gocc) for s in seeds],
                    dtype=np.int64).reshape(-1, 6)
    return cols[np.lexsort(cols.T[::-1])]


def _onpath(finder, reads):
    seeds = finder.get_seeds(reads)
    return _rows(finder.seeds_on_paths_arrays(seeds,
                                              finder.index_reads(seeds)))


@pytest.mark.parametrize("stream,locate,dense", [
    ("0", "0", True), ("0", "1", True), ("0", "1", False), ("1", "0", True),
], ids=["gather-hostlocate", "gather-devlocate", "gather-bitplanes",
        "stream-hostlocate"])
def test_onpath_routes_match_psi_tpu(finders, monkeypatch, stream, locate,
                                     dense):
    """psi_tpu's non-chain on-path routes, picked by its PSI_STREAM and
    PSI_DEVICE_LOCATE (with its rank layout): the port's chain, which
    reads neither variable, gives psi_tpu's hit multiset under each, and
    the chain's without them; it builds no rank layout."""
    jf, tf, jreads, treads = finders
    for name in ("PSI_STREAM", "PSI_DEVICE_LOCATE"):
        monkeypatch.delenv(name, raising=False)
    chain = _onpath(tf, treads)
    assert len(chain) > 500
    monkeypatch.setenv("PSI_STREAM", stream)
    monkeypatch.setenv("PSI_DEVICE_LOCATE", locate)
    for f in (jf, tf):
        f._fm_arrays = None
        if not dense:
            monkeypatch.setattr(type(f), "DENSE_OCC_BUDGET", 0)
    got = _onpath(tf, treads)
    want = _onpath(jf, jreads)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, chain)
    if stream == "0":
        arrays = jf._fm_arrays
        assert (arrays.occ_dense is not None) == dense
        assert (arrays.planes is not None) == (not dense)
    assert tf._fm_arrays is None          # the chain needs no rank layout


@pytest.mark.parametrize("thr,max_mem", [(0, 0), (1, 0), (0, 3)])
def test_mem_api_matches_psi_tpu(finders, thr, max_mem):
    """find_mems_arrays / seeds_on_paths_seqs (the batched automaton) and
    the per-read seeds_on_paths_seq equal psi_tpu's, and each other, as
    hit multisets, unlimited, at a gocc threshold and at a MEM cap."""
    jf, tf, jreads, treads = finders
    for f in (jf, tf):
        f.gocc_threshold, f.max_mem = thr, max_mem
    try:
        got = _rows(tf.find_mems_arrays(treads))
        np.testing.assert_array_equal(got, _rows(jf.find_mems_arrays(jreads)))
        assert len(got) > 100
        hits = []
        tf.seeds_on_paths_seqs(treads, hits.append)
        np.testing.assert_array_equal(_seed_rows(hits), got)
        scalar, jscalar = [], []
        for rid, seq in enumerate(treads.seqs[:60]):
            tf.seeds_on_paths_seq(seq, lambda h, r=rid: scalar.append(
                h._replace(read_id=r)))
            jf.seeds_on_paths_seq(seq, lambda h, r=rid: jscalar.append(
                h._replace(read_id=r)))
        np.testing.assert_array_equal(_seed_rows(scalar),
                                      _seed_rows(jscalar))
        np.testing.assert_array_equal(_seed_rows(scalar),
                                      got[got[:, 2] < 60])
    finally:
        for f in (jf, tf):
            f.gocc_threshold, f.max_mem = 0, 0


def test_all_exact_matches_matches_psi_tpu(finders):
    jf, tf, jreads, treads = finders
    got, want = [], []
    tf.all_exact_matches(treads, got.append)
    jf.all_exact_matches(jreads, want.append)
    assert len(got) > 50
    np.testing.assert_array_equal(_seed_rows(got), _seed_rows(want))


def test_not_ported_yet_raises(dataset, monkeypatch):
    """Nothing raises as unported any more: multi-device pipelines (item
    10) run on a mesh, on the CPU too (tests/test_torch_mesh.py holds
    them to psi_tpu); mismatches, an over-cap WalkTree (the tree route
    gives way to the device traversal) and the distance index run."""
    graph = make_pangenome_graph(3000, 0.02, seed=1)
    mesh = SeedFinder(graph, 12, devices=2, device="cpu")._get_mesh()
    assert mesh.shape == {"data": 2}
    assert SeedFinder(graph, 12, seed_mismatches=1,
                      device="cpu").seed_mismatches == 1
    finder = SeedFinder(graph, 12, device="cpu")
    finder.create_path_index(1, patched=False)
    monkeypatch.setattr(trav, "NODE_CAP", 10)
    assert finder._get_trav_tree() is None
    assert finder._trav_tree[1] is False
    indexed = SeedFinder(graph, 12, device="cpu")
    indexed.create_path_index(1, patched=False, dmin=200, dmax=400)
    assert indexed.d == (200, 400) and len(indexed.dindex.dst) > 0


def test_path_index_round_trip(tmp_path):
    """A path index (-I) saves and loads at insert size 0: the same
    paths, FM index and starting loci come back; loading it with an
    insert size builds the missing distance index and saves it."""
    graph = make_pangenome_graph(3000, 0.02, seed=1)
    finder = SeedFinder(graph, 12, device="cpu")
    finder.create_path_index(2, patched=False)
    prefix = str(tmp_path / "pindex")
    assert finder.serialize_path_index(prefix)
    loaded = SeedFinder(graph, 12, device="cpu")
    assert loaded.load_path_index(prefix)
    assert ([p.get_nodes() for p in loaded.pindex.get_paths_set()]
            == [p.get_nodes() for p in finder.pindex.get_paths_set()])
    np.testing.assert_array_equal(loaded.pindex.fm.sa, finder.pindex.fm.sa)
    assert ([(p.node_id(), p.offset()) for p in loaded.get_starting_loci()]
            == [(p.node_id(), p.offset()) for p in finder.get_starting_loci()])
    assert loaded.load_path_index(prefix, dmin=200)
    assert loaded.d == (200, 200) and loaded.dindex.dmax == 200
    assert (tmp_path / "pindex_dist_mat_m200M200.npz").exists()


def test_cli_device_cuda_without_gpu_raises(dataset, monkeypatch):
    tmp, gpath, fq = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([gpath, "-f", fq, "-l", "20", "--device", "cuda",
                  "-o", str(tmp / "none.bin"), "-q", "-Q"])


K_OFF = 12


@pytest.fixture(scope="module")
def trav_finders():
    """psi_tpu's and the port's SeedFinder (CPU) on a bubble graph with
    an 'N' in one label, one path indexed (so many uncovered loci), and
    reads of a random haplotype with 1% substitutions."""
    graph = make_pangenome_graph(6000, 0.03, indel_frac=0.3, seed=21)
    tgraph = tsim.make_pangenome_graph(6000, 0.03, indel_frac=0.3, seed=21)
    rng = np.random.RandomState(2)
    at = rng.randint(0, len(graph.labels))
    for g in (graph, tgraph):
        g.labels = g.labels.copy()
        g.labels[at] = ord("N")
    itr = HaplotyperRandomIter(graph, seed=5)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    n, L = 60, 48
    reads = hs[rng.randint(0, len(hs) - L, n)[:, None] + np.arange(L)]
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = np.where(rng.random_sample(reads.shape) < 0.01,
                     bases[rng.randint(0, 4, reads.shape)], reads)
    seqs = [r.tobytes().decode() for r in reads]
    names = [f"r{i}" for i in range(n)]
    jf = JSeedFinder(graph, K_OFF, stats=JStats())
    tf = SeedFinder(tgraph, K_OFF, stats=SeedFinderStats(), device="cpu")
    for f in (jf, tf):
        f.create_path_index(1, patched=False)
    assert len(tf.starting_loci) == len(jf.starting_loci) > 1000
    return jf, tf, JRecords(names, seqs), Records(names, seqs)


def _traversal_stats(finder):
    ts = finder.stats.get_this_thread_stats()
    return ts.godowns, ts.paths_traversed, ts.paths_len_sum


def _all_rows(finder, reads):
    """Lexsorted on- and off-path rows of seeds_all_arrays, and the
    TraverserStats it added."""
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)
    before = _traversal_stats(finder)
    on, off = finder.seeds_all_arrays(seeds, index, split=True)
    after = _traversal_stats(finder)
    return _rows(on), _rows(off), tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("route,env,mm", [
    ("tree", {}, 0),
    ("device", {"PSI_TRAV_CACHE": "0"}, 0),
    ("over-cap", {"PSI_TRAV_CACHE_CAP": "50"}, 0),
    ("mismatch1", {}, 1),
    ("mismatch2", {}, 2),
])
def test_seeds_all_arrays_matches_psi_tpu(trav_finders, monkeypatch, route,
                                          env, mm):
    """seeds_all_arrays on every off-path route (the WalkTree, the device
    traversal by PSI_TRAV_CACHE=0 and past a tiny PSI_TRAV_CACHE_CAP, the
    mismatch-tolerant traversal) gives psi_tpu's lexsorted on- and
    off-path hits, with the exact routes' TraverserStats equal to psi_tpu's
    and to each other's; a mismatch route adds no TraverserStats."""
    jf, tf, jreads, treads = trav_finders
    for name in ("PSI_TRAV_CACHE", "PSI_TRAV_CACHE_CAP"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for f in (jf, tf):
        f._trav_tree = None
        monkeypatch.setattr(f, "seed_mismatches", mm)
    n0 = trav.traverse_step.launches, trav.range_refine4.launches
    got = _all_rows(tf, treads)
    want = _all_rows(jf, jreads)
    assert (trav.traverse_step.launches, trav.range_refine4.launches) == n0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) > 0 and len(got[1]) > 0
    assert got[2] == want[2]
    assert (got[2] == (0, 0, 0)) == bool(mm)
    assert (tf._trav_tree is not None
            and tf._trav_tree[1] is not False) == (route == "tree")
    if mm:
        exact = SeedFinder(tf.graph, K_OFF, device="cpu")
        exact.pindex, exact._path_map = tf.pindex, tf._path_map
        exact.starting_loci = tf.starting_loci
        on, off, _ = _all_rows(exact, treads)
        assert len(got[0]) > len(on) and len(got[1]) > len(off)


@pytest.mark.parametrize("stream,locate", [
    ("1", "1"), ("1", "0"), ("0", "1"), ("0", "0"),
], ids=["chain", "stream-hostlocate", "gather-devlocate", "gather-hostlocate"])
def test_onpath_mismatch_routes_match_psi_tpu(trav_finders, monkeypatch,
                                              stream, locate):
    """With one mismatch the port's chain joins the Hamming-ball hits back
    to their seeds through `origin`: psi_tpu's hits on each of its routes
    (the chain, the trie search with a host locate, the gather route with
    a device or host locate), and the chain's without the variables."""
    jf, tf, jreads, treads = trav_finders
    for f in (jf, tf):
        monkeypatch.setattr(f, "seed_mismatches", 1)
    for name in ("PSI_STREAM", "PSI_DEVICE_LOCATE"):
        monkeypatch.delenv(name, raising=False)
    chain = _onpath(tf, treads)
    monkeypatch.setenv("PSI_STREAM", stream)
    monkeypatch.setenv("PSI_DEVICE_LOCATE", locate)
    got = _onpath(tf, treads)
    np.testing.assert_array_equal(got, _onpath(jf, jreads))
    np.testing.assert_array_equal(got, chain)
    assert len(got) > len(_exact_onpath(tf, treads))


@pytest.mark.parametrize("mm", [0, 1])
def test_planned_chunk_builds_its_keys_once(trav_finders, monkeypatch, mm):
    """prepare_onpath builds the chunk's plan, and the query reads it: the
    key pipeline (at m = 1 the Hamming ball) runs once a chunk, and the
    hits are those of a chunk that the query plans itself."""
    _, tf, _, treads = trav_finders
    monkeypatch.setattr(tf, "seed_mismatches", mm)
    calls = []
    real = SeedFinder._onpath_search_keys
    monkeypatch.setattr(SeedFinder, "_onpath_search_keys",
                        lambda self, index: calls.append(index.size)
                        or real(self, index))
    seeds = tf.get_seeds(treads)
    index = tf.index_reads(seeds)
    tf.prepare_onpath(index)
    assert len(calls) == 1
    plan = index._onpath_prep
    assert len(plan.inv) == len(plan.origin) and len(plan.uniq) <= len(
        plan.inv)
    on, off = tf.seeds_all_arrays(seeds, index, split=True)
    assert len(calls) == 1 and len(on) > 0
    unplanned = tf.index_reads(seeds)
    on2, off2 = tf.seeds_all_arrays(seeds, unplanned, split=True)
    assert len(calls) == 2
    np.testing.assert_array_equal(_rows(on), _rows(on2))
    np.testing.assert_array_equal(_rows(off), _rows(off2))


@pytest.mark.parametrize("mm", [0, 1], ids=["exact", "mismatch1"])
def test_unplanned_chunk_matches_psi_tpu(trav_finders, monkeypatch, mm):
    """A chunk queried without prepare_onpath (a library caller) is
    planned by the query, which keeps no plan on the index, and gives
    psi_tpu's on-path hits."""
    jf, tf, jreads, treads = trav_finders
    for f in (jf, tf):
        monkeypatch.setattr(f, "seed_mismatches", mm)
    seeds = tf.get_seeds(treads)
    index = tf.index_reads(seeds)
    got = _rows(tf.seeds_on_paths_arrays(seeds, index))
    assert getattr(index, "_onpath_prep", None) is None
    assert len(got) > 0
    np.testing.assert_array_equal(got, _onpath(jf, jreads))


@pytest.mark.parametrize("mm,thr", [(0, 0), (1, 0), (0, 2)])
def test_numpy_join_matches_native_join(trav_finders, monkeypatch, mm, thr):
    """Without the host library the join builds, in NumPy, the rows that
    native psi_emit_join builds, in the same order."""
    from psi_tpu_torch import native

    _, tf, _, treads = trav_finders
    monkeypatch.setattr(tf, "seed_mismatches", mm)
    monkeypatch.setattr(tf, "gocc_threshold", thr)
    assert native.available(), native.load_error
    seeds = tf.get_seeds(treads)
    index = tf.index_reads(seeds)
    tf.prepare_onpath(index)
    want = tf.seeds_on_paths_arrays(seeds, index)
    monkeypatch.setattr(native, "available", lambda: False)
    got = tf.seeds_on_paths_arrays(seeds, index)
    assert len(want) > 0 and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def _exact_onpath(finder, reads):
    exact = SeedFinder(finder.graph, finder.seed_len, device="cpu")
    exact.pindex, exact._path_map = finder.pindex, finder._path_map
    return _onpath(exact, reads)


@pytest.mark.parametrize("mm", [0, 1])
def test_seeds_off_paths_host_matches_psi_tpu(trav_finders, monkeypatch, mm):
    """seeds_off_paths(device=False), the host BFS mirror, gives
    psi_tpu's hits, and the device route's (the WalkTree, or with a
    mismatch the device traversal)."""
    jf, tf, jreads, treads = trav_finders
    for f in (jf, tf):
        monkeypatch.setattr(f, "seed_mismatches", mm)
    out = {}
    for name, f, reads in (("torch", tf, treads), ("jax", jf, jreads)):
        seeds = f.get_seeds(reads)
        index = f.index_reads(seeds)
        for device in (False, True):
            hits = []
            f.seeds_off_paths(seeds, index, hits.append, device=device)
            out[name, device] = _seed_rows(hits)
    assert len(out["torch", False]) > 0
    np.testing.assert_array_equal(out["torch", False], out["jax", False])
    np.testing.assert_array_equal(out["torch", True], out["torch", False])
    np.testing.assert_array_equal(out["jax", True], out["jax", False])


def test_cli_mismatches_matches_psi_tpu(dataset):
    """psikt --mismatches 1 on the CPU against psi_tpu's CLI: equal
    lexsorted hit streams, with more hits than exact matching, on and off
    the paths."""
    tmp, gpath, fq = dataset
    got, rep = _run(cli.main, tmp, gpath, fq, "torch_mm1", 0,
                    ("--device", "cpu", "--mismatches", "1"))
    want, jrep = _run(jcli.main, tmp, gpath, fq, "jax_mm1", 0,
                      ("--device", "cpu", "--mismatches", "1"))
    exact, _ = _run(cli.main, tmp, gpath, fq, "torch_mm0", 0,
                    ("--device", "cpu"))
    assert got.tobytes() == want.tobytes()
    assert rep["seedhits"] == jrep["seedhits"] == len(got) > len(exact)
    assert sum(c["hits_off"] for c in rep["chunks"]) > 0
