"""psi_tpu_torch.parallel.mesh and the mesh routes of SeedFinder and the
CLI against psi_tpu's, on the CPU: psi_tpu on the conftest mesh of 8
virtual devices, the port on as many virtual shards of the CPU, at the
sizes of psi_tpu's tests/test_mesh_pipeline.py. Every comparison is of
exact integers: the sharded trie plans (plain wire), the sharded trie
search (hi - lo, and lo where hi > lo: R3), the sharded traversal's
state and control arrays (a forced overflow too), and the lexsorted hit
streams of psi_tpu's mesh finder, the port's mesh finder and the port's
single-device finder (R4)."""

import numpy as np
import pytest
import torch

import jax

from psi_tpu.fmindex import FMIndex as JFMIndex
from psi_tpu.graph import Graph as JGraph
from psi_tpu.ops import fm as jfm_ops
from psi_tpu.ops import fm_stream as jfm_stream
from psi_tpu.ops import traverse as jtrav
from psi_tpu.parallel import mesh as jmesh
from psi_tpu.records import Records as JRecords
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu_torch import graft
from psi_tpu_torch.fmindex import FMIndex
from psi_tpu_torch.graph import Graph
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_fused, fm_stream
from psi_tpu_torch.ops import traverse as trav
from psi_tpu_torch.parallel import mesh
from psi_tpu_torch.records import Records, SeedsIndex, seeding
from psi_tpu_torch.seed_finder import SeedFinder

SORT_ORDER = ["node_id", "node_offset", "read_id", "read_offset",
              "match_len", "gocc"]


@pytest.fixture(autouse=True)
def _need_devices():
    if jax.device_count() < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tensors, which are small:
    the suite runs several workers on the machine's cores, and idle
    intra-op threads spinning in every worker slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _branchy_parts(rng, n=2500):
    seq = "".join(rng.choice(list("ACGT"), size=n))
    parts = dict(
        nodes={1: seq[: n // 2], 2: seq[n // 2:],
               3: "ACGTAGGTACGTTCGTACGATTACCGGA"},
        edges=[(1, 2), (1, 3), (3, 2)],
        paths=[("ref", [1, 2])],
    )
    return parts, seq


def _reads(seq):
    return ([f"r{i}" for i in range(48)],
            [seq[i * 43: i * 43 + 60] for i in range(48)])


def _hits(finder, reads):
    finder.create_path_index(n=1, patched=False)
    finder.add_uncovered_loci()
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)
    finder.prepare_onpath(index)
    return np.sort(finder.seeds_all_arrays(seeds, index), order=SORT_ORDER)


def _keys_index(seed, n_keys, size=60_000, k=12):
    """A random text and distinct packed keys: random ones and, half of
    them, k-mers of the text."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 4, size=size)
    s = "".join(np.array(list("ACGT"))[codes])
    starts = rng.randint(0, size - k, n_keys // 2 + 1)
    text = (codes[starts[:, None] + np.arange(k)]
            * 4 ** np.arange(k - 1, -1, -1)).sum(axis=1)
    keys = np.unique(np.concatenate([
        rng.randint(0, 4 ** k, size=n_keys - len(starts)), text,
    ]).astype(np.uint64))
    return s, keys, k


# --- the sharded trie ---------------------------------------------------

@pytest.mark.parametrize("D,ftab_bits", [(2, 0), (8, 5), (8, 0)])
def test_prepare_trie_sharded_matches_psi_tpu(D, ftab_bits):
    """sizes, per, leaf_perms, and with psi_tpu's plain wire the parent
    and char schedules and the seeded frontier, shard for shard."""
    s, keys, k = _keys_index(27, 4000)
    jfm = JFMIndex.build_from_strings([s[::-1]])
    ftab = jfm_ops.build_ftab(jfm, ftab_bits) if ftab_bits else None
    want = jmesh.prepare_trie_sharded(
        jmesh.device_mesh(D), keys, k, jfm.size, ftab, wire="plain")
    got = mesh.prepare_trie_sharded(
        mesh.device_mesh(D, platform="cpu"), keys, k, jfm.size, ftab)
    assert (got.sizes, got.per, got.n) == (want.sizes, want.per, want.n)
    for a, b in zip(got.leaf_perms, want.leaf_perms, strict=True):
        np.testing.assert_array_equal(a, b)
    for field in ("parents", "chars", "lo0", "hi0"):
        np.testing.assert_array_equal(
            np.stack([t.numpy() for t in getattr(got, field)]),
            np.asarray(getattr(want, field)), err_msg=field)


@pytest.mark.parametrize("D,n_keys,ftab_bits", [(2, 4000, 5), (8, 4000, 0),
                                                 (8, 5, 0)])
def test_sharded_trie_search_matches_psi_tpu(D, n_keys, ftab_bits):
    """psi_tpu's sharded trie search and the port's single-device one,
    with empty shards (5 keys over 8) running the dummy plan."""
    s, keys, k = _keys_index(23, n_keys)
    fm = FMIndex.build_from_strings([s[::-1]])
    jfm = JFMIndex.build_from_strings([s[::-1]])
    ftab = fm_ops.build_ftab(fm, ftab_bits) if ftab_bits else None
    lo, hi = mesh.sharded_trie_search(
        mesh.device_mesh(D, platform="cpu"),
        fm_stream.build_stream_arrays(fm, "cpu"), keys, k, ftab=ftab)
    jlo, jhi = jmesh.sharded_trie_search(
        jmesh.device_mesh(D), jfm_stream.build_stream_arrays(jfm), keys, k,
        ftab=ftab)
    np.testing.assert_array_equal(hi - lo, jhi - jlo)
    nz = hi > lo
    assert nz.any()
    np.testing.assert_array_equal(lo[nz], jlo[nz])


# --- the sharded traversal -------------------------------------------------

def _traversal_inputs(seed=4, n_reads=40, k=12):
    rng = np.random.RandomState(seed)
    parts, seq = _branchy_parts(rng, 1200)
    jg = JGraph.from_parts(**parts)
    branch = (jg.node_sequence(1)[-6:] + jg.node_sequence(3)
              + jg.node_sequence(2)[:10])
    starts = rng.randint(0, len(seq) - k, n_reads)
    reads = Records([f"r{i}" for i in range(n_reads + 1)],
                    [seq[p: p + k + 8] for p in starts] + [branch])
    index = SeedsIndex(seeding(reads, k, 4))
    sn = np.array([n for n in (1, 2, 3) for _ in range(
        jg.node_length(n))], dtype=np.int32)
    so = np.concatenate([np.arange(jg.node_length(n), dtype=np.int32)
                         for n in (1, 2, 3)])
    return jg, index, sn, so, k


@pytest.mark.parametrize("D,tight,mm", [(2, False, 0), (8, False, 1),
                                        (8, True, 0), (2, True, 1)])
def test_sharded_traverse_matches_psi_tpu(D, tight, mm):
    """li, lo, hi, n_used, overflow and TraverserStats of every shard,
    exact and with one mismatch; a cap of exactly the loci per shard
    overflows where walks fork (R6 sizes)."""
    jg, index, sn, so, k = _traversal_inputs()
    cap = -(-len(sn) // D) if tight else 4096
    got = mesh.sharded_traverse(
        mesh.device_mesh(D, platform="cpu"),
        trav.graph_to_device(jg, "cpu"), trav.seeds_to_device(index, "cpu"),
        sn, so, k, cap, mm)
    want = jmesh.sharded_traverse(
        jmesh.device_mesh(D), jtrav.graph_to_device(jg),
        jtrav.seeds_to_device(index), sn, so, k, cap, mm)
    li, lo, hi, nu, ov, ts, local = got
    jli, jlo, jhi, jnu, jov, jts, jlocal = want
    np.testing.assert_array_equal(nu, jnu)
    np.testing.assert_array_equal(ov, jov)
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_array_equal(local, jlocal)
    assert nu.sum() > 0 and ov.any() == tight
    for d in range(D):
        if not ov[d]:
            m = nu[d]
            for a, b in ((li, jli), (lo, jlo), (hi, jhi)):
                np.testing.assert_array_equal(a[d, :m], b[d, :m])


# --- the batched search, the train step and the dry run -------------------

def test_sharded_backward_search_and_train_step():
    """The data-parallel backward search (one lf_pair launch a step per
    shard, dense layout) over a batch that does not divide by 8, against
    psi_tpu's and the single-device search; the train step's counts and
    psum'd statistics."""
    rng = np.random.RandomState(0)
    strings = ["".join(rng.choice(list("ACGT"), size=500)) for _ in range(3)]
    fm = FMIndex.build_from_strings([s[::-1] for s in strings])
    jfm = JFMIndex.build_from_strings([s[::-1] for s in strings])
    arrays = fm_ops.to_device(fm, "cpu", dense_occ=True)
    m8 = mesh.device_mesh(8, platform="cpu")
    codes = rng.randint(1, 5, size=(100, 12)).astype(np.int32)
    lo, hi = mesh.sharded_backward_search(m8, arrays, codes)
    jlo, jhi = jmesh.sharded_backward_search(
        jmesh.device_mesh(8), jfm_ops.to_device(jfm), codes)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    step = mesh.make_train_step(m8)
    counts, total, nonzero = step(mesh.replicate(m8, arrays),
                                  mesh.shard_batch(m8, codes))
    want = jhi.astype(np.int64) - jlo
    assert (total, nonzero) == (int(want.sum()), int((want > 0).sum()))
    got = torch.cat([c for c in counts.shards]).numpy()[: len(codes)]
    np.testing.assert_array_equal(got, want)


def test_graft_entry_and_dryrun():
    """graft.entry's batched search and dryrun_multichip(8) on virtual CPU
    shards: every check of psi_tpu's __graft_entry__.dryrun_multichip."""
    fn, args = graft.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (1024,)
    graft.dryrun_multichip(8, devices=("cpu",) * 8)


# --- SeedFinder on the mesh -------------------------------------------------

@pytest.mark.parametrize("devices,mm,thr,seed", [
    (2, 0, 0, 3), (8, 0, 0, 3), (2, 1, 0, 6), (8, 0, 2, 9), (2, 0, 2, 9),
])
def test_seedfinder_mesh_matches_psi_tpu(monkeypatch, devices, mm, thr,
                                         seed):
    """The chain on the mesh (counts-only download, per-shard expand +
    locate) and the loci-sharded traversal: the port's mesh finder, the
    port's single-device finder and psi_tpu's mesh finder on its chained
    route give the same lexsorted stream, exact, with one mismatch and
    under two gocc thresholds."""
    monkeypatch.setenv("PSI_STREAM", "1")
    monkeypatch.setenv("PSI_DEVICE_LOCATE", "1")
    monkeypatch.setenv("PSI_TRIE_WIRE", "plain")
    rng = np.random.RandomState(seed)
    parts, seq = _branchy_parts(rng)
    names, seqs = _reads(seq)

    def port(n):
        f = SeedFinder(Graph.from_parts(**parts), 12, devices=n,
                       seed_mismatches=mm, gocc_threshold=thr, device="cpu")
        return _hits(f, Records(names, seqs)), f

    multi, f = port(devices)
    assert f._get_mesh().shape == {"data": devices}
    single, f1 = port(1)
    assert f1._get_mesh() is None
    want = _hits(JSeedFinder(JGraph.from_parts(**parts), 12, devices=devices,
                             seed_mismatches=mm, gocc_threshold=thr),
                 JRecords(names, seqs))
    assert len(single) > 0
    np.testing.assert_array_equal(multi, single)
    np.testing.assert_array_equal(multi, want)


@pytest.mark.parametrize("locate", ["0", "1"])
def test_seedfinder_mesh_offpath_loci(monkeypatch, locate):
    """Off-path hits through the branch node, so the loci-sharded
    traversal carries them; the port's one on-path route, the sharded
    chain, under psi_tpu's chained route (PSI_DEVICE_LOCATE=1) and its
    sharded trie search with a host locate (0), which the variables pick
    for psi_tpu only."""
    monkeypatch.setenv("PSI_STREAM", "1")
    monkeypatch.setenv("PSI_DEVICE_LOCATE", locate)
    rng = np.random.RandomState(4)
    parts, _ = _branchy_parts(rng)
    jg = JGraph.from_parts(**parts)
    branch = (jg.node_sequence(1)[-6:] + jg.node_sequence(3)
              + jg.node_sequence(2)[:10])
    names, seqs = ["b0", "b1"], [branch, branch[3:]]

    def off(finder, records):
        finder.create_path_index(n=1, patched=False)
        finder.add_uncovered_loci()
        seeds = finder.get_seeds(records)
        index = finder.index_reads(seeds)
        on, off_hits = finder.seeds_all_arrays(seeds, index, split=True)
        return (np.sort(on, order=SORT_ORDER),
                np.sort(off_hits, order=SORT_ORDER))

    got = off(SeedFinder(Graph.from_parts(**parts), 12, devices=8,
                         device="cpu"), Records(names, seqs))
    single = off(SeedFinder(Graph.from_parts(**parts), 12, device="cpu"),
                 Records(names, seqs))
    jf = JSeedFinder(jg, 12, devices=8)
    jf.create_path_index(n=1, patched=False)
    jf.add_uncovered_loci()
    jseeds = jf.get_seeds(JRecords(names, seqs))
    want = np.sort(jf.seeds_off_paths_arrays(jseeds, jf.index_reads(jseeds)),
                   order=SORT_ORDER)
    assert len(want) > 0
    np.testing.assert_array_equal(got[1], want)
    for a, b in zip(got, single, strict=True):
        np.testing.assert_array_equal(a, b)


def test_devices_selection(monkeypatch):
    """PSI_DEVICES and the devices argument as psi_tpu reads them (auto:
    every device of the finder's type, capped; default one on the CPU),
    and a sequence of devices: of the finder's type only."""
    rng = np.random.RandomState(7)
    parts, _ = _branchy_parts(rng, n=1200)
    g = Graph.from_parts(**parts)
    monkeypatch.setenv("PSI_DEVICES", "auto")
    assert SeedFinder(g, 12, device="cpu")._get_mesh().shape == {
        "data": mesh.CPU_DEVICES}
    monkeypatch.setenv("PSI_DEVICES", "1")
    assert SeedFinder(g, 12, device="cpu")._get_mesh() is None
    monkeypatch.delenv("PSI_DEVICES")
    assert SeedFinder(g, 12, device="cpu")._get_mesh() is None
    assert SeedFinder(g, 12, devices=64, device="cpu")._get_mesh().shape == {
        "data": mesh.CPU_DEVICES}
    assert SeedFinder(g, 12, devices="auto",
                      device="cpu")._get_mesh().shape == {"data": 8}
    seq = SeedFinder(g, 12, devices=("cpu", "cpu"), device="cpu")._get_mesh()
    assert [str(d) for d in seq.devices] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="finder's type"):
        SeedFinder(g, 12, devices=("cpu", "meta"), device="cpu")._get_mesh()
    assert SeedFinder(g, 12, devices=("cpu",), device="cpu")._get_mesh() is None


def test_mesh_shapes_and_replicate():
    """device_mesh on the CPU, a 2-D mesh, and one copy per distinct
    device (a mesh naming a device twice shares it)."""
    m = mesh.device_mesh(4, platform="cpu")
    assert m.shape == {"data": 4} and m.local_positions() == [0, 1, 2, 3]
    m2 = mesh.device_mesh(8, axes=("data", "shard"), platform="cpu",
                          shape=(2, 4))
    assert m2.shape == {"data": 2, "shard": 4}
    assert (m2.coord(6, "data"), m2.coord(6, "shard")) == (1, 2)
    t = torch.arange(5, dtype=torch.int32)
    r = mesh.replicate(m, (t, np.arange(3), 7))
    assert all(x[0] is t and x[2] == 7 for x in r)
    with pytest.raises(ValueError, match="shape"):
        mesh.device_mesh(8, axes=("data", "shard"), platform="cpu")


def test_cli_devices_matches_psi_tpu(tmp_path, monkeypatch):
    """psikt --device cpu --devices 2 against psi_tpu's --devices 2 and
    the port's --devices 1: the same lexsorted binary hit stream."""
    from psi_tpu import cli as jcli
    from psi_tpu.graphiter import HaplotyperRandomIter
    from psi_tpu.pathutil import Path, sequence
    from psi_tpu.simulate import make_pangenome_graph
    from psi_tpu_torch import cli

    monkeypatch.setenv("PSI_STREAM", "1")
    graph = make_pangenome_graph(6000, 0.03, seed=5)
    gpath = str(tmp_path / "g.npz")
    graph.save(gpath)
    itr = HaplotyperRandomIter(graph, seed=6)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = sequence(hap)
    rng = np.random.RandomState(2)
    fq = tmp_path / "r.fastq"
    with open(fq, "w") as fh:
        for i, p in enumerate(rng.randint(0, len(hs) - 60, 80)):
            fh.write(f"@r{i}\n{hs[p:p + 60]}\n+\n{'I' * 60}\n")

    def run(main, tag, *extra):
        out = tmp_path / f"{tag}.bin"
        assert main([gpath, "-f", str(fq), "-l", "12", "-n", "1", "-o",
                     str(out), "-q", "-Q", *extra]) == 0
        h = np.fromfile(out, dtype="<i8").reshape(-1, 4)
        return h[np.lexsort(h.T[::-1])]

    n0 = fm_fused.trie_level.launches
    got = run(cli.main, "mesh", "--device", "cpu", "--devices", "2")
    one = run(cli.main, "one", "--device", "cpu", "--devices", "1")
    want = run(jcli.main, "jax", "--device", "cpu", "--devices", "2")
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(one, want)
    assert fm_fused.trie_level.launches == n0
