"""psi_tpu's chromosome-scale configuration (scripts/chr_scale_run.py) at a
CPU size, held exactly to psi_tpu: a 4-component pan-genome at variant
rate 0.01 with 20% insertions, k = 30, 6 patched paths a region with a
context of 30, loci every 10 bp and the distance index over (300, 500).
The path texts, the index size, the loci, the distance-index CSR (native
and device build), the on-path and off-path hit multisets on the WalkTree
route and under PSI_TRAV_CACHE=0, a path index that psi_tpu saved and
the port loads, and tools/chr_scale's constants and stages. Every output
is integer and compared with no tolerance."""

import ast
import json
import pathlib

import numpy as np
import pytest

from psi_tpu import cli as jcli
from psi_tpu.records import Records as JRecords
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu.simulate import make_pangenome_graph
from psi_tpu_torch import cli
from psi_tpu_torch.dindex import DistanceIndex
from psi_tpu_torch.records import Records
from psi_tpu_torch.tools import chr_scale

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the reference length of the CPU-size configuration (4 components of
#: 30 kbp; the chip runs 100 Mbp)
REF_LEN = 120_000
N_DRAWN = 2_000


def _index(finder) -> None:
    finder.create_path_index(n=6, patched=True, context=30, step_size=10,
                             dmin=300, dmax=500)


def _loci(finder) -> np.ndarray:
    return np.array([(p.node_id(), p.offset())
                     for p in finder.get_starting_loci()], dtype=np.int64)


def _locus_reads(graph, loci, rng) -> list:
    """One READ_LEN bp read from each locus, along a random walk: its
    first seed starts at the locus, so the off-path traversal finds it."""
    text = graph.labels.tobytes().decode("ascii")
    loff, indptr, succ = graph.label_offsets, graph.out_indptr, graph.out_indices
    reads = []
    for node, off in loci:
        seq = text[loff[node - 1] + off:loff[node]]
        while len(seq) < chr_scale.READ_LEN and indptr[node] > indptr[node - 1]:
            node = int(succ[rng.randint(indptr[node - 1], indptr[node])])
            seq += text[loff[node - 1]:loff[node]]
        if len(seq) >= chr_scale.SEED_LEN:
            reads.append(seq[:chr_scale.READ_LEN])
    return reads


def _lexsorted(arr) -> np.ndarray:
    cols = np.stack([np.asarray(arr[c], dtype=np.int64) for c in (
        "node_id", "node_offset", "read_id", "read_offset")], axis=1)
    return cols[np.lexsort(cols.T[::-1])]


@pytest.fixture(scope="module")
def finders():
    """psi_tpu's and the port's finders (CPU) over the configuration's
    graph with the index built, and the reads: chr_scale's draw from the
    label text, then one read from each uncovered locus."""
    graph = make_pangenome_graph(REF_LEN, 0.01, indel_frac=0.2, seed=7,
                                 n_components=4)
    tgraph = chr_scale.make_graph(REF_LEN / 1e6)
    jf = JSeedFinder(graph, seed_len=chr_scale.SEED_LEN)
    tf = chr_scale.make_finder(tgraph, "cpu")
    _index(jf)
    chr_scale.build_index(tf)
    seqs = chr_scale.draw_reads(chr_scale.label_text(tgraph), N_DRAWN,
                                np.random.RandomState(chr_scale.READS_SEED))
    seqs += _locus_reads(tgraph, _loci(tf), np.random.RandomState(3))
    names = [f"r{i}" for i in range(len(seqs))]
    return graph, tgraph, jf, tf, names, seqs


def test_constants_match_psi_tpu_script():
    """tools/chr_scale keeps scripts/chr_scale_run.py's configuration:
    the generator's and the index's arguments, k, the read length, the
    draw's seed and the default size and chunk."""
    tree = ast.parse((REPO / "scripts" / "chr_scale_run.py").read_text())
    calls, assigns = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            calls[ast.unparse(node.func).split(".")[-1]] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            assigns[ast.unparse(node.targets[0])] = node.value

    def value(node):
        if isinstance(node, ast.Name):       # a constant of the script
            return value(assigns[node.id])
        if isinstance(node, ast.IfExp):      # `argv[i] if ... else default`
            return value(node.orelse)
        return ast.literal_eval(node)

    def kw(call):
        return {k.arg: value(k.value) for k in calls[call].keywords}

    assert kw("make_pangenome_graph") == {
        "variant_rate": chr_scale.VARIANT_RATE,
        "indel_frac": chr_scale.INDEL_FRAC, "seed": chr_scale.GRAPH_SEED,
        "n_components": chr_scale.N_COMPONENTS}
    assert kw("create_path_index") == {
        "n": chr_scale.N_PATHS, "patched": chr_scale.PATCHED,
        "context": chr_scale.CONTEXT, "step_size": chr_scale.STEP_SIZE,
        "dmin": chr_scale.DMIN, "dmax": chr_scale.DMAX}
    assert value(assigns["k"]) == chr_scale.SEED_LEN
    assert value(assigns["read_len"]) == chr_scale.READ_LEN
    assert [value(a) for a in calls["RandomState"].args] == [
        chr_scale.READS_SEED]
    assert value(assigns["ref_mbp"]) == chr_scale.REF_MBP
    assert value(assigns["n_reads"]) == chr_scale.CHUNK


def test_index_matches_psi_tpu(finders):
    """The same paths (texts in order), index size and loci array; more
    than one component and uncovered loci in each."""
    graph, tgraph, jf, tf, _, _ = finders
    assert tgraph.get_path_count() == 4 and tgraph.node_count == graph.node_count
    assert (tf.pindex.get_paths_set().sequences()
            == jf.pindex.get_paths_set().sequences())
    assert tf.pindex.fm.size == jf.pindex.fm.size > 0
    loci = _loci(tf)
    assert np.array_equal(loci, _loci(jf)) and len(loci) > 0
    # every component has loci (the ids of component c follow those of c-1)
    firsts = [nodes[0] for _, nodes in tgraph.paths]
    assert len(np.unique(np.searchsorted(firsts, loci[:, 0], "right"))) == 4


@pytest.mark.parametrize("build", ["native", "device"])
def test_dindex_matches_psi_tpu(finders, monkeypatch, build):
    """The (300, 500) distance index: the port's CSR, built by the native
    DP (inside create_path_index) or by path doubling on the device
    (PSI_DINDEX_BUILD=device, over the whole 4-component DAG at once),
    equals psi_tpu's native CSR, which is psi_tpu's per-component device
    build's too."""
    graph, tgraph, jf, tf, _, _ = finders
    if build == "native":
        got = tf.dindex
    else:
        monkeypatch.setenv("PSI_DINDEX_BUILD", "device")
        got = DistanceIndex.build(tgraph, chr_scale.DMIN, chr_scale.DMAX,
                                  True, device="cpu")
    want = jf.dindex
    assert got.mode == want.mode == "super" and len(want.dst) > 0
    for name in ("src_indptr", "dst", "iv_lo", "iv_hi", "sup", "head",
                 "tail"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("route", ["walktree", "traverse_device"])
def test_hits_match_psi_tpu(finders, monkeypatch, route):
    """Lexsorted on-path and off-path hit multisets, on the WalkTree route
    and under PSI_TRAV_CACHE=0 (the device traversal), with hits on both."""
    _, _, jf, tf, names, seqs = finders
    if route == "traverse_device":
        monkeypatch.setenv("PSI_TRAV_CACHE", "0")
    js = jf.get_seeds(JRecords(names, seqs))
    ji = jf.index_reads(js)
    ts = tf.get_seeds(Records(names, seqs))
    ti = tf.index_reads(ts)
    taken = tf._traverse_dispatch(ti)[0]
    assert taken == {"walktree": "tree", "traverse_device": "single"}[route]
    on, off = tf.seeds_all_arrays(ts, ti, split=True)
    assert len(on) > 0 and len(off) > 0
    assert (_lexsorted(on).tobytes()
            == _lexsorted(jf.seeds_on_paths_arrays(js, ji)).tobytes())
    assert (_lexsorted(off).tobytes()
            == _lexsorted(jf.seeds_off_paths_arrays(js, ji)).tobytes())


def test_psi_tpu_saved_index_loads_in_port(finders, tmp_path):
    """A path index (paths, FM index, loci, distance index) that psi_tpu
    saved loads in the port with nothing rebuilt and gives psi_tpu's
    hits."""
    graph, tgraph, jf, tf, names, seqs = finders
    prefix = str(tmp_path / "pidx")
    assert jf.serialize_path_index(prefix, chr_scale.STEP_SIZE)
    lf = chr_scale.make_finder(tgraph, "cpu")

    def rebuilt(*args, **kwargs):
        raise AssertionError("an artifact psi_tpu saved was rebuilt")

    lf.add_uncovered_loci = lf.create_distance_index = rebuilt
    assert lf.load_path_index(prefix, chr_scale.CONTEXT, chr_scale.STEP_SIZE,
                              chr_scale.DMIN, chr_scale.DMAX)
    assert lf.pindex.fm.size == jf.pindex.fm.size
    assert np.array_equal(_loci(lf), _loci(jf))
    assert np.array_equal(lf.dindex.dst, jf.dindex.dst)
    ts = lf.get_seeds(Records(names, seqs))
    ti = lf.index_reads(ts)
    got = _lexsorted(lf.seeds_all_arrays(ts, ti))
    js = jf.get_seeds(JRecords(names, seqs))
    ji = jf.index_reads(js)
    want = _lexsorted(np.concatenate([jf.seeds_on_paths_arrays(js, ji),
                                      jf.seeds_off_paths_arrays(js, ji)]))
    assert got.tobytes() == want.tobytes()


def test_chr_scale_run_matches_psi_tpu(finders):
    """tools/chr_scale.run on the built finder: every stage timed, and the
    hits of each stage are psi_tpu's on the same draw."""
    graph, tgraph, jf, tf, _, _ = finders
    res = chr_scale.run(n_reads=N_DRAWN, graph=tgraph, finder=tf,
                        log=lambda msg: None)
    assert list(res["stages"]) == ["seeding", "on_path_cold", "on_path_warm",
                                   "off_path_cold", "off_path_warm"]
    assert res["chars"] == jf.pindex.fm.size
    assert res["loci"] == len(jf.get_starting_loci())
    rng = np.random.RandomState(chr_scale.READS_SEED)
    text = chr_scale.label_text(tgraph)
    chunks = [chr_scale.draw_reads(text, N_DRAWN, rng) for _ in range(2)]
    names = [f"r{i}" for i in range(N_DRAWN)]
    want = {}
    for i, seqs in enumerate(chunks):
        js = jf.get_seeds(JRecords(names, seqs))
        ji = jf.index_reads(js)
        want[i] = (len(jf.seeds_on_paths_arrays(js, ji)),
                   len(jf.seeds_off_paths_arrays(js, ji)),
                   int(js.valid.sum()))
    assert res["on_path_cold"]["hits"] == want[0][0] > 0
    assert res["on_path_warm"]["hits"] == want[1][0] > 0
    assert res["off_path_cold"]["hits"] == want[1][1]
    assert res["off_path_warm"]["hits"] == want[0][1]
    assert res["on_path_cold"]["seeds"] == want[0][2]
    assert res["on_path_warm"]["seeds"] == want[1][2]


def test_cli_matches_psi_tpu_and_reports_build(finders, tmp_path):
    """psikt with the configuration's flags over the GFA, on the CPU: the
    first run builds and saves the index (its host stages timed in the
    report's `build`), the second loads it; both give psi_tpu's
    lexsorted hit stream, and the report names the off-path route."""
    _, tgraph, _, _, _, seqs = finders
    gfa, fq = str(tmp_path / "g.gfa"), str(tmp_path / "r.fastq")
    chr_scale.write_gfa(tgraph, gfa)
    chr_scale.write_fastq(seqs, fq)

    def run(main, tag, extra=()):
        out, rep = tmp_path / f"{tag}.bin", tmp_path / f"{tag}.json"
        assert main([gfa, "-f", fq, *chr_scale.CLI_FLAGS, "-c", "1000",
                     "-I", str(tmp_path / f"{tag}_pidx"), "-o", str(out),
                     "--report", str(rep), "-q", "-Q", *extra]) == 0
        hits = np.fromfile(out, dtype="<i8").reshape(-1, 4)
        with open(rep) as fh:
            return hits[np.lexsort(hits.T[::-1])], json.load(fh)

    want, _ = run(jcli.main, "jax", ("--device", "cpu"))
    built, rep1 = run(cli.main, "torch", ("--device", "cpu"))
    loaded, rep2 = run(cli.main, "torch", ("--device", "cpu"))
    assert len(want) > 0
    assert built.tobytes() == want.tobytes() == loaded.tobytes()
    assert rep1["pindexsize"] == rep2["pindexsize"] > 0
    b1, b2 = rep1["build"], rep2["build"]
    for stage in ("graph_load_s", "pick_paths_s", "index_paths_s", "loci_s",
                  "dindex_s", "save_s", "ftab_s"):
        assert b1[stage] > 0, stage
    assert b1["load_s"] < b2["load_s"] and b2["ftab_s"] > 0
    assert b2["pick_paths_s"] == b2["index_paths_s"] == b2["save_s"] == 0
    assert rep1["offpath"] == rep2["offpath"]
    assert rep1["offpath"]["route"] == "walktree"
    assert rep1["offpath"]["walktree_nodes"] > 0
