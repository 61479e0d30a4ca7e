"""psi_tpu's human-pan-genome-scale configuration (scripts/gchar3_run.py)
at a CPU size, held exactly to psi_tpu: a 16-component pan-genome with a
bubble every ~1 kbp and 20% insertions, k = 30, one unpatched path a
region, loci every 10 bp and then at every bp, the distance index over
(250, 450), error-free 150 bp reads, all under PSI_SA_DISK=1 (the
disk-spilled suffix array). tools/gchar3's constants against the
script's, its stages and keys, the index, loci, distance-index CSR,
distinct keys and hit multisets (WalkTree and device traversal) against
psi_tpu's, the big-column artifact across the two packages, and the
query note past 2^31 chars. Every output is integer and compared with
no tolerance."""

import ast
import operator
import pathlib

import numpy as np
import pytest

from psi_tpu.dindex import DistanceIndex as JDistanceIndex
from psi_tpu.records import Records as JRecords
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu.simulate import make_pangenome_graph
from psi_tpu_torch.dindex import DistanceIndex
from psi_tpu_torch.records import Records
from psi_tpu_torch.tools import chr_scale, gchar3

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the CPU size: 16 components of 30 kbp (the chip runs 2.0 Gchar)
GCHAR = 0.00048
N_READS = 2_000
STAGES = ["graph_gen", "path_index", "uncovered_loci", "dindex_artifact",
          "seeding", "read_index", "on_path", "off_path"]


def _script():
    """scripts/gchar3_run.py's constants (name -> value node, tuple
    assignments split), its calls by function name and its `res[...]`
    keys."""
    tree = ast.parse((REPO / "scripts" / "gchar3_run.py").read_text())
    assigns, calls, keys = {}, {}, []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Tuple):
                for n, v in zip(t.elts, node.value.elts):
                    assigns[n.id] = v
            elif isinstance(t, ast.Name):
                assigns[t.id] = node.value
            elif (isinstance(t, ast.Subscript) and ast.unparse(t.value) == "res"
                  and isinstance(t.slice, ast.Constant)):
                keys.append((t.slice.value, node.value))
        elif isinstance(node, ast.Call):
            calls.setdefault(ast.unparse(node.func).split(".")[-1],
                             []).append(node)
    for found in calls.values():      # in the script's order
        found.sort(key=lambda n: (n.lineno, n.col_offset))
    return tree, assigns, calls, keys


def _value(node, assigns):
    if isinstance(node, ast.Name):           # a constant of the script
        return _value(assigns[node.id], assigns)
    if isinstance(node, ast.IfExp):          # `argv[i] if ... else default`
        return _value(node.orelse, assigns)
    if isinstance(node, ast.BinOp):
        op = {ast.Div: operator.truediv, ast.Mult: operator.mul,
              ast.Pow: operator.pow}[type(node.op)]
        return op(_value(node.left, assigns), _value(node.right, assigns))
    return ast.literal_eval(node)


def _locus_reads(graph, loci, rng) -> list:
    """One read from each locus along a random walk: its first seed
    starts at the locus, so the off-path traversal finds it."""
    text = graph.labels.tobytes().decode("ascii")
    loff, indptr, succ = graph.label_offsets, graph.out_indptr, graph.out_indices
    reads = []
    for node, off in loci:
        seq = text[loff[node - 1] + off:loff[node]]
        while len(seq) < gchar3.READ_LEN and indptr[node] > indptr[node - 1]:
            node = int(succ[rng.randint(indptr[node - 1], indptr[node])])
            seq += text[loff[node - 1]:loff[node]]
        if len(seq) >= gchar3.SEED_LEN:
            reads.append(seq[:gchar3.READ_LEN])
    return reads


def _loci(finder) -> np.ndarray:
    return np.array([(p.node_id(), p.offset())
                     for p in finder.get_starting_loci()], dtype=np.int64)


def _lexsorted(arr) -> np.ndarray:
    cols = np.stack([np.asarray(arr[c], dtype=np.int64) for c in (
        "node_id", "node_offset", "read_id", "read_offset")], axis=1)
    return cols[np.lexsort(cols.T[::-1])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """psi_tpu's finder through the script's calls and the port's
    gchar3.run, both on the CPU under PSI_SA_DISK=1, and psi_tpu's
    seeds over the same draw."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PSI_SA_DISK", "1")
        mp.delenv("PSI_G3_PATCHED", raising=False)
        graph = make_pangenome_graph(int(GCHAR * 1e9), variant_rate=1.0 / 1000,
                                     indel_frac=0.2, seed=7, n_components=16)
        jf = JSeedFinder(graph, seed_len=30)
        jf.create_path_index(n=1, patched=False, context=30, step_size=10,
                             dmin=250, dmax=450)
        jf.add_uncovered_loci()
        keep = {}
        res = gchar3.run(GCHAR, N_READS, "cpu",
                         workdir=str(tmp_path_factory.mktemp("g3")),
                         keep=keep, warm=True, log=lambda msg: None)
    names = [f"r{i}" for i in range(N_READS)]
    js = jf.get_seeds(JRecords(names, list(keep["reads"].seqs)))
    return graph, jf, js, jf.index_reads(js), res, keep


def test_constants_match_psi_tpu_script():
    """tools/gchar3 keeps scripts/gchar3_run.py's configuration: the
    generator's and the index's arguments, k, the insert range, the
    variant spacing, the reads, the draws' seeds, the probes, the
    default size, the 2^31 query bound, its note and PSI_G3_PATCHED."""
    tree, assigns, calls, keys = _script()

    def kw(call):
        (node,) = calls[call]
        return {k.arg: k.value for k in node.keywords}

    gen = {k: _value(v, assigns) for k, v in kw("make_pangenome_graph").items()}
    assert gen == {"variant_rate": 1.0 / gchar3.VAR_BP,
                   "indel_frac": gchar3.INDEL_FRAC, "seed": gchar3.GRAPH_SEED,
                   "n_components": gchar3.N_COMPONENTS}
    idx = kw("create_path_index")
    assert ast.unparse(idx.pop("patched")) == "patched"
    assert {k: _value(v, assigns) for k, v in idx.items()} == {
        "n": gchar3.N_PATHS, "context": gchar3.CONTEXT,
        "step_size": gchar3.STEP_SIZE, "dmin": gchar3.DMIN,
        "dmax": gchar3.DMAX}
    assert "PSI_G3_PATCHED" in ast.unparse(assigns["patched"])
    for name, want in (("k", gchar3.SEED_LEN), ("dmin", gchar3.DMIN),
                       ("dmax", gchar3.DMAX), ("var_bp", gchar3.VAR_BP),
                       ("n_reads", gchar3.N_READS),
                       ("read_len", gchar3.READ_LEN), ("gchar", gchar3.GCHAR)):
        assert _value(assigns[name], assigns) == want, name
    assert gchar3.CONTEXT == gchar3.SEED_LEN
    assert gchar3.READ_LEN == chr_scale.READ_LEN    # chr_scale's draw
    assert [[_value(a, assigns) for a in c.args]
            for c in calls["RandomState"]] == [[gchar3.PROBE_SEED],
                                               [gchar3.READS_SEED]]
    assert [_value(a, assigns) for a in calls["range"][0].args] == [
        gchar3.N_PROBES]
    bound = [_value(n.comparators[0], assigns) for n in ast.walk(tree)
             if isinstance(n, ast.Compare) and "fm.size" in ast.unparse(n)]
    assert bound == [gchar3.QUERY_MAX_CHARS]
    assert dict((k, v) for k, v in keys)["query_note"].value == (
        gchar3.QUERY_NOTE)


def test_stages_and_keys_are_the_scripts(runs):
    """gchar3.run's stages, in the script's order, and every key the
    script writes, with the port's own beside them."""
    *_, res, keep = runs
    tree, _, calls, keys = _script()
    stages = [c.args[0].value for c in calls["stage"]]
    assert stages == STAGES
    assert [k[:-2] for k in res if k.endswith("_s") and k != "total_s"] == (
        STAGES)
    want = {k for k, _ in keys} - {"query_note"}
    want |= {f"{s}_{x}" for s in stages for x in ("s", "peak_gb")}
    want |= {"gchar", "dmin", "dmax", "k", "var_bp"}
    assert want <= set(res)
    assert res["device"] == "cpu" and res["patched"] is False
    assert res["off_path_route"]["route"] == "walktree"
    for s in ("on_path", "off_path"):       # no kernel runs on the CPU
        assert set(res[f"{s}_launches"].values()) == {0}
    assert res["total_s"] == pytest.approx(sum(res[f"{s}_s"] for s in STAGES))
    warm = res["warm"]                      # the chunk again, warm
    assert (warm["on_path_hits"], warm["off_path_hits"]) == (
        res["on_hits"], res["off_hits"])
    assert warm["seeds"] == int(keep["seeds"].valid.sum()) > 0


def test_index_matches_psi_tpu(runs):
    """Nodes, the disk-spilled SA and index size, the loci array (step
    10, then step 1), the distance-index CSR, distinct keys and hit
    counts equal psi_tpu's; every component has loci."""
    graph, jf, js, ji, res, keep = runs
    tf = keep["finder"]
    assert res["nodes"] == graph.node_count == keep["graph"].node_count
    assert isinstance(tf.pindex.fm.sa, np.memmap)
    assert res["fm_chars"] == jf.pindex.fm.size == tf.pindex.fm.size > 0
    assert np.array_equal(tf.pindex.fm.sa, jf.pindex.fm.sa)
    loci = _loci(tf)
    assert np.array_equal(loci, _loci(jf)) and res["loci"] == len(loci) > 0
    firsts = [nodes[0] for _, nodes in keep["graph"].paths]
    assert len(np.unique(np.searchsorted(firsts, loci[:, 0], "right"))) == 16
    got, want = tf.dindex, jf.dindex
    assert res["dindex_intervals"] == len(want.dst) > 0
    for name in ("src_indptr", "dst", "iv_lo", "iv_hi", "sup", "head",
                 "tail"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert res["distinct_keys"] == len(np.unique(ji.sorted_keys)) > 0
    assert res["on_hits"] == len(jf.seeds_on_paths_arrays(js, ji)) > 0
    assert res["off_hits"] == len(jf.seeds_off_paths_arrays(js, ji)) > 0


@pytest.mark.parametrize("route", ["walktree", "traverse_device"])
def test_hits_match_psi_tpu(runs, monkeypatch, route):
    """Lexsorted on-path and off-path hit multisets of the tool's draw
    and a read from every tenth locus, on the WalkTree and under
    PSI_TRAV_CACHE=0 (the device traversal), with hits on both; the
    tool's own hits are psi_tpu's on its draw."""
    graph, jf, js, ji, res, keep = runs
    tf = keep["finder"]
    assert _lexsorted(keep["on"]).tobytes() == _lexsorted(
        jf.seeds_on_paths_arrays(js, ji)).tobytes()
    assert _lexsorted(keep["off"]).tobytes() == _lexsorted(
        jf.seeds_off_paths_arrays(js, ji)).tobytes()
    if route == "traverse_device":
        monkeypatch.setenv("PSI_TRAV_CACHE", "0")
    seqs = list(keep["reads"].seqs) + _locus_reads(
        keep["graph"], _loci(tf)[::10], np.random.RandomState(3))
    names = [f"r{i}" for i in range(len(seqs))]
    ts = tf.get_seeds(Records(names, seqs))
    ti = tf.index_reads(ts)
    assert tf._traverse_dispatch(ti)[0] == {"walktree": "tree",
                                            "traverse_device": "single"}[route]
    on, off = tf.seeds_all_arrays(ts, ti, split=True)
    js2 = jf.get_seeds(JRecords(names, seqs))
    ji2 = jf.index_reads(js2)
    assert len(on) > 0 and len(off) > res["off_hits"]
    assert (_lexsorted(on).tobytes()
            == _lexsorted(jf.seeds_on_paths_arrays(js2, ji2)).tobytes())
    assert (_lexsorted(off).tobytes()
            == _lexsorted(jf.seeds_off_paths_arrays(js2, ji2)).tobytes())


@pytest.mark.parametrize("writer", ["psi_tpu", "port"])
def test_big_column_artifact_loads_in_both(runs, monkeypatch, tmp_path,
                                           writer):
    """With BIG_COL_BYTES lowered, an artifact that either package saves
    spills its big columns to side files; both load it memory-mapped,
    with the columns and the tool's probes psi_tpu's, and the port's
    check_artifact lists the side files."""
    graph, jf, *_, keep = runs
    for cls in (JDistanceIndex, DistanceIndex):
        monkeypatch.setattr(cls, "BIG_COL_BYTES", 1 << 10)
    src = jf.dindex if writer == "psi_tpu" else keep["finder"].dindex
    path = str(tmp_path / gchar3.ARTIFACT)
    src.save(path)
    side = sorted(p.name for p in tmp_path.glob("*.npy"))
    assert "gchar3_dindex.dst.npy" in side
    j, t = JDistanceIndex.load(path), DistanceIndex.load(path)
    assert isinstance(t.dst, np.memmap) and isinstance(j.dst, np.memmap)
    for name in ("src_indptr", "dst", "iv_lo", "iv_hi", "sup", "head",
                 "tail"):
        assert np.array_equal(getattr(t, name), getattr(j, name)), name
        assert np.array_equal(getattr(t, name), getattr(jf.dindex, name))
    rng = np.random.RandomState(gchar3.PROBE_SEED)
    n = graph.node_count
    for _ in range(gchar3.N_PROBES):
        v, u = (int(rng.randint(1, n + 1)) for _ in range(2))
        assert t.verify(keep["graph"], v, 0, u, 0) == j.verify(
            graph, v, 0, u, 0)
    out = gchar3.check_artifact(keep["finder"].dindex, keep["graph"],
                                str(tmp_path / "tool"))
    assert out["dindex_side_files"] == side
    assert out["dindex_artifact_mb"] > 0


def test_past_the_query_bound_no_query(runs, monkeypatch, tmp_path):
    """At fm_chars >= 2^31 (the bound lowered to this index's size) the
    tool builds, saves and seeds as before, runs no query and writes
    psi_tpu's query_note."""
    *_, res, keep = runs
    monkeypatch.setattr(gchar3, "QUERY_MAX_CHARS", res["fm_chars"])
    out = gchar3.run(GCHAR, N_READS, "cpu", workdir=str(tmp_path),
                     graph=keep["graph"], log=lambda msg: None)
    assert out["query_note"] == gchar3.QUERY_NOTE
    assert not {"on_path_s", "off_path_s", "on_hits", "off_hits"} & set(out)
    for key in ("nodes", "fm_chars", "loci", "dindex_intervals",
                "distinct_keys"):
        assert out[key] == res[key], key


def test_graph_past_int32_labels_raises():
    """The device traversal's graph arrays are int32: a label text of
    2^31 chars, which the 3 Gchar graph has, raises before anything is
    converted or uploaded, where a cast would wrap its offsets."""
    from types import SimpleNamespace

    from psi_tpu_torch.ops import traverse as trav

    big = SimpleNamespace(labels=np.broadcast_to(np.uint8(65), (1 << 31,)))
    with pytest.raises(ValueError, match="2\\^31"):
        trav.graph_to_device(big, "cpu")
