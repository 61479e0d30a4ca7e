"""psi_tpu_torch's copies of psi_tpu's host modules against the originals:
on the same seeded inputs each copy gives the same arrays as the module
it was copied from, with each package's native host library loaded (the
port builds its own from psi_tpu_torch/csrc/host). The single-core
backward search (psi_fm.cpp, the speed baseline) also agrees with the
port's own searches."""

import difflib
import fcntl
import os
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from psi_tpu import native as jnative
from psi_tpu.dindex import contract_chains
from psi_tpu.fmindex import FMIndex as JFMIndex
from psi_tpu.io import load_graph as jload_graph
from psi_tpu.records import Records as JRecords
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu.simulate import make_pangenome_graph as jmake_graph
from psi_tpu.ops import fm_stream as jfm_stream
from psi_tpu_torch import native
from psi_tpu_torch.fmindex import FMIndex
from psi_tpu_torch.io import load_graph
from psi_tpu_torch.pathutil import Path, sequence
from psi_tpu_torch.graphiter import HaplotyperRandomIter
from psi_tpu_torch.ops import fm_stream, fm_trie
from psi_tpu_torch.records import Records
from psi_tpu_torch.seed_finder import SeedFinder
from psi_tpu_torch.simulate import make_pangenome_graph

K = 16
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jnative_loaded():
    """psi_tpu's native library, loaded. psi_tpu builds
    native/libpsi_host.so at first use in every process, with no lock
    between processes, so a test process that opens the file while
    another one's make still writes it keeps psi_tpu's NumPy fallback.
    Where the library did not load, build it here under a file lock into
    a file of this process, rename that into place and load it again; a
    build that fails fails the tests."""
    if jnative.available():
        return
    (REPO / "build").mkdir(exist_ok=True)
    with open(REPO / "build" / "psi_tpu_native.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        tmp = REPO / "build" / f"libpsi_host.{os.getpid()}.so"
        run = subprocess.run(["make", "-C", str(REPO / "native"), "-s",
                              f"TARGET={tmp}"],
                             capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stdout + run.stderr
        os.replace(tmp, REPO / "native" / "libpsi_host.so")
    jnative._tried = False
    assert jnative.available(), "psi_tpu's native library does not load"


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One seeded bubble graph as GFA, reads of a haplotype, and both
    packages' finders over it with one picked path."""
    assert native.available(), native.load_error
    assert jnative.available()
    tmp = tmp_path_factory.mktemp("host")
    graph = make_pangenome_graph(20_000, 0.03, seed=6)
    gfa = tmp / "g.gfa"
    coords, loff = graph.coord_ids, graph.label_offsets
    labels = graph.labels.tobytes().decode()
    with open(gfa, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for r in range(graph.node_count):
            fh.write(f"S\t{coords[r]}\t{labels[loff[r]:loff[r + 1]]}\n")
        for r in range(graph.node_count):
            for v in graph.out_indices[graph.out_indptr[r]:
                                       graph.out_indptr[r + 1]]:
                fh.write(f"L\t{coords[r]}\t+\t{coords[v - 1]}\t+\t0M\n")
        for name, nodes in graph.paths:
            segs = ",".join(f"{coords[v - 1]}+" for v in nodes)
            fh.write(f"P\t{name}\t{segs}\t*\n")
    itr = HaplotyperRandomIter(graph, seed=3)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = sequence(hap)
    rng = np.random.RandomState(8)
    starts = rng.randint(0, len(hs) - 80, 400)
    names = [f"r{i}" for i in range(len(starts))]
    seqs = [hs[p:p + 80] for p in starts]
    finders = []
    for cls, loader, kw in ((SeedFinder, load_graph, {"device": "cpu"}),
                            (JSeedFinder, jload_graph, {})):
        finder = cls(loader(str(gfa), cache=False), K, **kw)
        finder.create_path_index(1, patched=False)
        finders.append(finder)
    return str(gfa), names, seqs, finders


def _gfa(world):
    gfa = world[0]
    got, want = load_graph(gfa, cache=False), jload_graph(gfa, cache=False)
    assert got.node_count == want.node_count
    for name in ("labels", "label_offsets", "out_indptr", "out_indices",
                 "coord_ids"):
        _eq(getattr(got, name), getattr(want, name))
    assert [(n, list(p)) for n, p in got.paths] == \
        [(n, list(p)) for n, p in want.paths]


def _fmindex(world):
    rng = np.random.RandomState(2)
    strings = ["".join(rng.choice(list("ACGTN"), size=n))
               for n in (9_000, 4_000, 700)]
    got = FMIndex.build_from_strings(strings)
    want = JFMIndex.build_from_strings(strings)
    for name in ("bwt", "sa", "C", "occ", "str_starts", "lengths"):
        _eq(getattr(got, name), getattr(want, name))


def _seeds(world):
    _, names, seqs, (finder, jfinder) = world
    for distance in (0, 5):
        seeds = finder.get_seeds(Records(names, seqs), distance)
        jseeds = jfinder.get_seeds(JRecords(names, seqs), distance)
        for name in ("keys", "valid", "seedmap"):
            _eq(getattr(seeds, name), getattr(jseeds, name))
        index, jindex = finder.index_reads(seeds), jfinder.index_reads(jseeds)
        for name in ("sorted_keys", "seed_ids", "chars", "occ", "planes"):
            _eq(getattr(index, name), getattr(jindex, name))


def _uncovered_loci(world):
    finder, jfinder = world[3]
    got = [(p.node_id(), p.offset()) for p in finder.get_starting_loci()]
    want = [(p.node_id(), p.offset()) for p in jfinder.get_starting_loci()]
    assert got == want and len(got) > 0


def _picked_paths(world):
    finder, jfinder = world[3]
    got = [(list(p.get_nodes()), p.left, p.right)
           for p in finder.pindex.get_paths_set()]
    want = [(list(p.get_nodes()), p.left, p.right)
            for p in jfinder.pindex.get_paths_set()]
    assert got == want and len(got) == 1
    _eq(finder.pindex.fm.bwt, jfinder.pindex.fm.bwt)


def _trie_schedule(world):
    rng = np.random.RandomState(4)
    keys = np.unique(rng.randint(0, 4 ** K, size=3000).astype(np.uint64))
    for level in (0, 6):
        got = native.trie_schedule(keys, K, level)
        want = jnative.trie_schedule(keys, K, level)
        for a, b in zip(got[0] + got[1], want[0] + want[1], strict=True):
            _eq(a, b)
        _eq(got[2], want[2])
        assert (got[3] is None) == (want[3] is None)
        if got[3] is not None:
            _eq(got[3], want[3])


def _emit_join(world):
    """The fused join over a synthetic chain: U distinct keys, each with
    0..3 path occurrences and 1..3 seeds."""
    rng = np.random.RandomState(5)
    U, S = 300, 600
    counts = rng.randint(0, 4, U).astype(np.int64)
    emit_idx = np.nonzero(counts)[0]
    inv = np.arange(U, dtype=np.int64)
    occ_start_u = np.cumsum(counts) - counts
    gpos = rng.randint(0, 50_000, int(counts.sum())).astype(np.int64)
    pm_starts = np.arange(0, 50_000, 37, dtype=np.int64)
    pm_ids = np.arange(1, len(pm_starts) + 1, dtype=np.int64)
    pm_base = rng.randint(0, 3, len(pm_starts)).astype(np.int64)
    sizes = rng.randint(1, 4, U)
    uniq_end = np.cumsum(sizes).astype(np.int64)
    uniq_start = uniq_end - sizes
    seed_ids = rng.permutation(int(uniq_end[-1])).astype(np.int64)
    seedmap = rng.randint(0, 1000, (S + int(uniq_end[-1]), 2)).astype(np.int64)
    rows = counts[emit_idx] * sizes[emit_idx]
    out_off = np.zeros(len(emit_idx) + 1, dtype=np.int64)
    np.cumsum(rows, out=out_off[1:])
    outs = []
    for lib in (native, jnative):
        out = np.full((int(out_off[-1]), 6), -7, dtype=np.int64)
        assert lib.emit_join(counts, emit_idx, inv, inv, occ_start_u, gpos,
                             pm_starts, pm_ids, pm_base, uniq_start,
                             uniq_end, seed_ids, seedmap, 11, K, out_off,
                             out)
        outs.append(out)
    _eq(outs[0], outs[1])
    assert (outs[0] != -7).all()


def _dindex(world):
    """The supernode DP and the node-pair BFS builder."""
    graph = make_pangenome_graph(20_000, 0.03, seed=6)
    node_len = np.diff(graph.label_offsets)
    sup = contract_chains(node_len, graph.out_indptr, graph.out_indices)
    for dmax in (1, 40, 400):
        for lib in ("dindex_super_build", "dindex_build"):
            args = (sup[3:] if lib == "dindex_super_build" else
                    (node_len, graph.out_indptr, graph.out_indices))
            got = getattr(native, lib)(*args, dmax)
            want = getattr(jnative, lib)(*args, dmax)
            for a, b in zip(got, want, strict=True):
                _eq(a, b)
            assert len(got[1]) > 0
    # a cycle: the supernode DP refuses it, as psi_tpu's does
    assert native.dindex_super_build(np.array([2, 3]), np.array([0, 1, 2]),
                                     np.array([1, 0]), 9) is None


def _gaf_scan(world):
    lines = []
    rng = np.random.RandomState(7)
    for i in range(300):
        for mate in ("/1", "/2", "") if i % 7 == 0 else ("/1", "/2"):
            path = "".join(f"{'<>'[rng.randint(2)]}{rng.randint(1, 999)}"
                           for _ in range(rng.randint(1, 5)))
            lines.append(f"q{i % 250}{mate}\t100\t0\t100\t+\t{path}\t300\t"
                         f"{rng.randint(0, 50)}\t{rng.randint(50, 300)}\t99"
                         f"\t100\t60\n")
    buf = "".join(lines).encode() + b"short\tline\n"
    for a, b in zip(native.gaf_scan(buf), jnative.gaf_scan(buf), strict=True):
        _eq(a, b)
    _eq(native.gaf_scan(b"")[4], jnative.gaf_scan(b"")[4])


def _baseline_index(k=14, n_keys=400):
    """psi_tpu's native baseline test's inputs (tests/test_native.py): a
    60 kbp index of two reversed random strings, and k-mers given as
    int32 code rows (symbols 1..4), half of them substrings and half
    random. Returns (both FM indexes, the strings, codes)."""
    rng = np.random.RandomState(11)
    strings = ["".join(rng.choice(list("ACGT"), size=30_000))
               for _ in range(2)]
    rev = [s[::-1] for s in strings]
    lut = {c: i for i, c in enumerate("ACGT")}
    kmers = np.empty((n_keys, k), dtype=np.int64)
    half = n_keys // 2
    starts = rng.randint(0, 30_000 - k, size=half)
    for r in range(half):
        s = strings[r % 2]
        kmers[r] = [lut[ch] for ch in s[starts[r]: starts[r] + k]]
    kmers[half:] = rng.randint(0, 4, size=(n_keys - half, k))
    return (FMIndex.build_from_strings(rev), JFMIndex.build_from_strings(rev),
            (kmers + 1).astype(np.int32))


def _same_ranges(lo, hi, want_lo, want_hi):
    """R3: hi - lo everywhere, lo only where the range is not empty."""
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    want_lo, want_hi = np.asarray(want_lo, np.int64), np.asarray(want_hi,
                                                                  np.int64)
    _eq(np.maximum(hi - lo, 0), np.maximum(want_hi - want_lo, 0))
    full = want_hi > want_lo
    _eq(lo[full], want_lo[full])


def _payload_host(world):
    fm, jfm, _ = _baseline_index()
    got = fm_stream.payload_host(fm)
    assert got.dtype == np.int32 and got.shape[0] == 16
    _eq(got, jfm_stream.payload_host(jfm))


def _fm_backward_batch(world):
    """csrc/host/psi_fm.cpp's single-core search gives psi_tpu's lo, hi
    and nonempty exactly, and the ranges of backward_search_sorted, of
    the trie search over the same k-mers packed as keys (column 0 the
    most significant char, the trie's order) and of the host FM index."""
    fm, jfm, codes = _baseline_index()
    got = native.fm_backward_batch(fm_stream.payload_host(fm),
                                   fm.C.astype(np.int32), fm.size, codes)
    assert got is not None, native.load_error
    want = jnative.fm_backward_batch(jfm_stream.payload_host(jfm),
                                     jfm.C.astype(np.int32), jfm.size, codes)
    assert want is not None
    lo, hi, nonempty = got
    _eq(lo, want[0])
    _eq(hi, want[1])
    assert nonempty == want[2] >= len(codes) // 2
    assert nonempty == int((hi > lo).sum())
    arrays = fm_stream.build_stream_arrays(fm, torch.device("cpu"))
    slo, shi = fm_stream.backward_search_sorted(arrays,
                                                torch.from_numpy(codes))
    _same_ranges(slo.numpy(), shi.numpy(), lo, hi)
    k = codes.shape[1]
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    keys = ((codes.astype(np.uint64) - np.uint64(1)) << shifts).sum(
        axis=1, dtype=np.uint64)
    uniq, inv = np.unique(keys, return_inverse=True)
    tlo, thi = fm_trie.trie_search(arrays, uniq, k)
    _same_ranges(tlo[inv], thi[inv], lo, hi)
    for i in range(len(codes)):
        # codes are fed first to last: backward search of the reversal
        pat = "".join("ACGT"[c - 1] for c in codes[i])[::-1]
        elo, ehi = fm.backward_search(pat)
        _same_ranges(lo[i:i + 1], hi[i:i + 1], [elo], [ehi])


@pytest.mark.parametrize("module", [
    "gfa", "fmindex", "seeds", "uncovered_loci", "picked_paths",
    "trie_schedule", "emit_join", "dindex", "gaf_scan", "payload_host",
    "fm_backward_batch",
])
def test_copy_matches_original(world, module):
    globals()[f"_{module}"](world)


def test_simulated_graph_matches_original():
    got, want = make_pangenome_graph(8000, 0.05, seed=2), jmake_graph(
        8000, 0.05, seed=2)
    for name in ("labels", "label_offsets", "out_indptr", "out_indices"):
        _eq(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "psi_tpu_torch" / "csrc" / "host").glob("*.cpp")))
def test_host_source_is_a_copy(name):
    """Each csrc/host source is native/'s, but for comment lines that name
    how the copy is built."""
    got = (REPO / "psi_tpu_torch" / "csrc" / "host" / name).read_text()
    want = (REPO / "native" / name).read_text()
    changed = [line for line in difflib.unified_diff(
        want.splitlines(), got.splitlines(), lineterm="", n=0)
        if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert all(line[1:].lstrip().startswith("//") for line in changed), \
        changed
