"""The slice as a whole: psi_tpu_torch's CLI with --device cpu against
psi_tpu's CLI (its chained stream route and its defaults) on a small
synthetic pan-genome, at gocc thresholds 0 and 5: equal lexsorted binary
hit streams and equal report seedhits, with hits both on and off the
indexed paths. Plus the cases the port does not cover yet, which raise."""

import json

import numpy as np
import pytest
import torch

from psi_tpu import cli as jcli
from psi_tpu.graphiter import HaplotyperRandomIter
from psi_tpu.pathutil import Path, sequence
from psi_tpu.simulate import make_pangenome_graph
from psi_tpu_torch import cli
from psi_tpu_torch.ops import fm_fused
from psi_tpu_torch.ops import traverse as trav
from psi_tpu_torch.seed_finder import SeedFinder


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


def test_not_ported_yet_raises(dataset, monkeypatch):
    graph = make_pangenome_graph(3000, 0.02, seed=1)
    for kw in ({"seed_mismatches": 1}, {"max_mem": 4}, {"devices": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SeedFinder(graph, 12, **kw)
    finder = SeedFinder(graph, 12, device="cpu")
    finder.create_path_index(1, patched=False)
    finder.add_uncovered_loci()
    monkeypatch.setattr(trav, "NODE_CAP", 10)
    with pytest.raises(NotImplementedError, match="WalkTree over its cap"):
        finder._get_trav_tree()
    with pytest.raises(NotImplementedError, match="item 8"):
        finder.find_mems_arrays(None)
    with pytest.raises(NotImplementedError, match="item 9"):
        SeedFinder(graph, 12, device="cpu").create_path_index(
            1, patched=False, dmin=200, dmax=400)


def test_path_index_round_trip(tmp_path):
    """A path index (-I) saves and loads at insert size 0: the same
    paths, FM index and starting loci come back."""
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
    with pytest.raises(NotImplementedError, match="item 9"):
        loaded.load_path_index(prefix, dmin=200)


def test_cli_device_cuda_without_gpu_raises(dataset, monkeypatch):
    tmp, gpath, fq = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([gpath, "-f", fq, "-l", "20", "--device", "cuda",
                  "-o", str(tmp / "none.bin"), "-q", "-Q"])
