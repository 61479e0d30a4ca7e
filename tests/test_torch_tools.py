"""psi_tpu_torch's dindexctl and alice against psi_tpu's on a synthetic
GFA and a GAF of read pairs (tools/pairs.py), on the CPU: the same
printed lines and the same artifacts. The dstats counts also equal the
index's verify_batch over the pairs' loci."""

import os

import numpy as np
import pytest

from psi_tpu import native as jnative
from psi_tpu.tools import alice as jalice
from psi_tpu.tools import dindexctl as jdindexctl
from psi_tpu_torch import native
from psi_tpu_torch.dindex import DistanceIndex
from psi_tpu_torch.io import load_graph
from psi_tpu_torch.simulate import make_pangenome_graph
from psi_tpu_torch.tools import alice, dindexctl, pairs
from psi_tpu_torch.tools.bacterial import write_gfa
from psi_tpu_torch.tools.ggsim import simulate_haplotypes

N_PAIRS = 3000
GAP = 900


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A bubble graph as GFA, 3,000 pairs on its haplotypes (7/8 within
    a 900 bp gap) as a GAF, and a truth GAF with a tenth of the records
    moved by 3 bp and a twentieth left out."""
    tmp = tmp_path_factory.mktemp("tools")
    graph = make_pangenome_graph(30_000, 0.01, seed=4)
    gfa = str(tmp / "g.gfa")
    write_gfa(graph, gfa)
    haps = [h for _, h in simulate_haplotypes(graph, 2, seed=5)]
    coords = pairs.hap_coords(graph, haps)
    pr = pairs.sample_pairs(coords, N_PAIRS, GAP, seed=6)
    gaf = str(tmp / "pairs.gaf")
    pairs.write_gaf(graph, coords, pr, gaf, N_PAIRS)
    truth = str(tmp / "truth.gaf")
    with open(gaf) as fin, open(truth, "w") as fout:
        for i, line in enumerate(fin):
            f = line.split("\t")
            if i % 20 == 7:
                continue
            if i % 10 == 3:
                f[7], f[8] = str(int(f[7]) + 3), str(int(f[8]) + 3)
            fout.write("\t".join(f))
    return tmp, gfa, gaf, truth, coords, pr


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, mods=(dindexctl, jdindexctl)):
    got, want = (_run(m.main, argv(tag), capsys)
                 for m, tag in zip(mods, ("t", "j")))
    assert got == want
    return got


@pytest.mark.parametrize("cmd", ["build", "build_whole", "merge", "stats"])
def test_dindexctl_matches_psi_tpu(data, cmd, capsys, monkeypatch, tmp_path):
    """build (--verify, --whole), merge (--verify --graph) and stats print
    what psi_tpu's dindexctl prints and write the same artifacts."""
    tmp, gfa, *_ = data
    monkeypatch.setenv("HOME", str(tmp_path))

    def out(tag, name):
        return str(tmp_path / f"{tag}_{name}.npz")

    def build(tag, lo, hi, name, *extra):
        return ["build", gfa, "-m", str(lo), "-M", str(hi), "-o",
                out(tag, name), *extra]

    if cmd.startswith("build"):
        extra = ("--whole",) if cmd == "build_whole" else ()
        rc, _, err = _both(lambda t: build(t, 250, 450, "a", "--verify", "8",
                                           *extra), capsys)
        assert rc == 0 and "verification: PASS" in err
        with np.load(out("t", "a")) as a, np.load(out("j", "a")) as b:
            assert sorted(a.files) == sorted(b.files)
            for name in a.files:
                np.testing.assert_array_equal(a[name], b[name])
        return
    for lo, hi, name in ((250, 450, "a"), (451, 900, "b")):
        _both(lambda t: build(t, lo, hi, name), capsys)
    if cmd == "merge":
        rc, _, err = _both(lambda t: ["merge", out(t, "a"), out(t, "b"), "-o",
                                      out(t, "ab"), "--verify", "6",
                                      "--graph", gfa], capsys)
        assert rc == 0 and "verification: PASS" in err
        assert _both(lambda t: ["merge", out(t, "a"), out(t, "b"), "-o",
                                out(t, "ab"), "--verify", "3"],
                     capsys)[0] == 2      # --verify needs --graph
    else:
        rc, text, _ = _both(lambda t: ["stats", out(t, "a")], capsys)
        assert rc == 0 and "n_intervals:" in text


@pytest.fixture
def index(data):
    tmp, gfa, *_ = data
    path = str(tmp / "d.npz")
    if not os.path.exists(path):
        DistanceIndex.build(load_graph(gfa, cache=False), 250, 1000).save(path)
    return path


@pytest.mark.parametrize("route", ["cpu", "host", "python_scan"])
def test_alice_dstats_matches_psi_tpu(data, index, route, capsys,
                                      monkeypatch):
    """dstats on --device cpu (the kernel's plain version), on the NumPy
    host probe (PSI_DINDEX_DEVICE=0) and through the Python GAF scan
    prints psi_tpu's counts; accepted equals verify_batch over the pairs'
    loci."""
    tmp, gfa, gaf, _, coords, pr = data
    monkeypatch.setenv("HOME", str(tmp))
    monkeypatch.delenv("PSI_DINDEX_DEVICE", raising=False)
    argv = ["dstats", gaf, "-g", gfa, "-d", index]
    if route == "host":
        monkeypatch.setenv("PSI_DINDEX_DEVICE", "0")
    if route == "python_scan":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "gaf_scan", lambda buf: None)
    got = _run(alice.main, argv + ["--device", "cpu"], capsys)
    want = _run(jalice.main, argv, capsys)
    assert got == want and got[0] == 0
    counts = dict(line.split(": ") for line in got[1].splitlines())
    graph = load_graph(gfa, cache=False)
    v, o = pairs.loci(coords, pr["hap_a"], pr["pos_a"])
    u, p = pairs.loci(coords, pr["hap_b"], pr["pos_b"])
    accepted = DistanceIndex.load(index).verify_batch(graph, v, o, u, p)
    assert int(counts["pairs"]) == N_PAIRS
    assert int(counts["accepted"]) == int(accepted.sum()) > N_PAIRS // 2
    assert int(counts["rejected"]) > 0 and int(counts["skipped"]) == 0


def test_alice_dstats_defaults_to_the_card(data, index, capsys, monkeypatch):
    import torch

    tmp, gfa, gaf, *_ = data
    monkeypatch.setenv("HOME", str(tmp))
    monkeypatch.delenv("PSI_DINDEX_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alice.main(["dstats", gaf, "-g", gfa, "-d", index])


@pytest.mark.parametrize("tolerance", [0, 5])
def test_alice_analyse_matches_psi_tpu(data, tolerance, capsys, monkeypatch):
    tmp, gfa, gaf, truth, *_ = data
    monkeypatch.setenv("HOME", str(tmp))
    argv = ["analyse", gaf, "-g", gfa, "-T", truth, "--tolerance",
            str(tolerance)]
    got, want = (_run(m.main, argv, capsys) for m in (alice, jalice))
    assert got == want and got[0] == 0
    counts = dict(line.split(": ") for line in got[1].splitlines())
    # the records left out of the truth are false positives
    assert int(counts["true positives"]) > int(counts["false positives"]) > 0
