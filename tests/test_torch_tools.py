"""psi_tpu_torch's tool CLIs against psi_tpu's on a synthetic GFA, on the
CPU, with the same argv: dindexctl and alice over a GAF of read pairs
(tools/pairs.py), pindexctl, loci_stats and sloci over path indexes built
by either package, and ggsim. The same printed lines, exit codes and
artifacts, byte for byte. The dstats counts also equal the index's
verify_batch over the pairs' loci, and SeedFinder.nof_uncovered_kmers
equals psi_tpu's."""

import glob
import gzip
import os
import shutil

import numpy as np
import pytest

from psi_tpu import native as jnative
from psi_tpu.io import load_graph as jload_graph
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu.tools import alice as jalice
from psi_tpu.tools import dindexctl as jdindexctl
from psi_tpu.tools import ggsim as jggsim
from psi_tpu.tools import loci_stats as jloci_stats
from psi_tpu.tools import pindexctl as jpindexctl
from psi_tpu.tools import sloci as jsloci
from psi_tpu_torch import native
from psi_tpu_torch.dindex import DistanceIndex
from psi_tpu_torch.io import load_graph
from psi_tpu_torch.seed_finder import SeedFinder
from psi_tpu_torch.simulate import make_pangenome_graph
from psi_tpu_torch.tools import (alice, dindexctl, ggsim, loci_stats, pairs,
                                 pindexctl, sloci)
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


K = 20          # the path indexes' seed length, as the bacterial cell's
LOCI = f"_loci_e1l{K}.npy"


def _finders(gfa, k, n):
    """The port's finder (on the CPU) and psi_tpu's, each with an index of
    n unpatched paths."""
    finders = (SeedFinder(load_graph(gfa, cache=False), k, device="cpu"),
               JSeedFinder(jload_graph(gfa, cache=False), k))
    for finder in finders:
        finder.create_path_index(n, patched=False)
    return finders


@pytest.fixture(scope="module")
def pidx(data):
    """Path-index prefixes of data's graph (k = 20, 2 paths) written by
    the port ("t") and by psi_tpu ("j"), and the port's loci count."""
    tmp, gfa, *_ = data
    finders = _finders(gfa, K, 2)
    prefixes = {}
    for tag, finder in zip("tj", finders):
        prefixes[tag] = str(tmp / f"pidx_{tag}")
        assert finder.serialize_path_index(prefixes[tag])
    _same_files(prefixes["t"] + LOCI, prefixes["j"] + LOCI)
    _same_files(prefixes["t"] + "_paths", prefixes["j"] + "_paths")
    return gfa, prefixes, len(finders[0].get_starting_loci())


def _same_files(a, b):
    """Byte-identical files; of gzip streams (.vg, .gam) the stream's
    bytes, since the gzip header holds the file's name and write time."""
    got, want = (open(f, "rb").read() for f in (a, b))
    if got[:2] == want[:2] == b"\x1f\x8b":
        got, want = gzip.decompress(got), gzip.decompress(want)
    assert got == want, (a, b)


PINDEXCTL = {
    "inspect": lambda g, p, o: ["inspect", g, "-I", p, "-l", str(K)],
    # no loci artifact at step 2: both rebuild it and save it
    "inspect_rebuild": lambda g, p, o: ["inspect", g, "-I", p, "-l", str(K),
                                        "-e", "2"],
    "missing": lambda g, p, o: ["inspect", g, "-I", p + "_none", "-l",
                                str(K)],
    "to-fasta": lambda g, p, o: ["to-fasta", g, "-I", p, "-o", o],
    "to-vg": lambda g, p, o: ["to-vg", g, "-I", p, "-o", o, "-l", str(K)],
    "to-gam": lambda g, p, o: ["to-gam", g, "-I", p, "-o", o, "-l", str(K)],
    "to-gam-L": lambda g, p, o: ["to-gam", g, "-I", p, "-o", o, "-l",
                                 str(K), "-L"],
    "to-gam-nol": lambda g, p, o: ["to-gam", g, "-I", p, "-o", o],
}


@pytest.mark.parametrize("builder", ["t", "j"])
@pytest.mark.parametrize("cmd", list(PINDEXCTL))
def test_pindexctl_matches_psi_tpu(pidx, builder, cmd, capsys, monkeypatch,
                                   tmp_path):
    """Each subcommand prints what psi_tpu's prints, exits with its code
    and writes the same bytes, on a prefix written by either package (a
    prefix of one loads in the other's tool). Where the loci artifact is
    missing, both rebuild and save the same one."""
    gfa, prefixes, n_loci = pidx
    monkeypatch.setenv("HOME", str(tmp_path))
    results, outs = [], []
    for tag, mod, extra in (("t", pindexctl, ["--device", "cpu"]),
                            ("j", jpindexctl, [])):
        prefix = str(tmp_path / tag / "pidx")     # a copy per tool
        os.makedirs(os.path.dirname(prefix))
        for f in glob.glob(prefixes[builder] + "_*"):
            shutil.copy(f, prefix + f[len(prefixes[builder]):])
        out = str(tmp_path / f"{tag}.out")
        argv = PINDEXCTL[cmd](gfa, prefix, out)
        results.append(_run(mod.main, argv + extra, capsys))
        outs.append(out)
    assert results[0] == results[1]
    rc, text, err = results[0]
    if cmd == "missing":
        assert rc == 1 and "cannot load path index" in err
        return
    assert rc == 0
    if cmd.startswith("to-"):
        _same_files(*outs)
        assert os.path.getsize(outs[0]) > 0
    if cmd == "inspect":
        assert f"uncovered loci: {n_loci} / " in text
    if cmd == "inspect_rebuild":
        rebuilt = [str(tmp_path / tag / f"pidx_loci_e2l{K}.npy")
                   for tag in "tj"]
        _same_files(*rebuilt)
        assert f"uncovered loci: {len(np.load(rebuilt[0]))} / " in text


def test_pindexctl_defaults_to_the_card(pidx, monkeypatch, tmp_path):
    import torch

    gfa, prefixes, _ = pidx
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pindexctl.main(["inspect", gfa, "-I", prefixes["t"], "-l", str(K)])


@pytest.mark.parametrize("case", ["list", "count", "range", "rc_base",
                                  "missing"])
def test_loci_stats_matches_psi_tpu(pidx, case, capsys):
    gfa, prefixes, n_loci = pidx
    loci = np.load(prefixes["t"] + LOCI)
    lo, hi = np.quantile(loci[:, 0], [0.25, 0.75]).astype(np.int64)
    argv = {"list": [], "count": ["-c"],
            "range": ["-c", "--min-node", str(lo), "--max-node", str(hi)],
            "rc_base": ["--rc-base", str(hi), "--min-node", str(lo)],
            "missing": ["-e", "3"]}[case]
    argv = [prefixes["t"], "-l", str(K), *argv]
    got, want = (_run(m.main, argv, capsys) for m in (loci_stats,
                                                     jloci_stats))
    assert got == want
    rc, text, err = got
    if case == "missing":
        assert rc == 1 and "no starting loci file" in err
        return
    assert rc == 0
    sel = (loci[:, 0] >= lo) & (loci[:, 0] <= hi)
    if case == "count":
        assert text == f"{n_loci}\n"
    if case == "range":
        assert text == f"{int(sel.sum())}\n" and 0 < sel.sum() < n_loci
    if case == "rc_base":
        assert "\t-\n" in text and "\t+\n" in text


@pytest.mark.parametrize("cmd", ["export", "export_rc", "import", "info",
                                 "roundtrip"])
def test_sloci_matches_psi_tpu(pidx, cmd, capsys, tmp_path):
    """export (with --rc-base), import, info and export -> import print and
    write what psi_tpu's sloci does; the round trip gives the array back."""
    gfa, prefixes, n_loci = pidx
    loci_npy = prefixes["t"] + LOCI
    loci = np.load(loci_npy)
    tsv = str(tmp_path / "in.tsv")
    with open(tsv, "w") as fh:
        fh.write("# node\toffset\n\n")
        fh.writelines(f"{v}\t{o}\n" for v, o in loci)
    rc_base = str(int(np.median(loci[:, 0])))
    results = []
    for tag, mod in (("t", sloci), ("j", jsloci)):
        out = str(tmp_path / tag)
        argv = {"export": ["export", loci_npy, "-o", out],
                "export_rc": ["export", loci_npy, "-o", out, "--rc-base",
                              rc_base],
                "import": ["import", tsv, "-o", out],
                "info": ["info", loci_npy],
                "roundtrip": ["export", loci_npy, "-o", out + ".tsv"]}[cmd]
        results.append(_run(mod.main, argv, capsys))
        if cmd == "roundtrip":
            results.append(_run(mod.main, ["import", out + ".tsv", "-o",
                                           out], capsys))
    assert results[:len(results) // 2] == results[len(results) // 2:]
    assert all(r[0] == 0 for r in results)
    outs = [str(tmp_path / tag) for tag in "tj"]
    if cmd.startswith("export"):
        _same_files(*outs)
        assert len(open(outs[0]).readlines()) == n_loci
    if cmd in ("import", "roundtrip"):
        _same_files(*(o + ".npy" for o in outs))
        np.testing.assert_array_equal(np.load(outs[0] + ".npy"), loci)
    if cmd == "info":
        assert results[0][1].startswith(f"loci: {n_loci}\n")


GGSIM = {
    "plain": ["-t", "plain", "-n", "300"],
    "fastq": ["-t", "fastq", "-n", "300", "-e", "0.02", "-i", "0.2"],
    "fasta": ["-t", "fasta", "-n", "300", "-f"],
    "gam": ["-t", "gam", "-n", "300", "-e", "0.01"],
    "haplotypes": ["-t", "haplotypes", "-p", "3"],
    "paired": ["-n", "300", "-d", "500", "-s", "50", "-e", "0.01", "-N"],
    "paired_gam": ["-t", "gam", "-n", "100", "-d", "500", "-s", "50"],
}


@pytest.mark.parametrize("case", list(GGSIM))
def test_ggsim_matches_psi_tpu(data, case, capsys, monkeypatch, tmp_path):
    """Every output type, errors and paired ends at -S 7: the bytes
    psi_tpu's ggsim writes (the same RandomState draws in the same
    order)."""
    tmp, gfa, *_ = data
    monkeypatch.setenv("HOME", str(tmp_path))
    outs = [str(tmp_path / tag) for tag in "tj"]
    got, want = (_run(m.main, [gfa, "-o", out, "-S", "7", *GGSIM[case]],
                      capsys)
                 for m, out in zip((ggsim, jggsim), outs))
    assert got == want and got[0] == 0
    _same_files(*outs)
    size = os.path.getsize(outs[0])
    assert size > (30_000 if case == "haplotypes" else 100 * 100)


@pytest.mark.parametrize("k,n", [(8, 1), (8, 2), (20, 1), (20, 2)])
def test_nof_uncovered_kmers_matches_psi_tpu(data, k, n):
    tmp, gfa, *_ = data
    finder, jfinder = _finders(gfa, k, n)
    assert len(finder.get_starting_loci()) == len(jfinder.get_starting_loci())
    got = finder.nof_uncovered_kmers()
    assert got == jfinder.nof_uncovered_kmers() > 0
