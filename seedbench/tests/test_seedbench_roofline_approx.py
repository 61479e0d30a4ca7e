"""range_refine4's roofline count against a brute-force enumeration, and
the new cell's readers on a tiny traced run on the CPU."""

import numpy as np
import pytest
import torch

from seedbench import harness, reference, roofline_approx

CPU = torch.device("cpu")
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
#: a fork (node 2 against 3) whose second allele is a 1 bp insertion
GFA = ("S\t1\tACGTA\nS\t2\tC\nS\t3\tGT\nS\t4\tTTGCA\nS\t5\tAC\n"
       "L\t1\t+\t2\t+\t0M\nL\t1\t+\t3\t+\t0M\nL\t2\t+\t4\t+\t0M\n"
       "L\t3\t+\t4\t+\t0M\nL\t4\t+\t5\t+\t0M\n")


def _key(s: str) -> int:
    return sum(CODE[c] << 2 * (len(s) - 1 - i) for i, c in enumerate(s))


def _walks(g, start: int, n: int) -> list:
    """Every walk of n characters from character `start`, as strings."""
    text = "".join("ACGT"[c] for c in g.codes)

    def nxt(i):
        if not g.is_end[i]:
            return [i + 1]
        node = g.node_of[i]
        return list(g.out_first[g.out_ptr[node]:g.out_ptr[node + 1]])

    paths = [[start]]
    for _ in range(n - 1):
        paths = [p + [j] for p in paths for j in nxt(p[-1])]
    return ["".join(text[i] for i in p) for p in paths]


def _brute_live(g, loci, seeds, k, mismatches) -> list:
    live = []
    for t in range(k):
        prefixes = {s[:t] for s in seeds}
        live.append(sum(
            sum(a != b for a, b in zip(p, w[:t])) <= mismatches
            for locus in loci for w in _walks(g, locus, t + 1)
            for p in prefixes))
    return live


@pytest.mark.parametrize("mismatches", [0, 1, 2])
def test_live_rows_match_brute_force(tmp_path, mismatches):
    gfa = tmp_path / "g.gfa"
    gfa.write_text(GFA)
    g = reference.GfaGraph(str(gfa))
    k = 6
    # walks through both alleles, one with a substitution, and strays
    seeds = ["ACGTAC", "CGTAGT", "GTACTT", "TAGTTT", "AGTTGC", "TTTGCA",
             "CCCCCC", "GTAGTA", "ACGAAC"]
    loci = [0, 1, 2, 3, 4, 6, 9]
    live = roofline_approx.live_rows(
        g, np.array(loci), np.array([_key(s) for s in seeds]), k,
        mismatches, CPU)
    want = _brute_live(g, loci, seeds, k, mismatches)
    assert live == want
    assert live[0] == len(loci) and len(live) == k
    b, o = roofline_approx.range_refine4_work(live)
    assert (b, o) == (40.0 * sum(want), 58.0 * sum(want))


def test_live_rows_of_no_locus_are_zero(tmp_path):
    gfa = tmp_path / "g.gfa"
    gfa.write_text(GFA)
    g = reference.GfaGraph(str(gfa))
    assert roofline_approx.live_rows(
        g, np.zeros(0, dtype=np.int64), np.array([_key("ACGTAC")]), 6, 1,
        CPU) == [0] * 6


def test_mm1_cell_readers_on_a_tiny_traced_run(tiny_cell, tmp_path):
    """Every per-layer metric the new cell lists reads the program's
    store on a tiny traced CPU run; the readers of a kernel's device time,
    which a CPU trace lacks, are then silent."""
    from seedbench import trace
    from seedbench.entries import chunk_loop

    cell = tiny_cell("g1k_common_mm1", "mm1")
    run = chunk_loop.run(cell, CPU, str(tmp_path))
    run.trace = trace.reduce(run.trace_path)
    metrics = harness.metrics_of(harness.load_spec(), "g1k_common.mm1", True)
    got = {m["name"]: harness.reader(m["name"])(run) for m in metrics}
    assert {"approx_slots", "range_refine4_roofline_pct", "plan_keys_ms",
            "onpath_keys_ms", "offpath_fetch_ms",
            "traverse_retries"} <= set(got)
    for m in metrics:
        if m["source"] in ("program_span", "program_counter"):
            assert got[m["name"]] is not None, m["name"]
    assert got["approx_slots"] > 0
    assert got["plan_keys_ms"] > 0 and got["onpath_keys_ms"] > 0
    assert got["range_refine4_roofline_pct"] is None
    assert got["trie_level_roofline_pct"] is None


def test_mm1_config_is_the_common_graph_with_one_substitution():
    """The new cell's configuration holds every number of g1k_common, cuts
    the same key, and states the one substitution its traffic runs."""
    spec = harness.load_spec()
    cell = harness.load_cell("g1k_common.mm1", 1, 1.0, 0.0, spec)
    base = harness.load_cell("g1k_common.exact", 1, 1.0, 0.0, spec).config
    for key, value in base.items():
        if isinstance(value, (int, float)):
            assert cell.config[key] == value, key
    assert cell.config["reduced"] == base["reduced"]
    assert cell.config["mismatches"] == cell.traffic["mismatches"] == 1
    sources = {c["name"]: c["source"] for c in spec["configs"]}
    assert sources["g1k_common_mm1"] != sources["g1k_common"]


def test_exact_cell_readers_of_the_ball_are_silent(tiny_cell, tmp_path):
    """On exact seeds the program counts no approx-slots: the new reader
    returns None rather than 0."""
    from seedbench.entries import chunk_loop

    run = chunk_loop.run(tiny_cell("g1k_common", "exact"), CPU)
    assert harness.reader("approx_slots")(run) is None


def test_brute_force_walks_take_both_alleles(tmp_path):
    gfa = tmp_path / "g.gfa"
    gfa.write_text(GFA)
    g = reference.GfaGraph(str(gfa))
    assert sorted(_walks(g, 3, 4)) == ["TACT", "TAGT"]
    assert _walks(g, 6, 3) == ["GTT"]
