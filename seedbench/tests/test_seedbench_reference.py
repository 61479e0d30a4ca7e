"""The plain reference against the program's CPU route, its control,
and the faults a run has to catch."""

import numpy as np
import pytest
import torch

from seedbench import harness, reference
from seedbench.entries import chunk_loop

CPU = torch.device("cpu")


@pytest.mark.parametrize("config,traffic,rate", [
    ("g1k_common", "exact", None), ("g1k_all", "exact", None),
    ("g1k_common", "mm1", None), ("g1k_common", "exact", 0.05)])
def test_program_cpu_route_matches_reference(tiny_cell, config, traffic,
                                             rate):
    cell = tiny_cell(config, traffic)
    if rate:
        cell.config["variant_rate"] = rate
    run = chunk_loop.run(cell, CPU)
    assert run.chunks and sum(c["hits_off"] for c in run.chunks) > 0
    assert run.checks == {"wrong_hits": [0, 0]}
    parts = run.check_parts
    assert parts["missing"] == parts["spurious"] == parts["malformed"] == 0
    assert parts["emitted"] >= parts["distinct"] > 0
    assert harness.result(run, {}, {})["correct"]


def test_control_breaks_exact_matching(tmp_path):
    """The control (seeds and walks compared on their first k - 1
    characters) reports hits the reference does not hold."""
    from seedbench import gen

    g0 = gen.make_pangenome_graph(20000, 0.02, seed=3)
    gfa = str(tmp_path / "g.gfa")
    gen.write_gfa(g0, gfa)
    reads = gen.draw_reads(gen.simulate_haplotypes(g0, 4, 5), 300, 100,
                           0.01, 9)
    g = reference.GfaGraph(gfa)
    coder = reference.HitCoder(g.chars, len(reads), 100)
    table = reference.WalkTable(g, 20, CPU)
    for mm in (0, 1):
        want = reference.chunk_hits(table, reads, mm, coder)
        ctrl = reference.chunk_hits(table, reads, mm, coder, prefix=1)
        missing, spurious = reference.compare(want, ctrl)
        assert missing == 0 and spurious > 0


def _faulty(monkeypatch, fault):
    from psi_tpu_torch.seed_finder import SeedFinder

    real = SeedFinder.seeds_all_arrays
    last = {}

    def broken(self, seeds, index, split=False):
        on, off = real(self, seeds, index, split=True)
        if fault == "half":
            on = on[on["read_id"] % 2 == 0]
            off = off[off["read_id"] % 2 == 0]
        elif fault == "altered":
            on = on.copy()
            # another seed of the same read: a well-formed, wrong hit
            on["read_offset"][0] = (on["read_offset"][0] + 20) % 100
        elif fault == "stale":
            out = last.get("prev", (on, off))
            last["prev"] = (on, off)
            on, off = out
        return on, off

    monkeypatch.setattr(SeedFinder, "seeds_all_arrays", broken)


@pytest.mark.parametrize("fault", ["half", "altered", "stale"])
def test_faults_make_the_run_incorrect(tiny_cell, monkeypatch, fault):
    """With the timed path broken underneath (half of a chunk's reads
    left out, an answer altered where it is produced, a step that hands
    back its previous state), the run comes out not correct."""
    _faulty(monkeypatch, fault)
    run = chunk_loop.run(tiny_cell(seconds=0.5), CPU)
    assert run.failed > 0 and run.checks["wrong_hits"][0] > 0
    assert run.check_parts["spurious" if fault == "altered" else "missing"]
    assert not harness.result(run, {}, {})["correct"]


def test_program_hits_flags_rows_naming_no_hit(tmp_path):
    from seedbench import gen

    g0 = gen.make_pangenome_graph(2000, 0.02, seed=1)
    gfa = str(tmp_path / "g.gfa")
    gen.write_gfa(g0, gfa)
    g = reference.GfaGraph(gfa)
    coder = reference.HitCoder(g.chars, 10, 100)
    cols = np.array([[1, 0, 100, 0],          # fine
                     [1, 0, 100, 5],          # offset starting no seed
                     [0, 0, 100, 0],          # no node 0
                     [1, 10 ** 6, 100, 0],    # past the node
                     [1, 0, 111, 0]])         # a read of another chunk
    got, bad = reference.program_hits(g, cols, 100, 10, 100, 20, coder, CPU)
    assert len(got) == 1 and bad == 4


def test_control_readings_on_a_tiny_cell(tiny_cell):
    """The control script's readings: nothing missing, hits spurious."""
    from seedbench import control

    r = control.readings(tiny_cell("g1k_common", "mm1"), CPU)
    assert r["missing"] == 0 and r["spurious"] > 0 and r["chunks"] == 2
    assert r["wrong_hits"] == r["spurious"]
