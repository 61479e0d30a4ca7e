"""The control of the output check: the plain reference put in the
program's place with one guarantee broken.

    python3 -m seedbench.control --workload NAME --seeds N [N ...]

For each seed it makes the cell's inputs as a run does and compares, for
every chunk of the pool, what the control reports with what the
reference reports, as a run's check does. The control matches a seed to
a walk on their first k - 1 characters only (with the traffic's
mismatches among them), breaking the configuration's guarantee that
every hit spells its seed. A sound check reads `wrong_hits` (missing
plus spurious) above its limit 0 on every seed. Runs on the card when
there is one; it does not run the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

from seedbench import harness, reference


def readings(cell, device) -> dict:
    from seedbench.entries.chunk_loop import Inputs

    cfg, tr = cell.config, cell.traffic
    with tempfile.TemporaryDirectory(prefix="seedbench-control-") as wd:
        inputs = Inputs(cfg, tr, cell.seed, wd)
        g = reference.GfaGraph(inputs.gfa)
    table = reference.WalkTable(g, cfg["seed_len"], device)
    coder = reference.HitCoder(g.chars, tr["chunk_reads"], tr["read_len"])
    missing = spurious = hits = 0
    for reads in inputs.chunks:
        want = reference.chunk_hits(table, reads, tr["mismatches"], coder)
        got = reference.chunk_hits(table, reads, tr["mismatches"], coder,
                                   prefix=1)
        m, s = reference.compare(want, got)
        missing, spurious, hits = missing + m, spurious + s, hits + len(want)
    return {"seed": cell.seed, "chunks": len(inputs.chunks),
            "reference_hits": hits, "wrong_hits": missing + spurious,
            "missing": missing, "spurious": spurious}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seedbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        cell = harness.load_cell(args.workload, seed, 0.0, time.monotonic())
        print(json.dumps({"workload": args.workload,
                          **readings(cell, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
