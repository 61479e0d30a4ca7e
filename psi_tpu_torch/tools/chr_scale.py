"""psi_tpu's chromosome-scale run on the port: a 100 Mbp, 4-component
synthetic pan-genome indexed and queried end to end, each stage timed.

The counterpart of psi_tpu's scripts/chr_scale_run.py, with its
constants, read draw and stages: a graph from
`simulate.make_pangenome_graph(REF_MBP * 1e6, VARIANT_RATE,
indel_frac=INDEL_FRAC, seed=GRAPH_SEED, n_components=N_COMPONENTS)`;
`create_path_index(n=N_PATHS, patched=True, context=CONTEXT,
step_size=STEP_SIZE, dmin=DMIN, dmax=DMAX)` (6 patched paths a region,
their loci and the distance index over a paired-end insert range);
error-free READ_LEN bp reads drawn by `RandomState(READS_SEED)` from the
concatenated node-label text, CHUNK of them a chunk; k = SEED_LEN. The
stages: graph_build, index_build, seeding, on_path_cold (the ftab, the
uploads and the kernels' first loads included), on_path_warm (a second
chunk), off_path_cold (the WalkTree's build, or the device traversal's
first steps, included), off_path_warm, each with its hits and seeds/s.

    python3 -m psi_tpu_torch.tools.chr_scale [ref_mbp] [n_reads] \\
        [--device cuda|cpu] [--json OUT]

It runs on the card unless `--device cpu` is given. `write_gfa` (from
tools/bacterial.py) and `write_fastq` give the same graph and reads to
the psikt CLI:

    psikt GFA -f FASTQ -l 30 -n 6 -t 30 -e 10 -m 300 -M 500 -c 20000
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from psi_tpu_torch.device import CHOICES
from psi_tpu_torch.tools.bacterial import write_gfa

REF_MBP = 100.0
VARIANT_RATE = 0.01
INDEL_FRAC = 0.2
GRAPH_SEED = 7
N_COMPONENTS = 4
SEED_LEN = 30
N_PATHS = 6
PATCHED = True
CONTEXT = 30
STEP_SIZE = 10
DMIN, DMAX = 300, 500
READ_LEN = 150
CHUNK = 20_000
READS_SEED = 11

#: the psikt flags of this configuration (`-c CHUNK` and the files aside)
CLI_FLAGS = ("-l", str(SEED_LEN), "-n", str(N_PATHS), "-t", str(CONTEXT),
             "-e", str(STEP_SIZE), "-m", str(DMIN), "-M", str(DMAX))


def make_graph(ref_mbp: float = REF_MBP):
    """The configuration's pan-genome graph."""
    from psi_tpu_torch.simulate import make_pangenome_graph

    return make_pangenome_graph(int(ref_mbp * 1e6), variant_rate=VARIANT_RATE,
                                indel_frac=INDEL_FRAC, seed=GRAPH_SEED,
                                n_components=N_COMPONENTS)


def make_finder(graph, device=None):
    """A SeedFinder at k = SEED_LEN on `device` (the card when None)."""
    from psi_tpu_torch.seed_finder import SeedFinder

    return SeedFinder(graph, seed_len=SEED_LEN,
                      **({} if device is None else {"device": device}))


def build_index(finder) -> None:
    """The configuration's path index: paths, FM index, loci, distance
    index."""
    finder.create_path_index(n=N_PATHS, patched=PATCHED, context=CONTEXT,
                             step_size=STEP_SIZE, dmin=DMIN, dmax=DMAX)


def label_text(graph) -> bytes:
    """The concatenated node-label text that the reads are drawn from."""
    return graph.labels.tobytes()


def draw_reads(text: bytes, n: int, rng: np.random.RandomState) -> list:
    """n error-free READ_LEN bp reads of `text`, one uniform start each,
    drawn as scripts/chr_scale_run.py draws them (one `randint` a read;
    the batched draw gives the same starts)."""
    starts = rng.randint(0, len(text) - READ_LEN, size=n)
    return [text[p:p + READ_LEN].decode("ascii") for p in starts]


def write_fastq(seqs, path: str) -> None:
    """Reads as FASTQ, named r0, r1, ..."""
    qual = b"I" * READ_LEN
    with open(path, "wb") as fh:
        for i, s in enumerate(seqs):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, s.encode("ascii"), qual))


def _records(seqs):
    from psi_tpu_torch.records import Records

    return Records([f"r{i}" for i in range(len(seqs))], seqs)


def run(ref_mbp: float = REF_MBP, n_reads: int = CHUNK, device=None,
        graph=None, finder=None, log=print) -> dict:
    """The staged run. A `graph` (this configuration's) skips
    graph_build; a `finder` over it with the index built or loaded skips
    index_build. Returns the stages' seconds, the hits, seeds and
    seeds/s, and the index's chars, nodes and loci."""
    t: dict = {}
    if graph is None:
        t0 = time.monotonic()
        graph = make_graph(ref_mbp)
        t["graph_build"] = time.monotonic() - t0
        log(f"graph: {graph.node_count} nodes, {t['graph_build']:.1f} s")
    if finder is None:
        finder = make_finder(graph, device)
        t0 = time.monotonic()
        build_index(finder)
        t["index_build"] = time.monotonic() - t0
    n_loci = len(finder.get_starting_loci())
    log(f"index: {t.get('index_build', 0.0):.1f} s ({finder.pindex.fm.size} "
        f"chars, {n_loci} uncovered loci)")

    text = label_text(graph)
    rng = np.random.RandomState(READS_SEED)
    t0 = time.monotonic()
    seeds = finder.get_seeds(_records(draw_reads(text, n_reads, rng)))
    index = finder.index_reads(seeds)
    t["seeding"] = time.monotonic() - t0

    res = {"stages": t, "nodes": int(graph.node_count),
           "chars": int(finder.pindex.fm.size), "loci": n_loci,
           "device": str(finder.device), "reads": n_reads}

    def timed(stage, fn, n_seeds):
        t0 = time.monotonic()
        arr = fn()
        t[stage] = time.monotonic() - t0
        n = 0 if arr is None else len(arr)
        res[stage] = {"s": t[stage], "hits": n, "seeds": n_seeds,
                      "seeds_per_s": n_seeds / t[stage]}
        log(f"{stage}: {t[stage]:.3f} s, {n} hits, {n_seeds} seeds, "
            f"{n_seeds / t[stage]:.0f} seeds/s")

    n1 = int(seeds.valid.sum())
    timed("on_path_cold", lambda: finder.seeds_on_paths_arrays(seeds, index),
          n1)
    # a fresh chunk of the same size, the draw continued
    seeds2 = finder.get_seeds(_records(draw_reads(text, n_reads, rng)))
    index2 = finder.index_reads(seeds2)
    n2 = int(seeds2.valid.sum())
    timed("on_path_warm",
          lambda: finder.seeds_on_paths_arrays(seeds2, index2), n2)
    timed("off_path_cold",
          lambda: finder.seeds_off_paths_arrays(seeds2, index2), n2)
    timed("off_path_warm",
          lambda: finder.seeds_off_paths_arrays(seeds, index), n1)
    res["total_s"] = sum(t.values())
    log("stages: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref_mbp", nargs="?", type=float, default=REF_MBP)
    ap.add_argument("n_reads", nargs="?", type=int, default=CHUNK)
    ap.add_argument("--device", choices=CHOICES, default="cuda")
    ap.add_argument("--json", default="", help="write the result here")
    args = ap.parse_args(argv)
    from psi_tpu_torch.device import resolve

    res = run(args.ref_mbp, args.n_reads, resolve(args.device))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(res, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
