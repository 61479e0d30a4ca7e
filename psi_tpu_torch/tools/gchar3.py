"""psi_tpu's human-pan-genome-scale run on the port: a GCHAR Gchar,
16-component synthetic pan-genome indexed, its distance index saved and
reloaded memory-mapped, and one chunk of reads queried, each stage timed.

The counterpart of psi_tpu's scripts/gchar3_run.py, with its constants,
stages, read draw and JSON keys: a graph from
`simulate.make_pangenome_graph(gchar * 1e9, 1 / VAR_BP,
indel_frac=INDEL_FRAC, seed=GRAPH_SEED, n_components=N_COMPONENTS)`;
`create_path_index(n=N_PATHS, patched=PSI_G3_PATCHED, context=CONTEXT,
step_size=STEP_SIZE, dmin=DMIN, dmax=DMAX)` (one path a region, not
patched by default, so every alternative allele is an uncovered locus;
above FMIndex.SA_DISK_MIN chars the suffix array is built in shards
spilled to PSI_SA_TMP or the temporary directory); `add_uncovered_loci()`
again at step 1, as the script calls it; the distance index saved
(columns past DistanceIndex.BIG_COL_BYTES to side files), reloaded
memory-mapped and held to the built one on N_PROBES random `verify`
pairs drawn by `RandomState(PROBE_SEED)`; N_READS error-free READ_LEN bp
reads drawn by `RandomState(READS_SEED)` from the node-label text,
seeded and indexed at k = SEED_LEN; then, below 2^31 indexed chars, the
on-path and off-path queries, and at or past it the script's
`query_note` and no query (device positions are int32).

Stages and keys: graph_gen, path_index, uncovered_loci, dindex_artifact,
seeding, read_index, on_path, off_path, each with `<stage>_s` and
`<stage>_peak_gb` (the process's peak RSS so far); nodes, fm_chars, loci,
dindex_intervals, dindex_artifact_mb, dindex_side_files, distinct_keys,
on_hits, off_hits or query_note, total_s and peak_gb. The port adds the
device, each stage's peak card memory (`<stage>_card_peak_mb`, on a
card), each kernel's launches in on_path and off_path
(`<stage>_launches`), the off-path route with the device traversal's
cap and attempts (`off_path_route`), on a card nvidia-smi's name and
power limit (`card`), and with `--warm` the chunk queried again (`warm`).

Two departures from the script: the artifact goes to `--workdir` (a new
temporary directory by default), not to a fixed /tmp/gchar3_dindex.npz,
and `--n-reads` sets the chunk's reads (the tests query fewer).

    python3 -m psi_tpu_torch.tools.gchar3 [gchar] [--n-reads N] \\
        [--device cuda|cpu] [--workdir DIR] [--json OUT] [--warm]

It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np

from psi_tpu_torch.device import CHOICES
from psi_tpu_torch.tools import chr_scale

GCHAR = 3.0
SEED_LEN = 30
DMIN, DMAX = 250, 450           # a paired-end library's insert range
VAR_BP = 1000                   # one bubble per ~1 kbp
INDEL_FRAC = 0.2
GRAPH_SEED = 7
N_COMPONENTS = 16
N_PATHS = 1
CONTEXT = SEED_LEN
STEP_SIZE = 10
N_READS = 100_000
READ_LEN = 150
READS_SEED = 11
PROBE_SEED = 5
N_PROBES = 200
#: a single index's query bound: device positions are int32
QUERY_MAX_CHARS = 1 << 31
QUERY_NOTE = ("fm_chars >= 2^31: single-index int32 device query bound; "
              "use the component-sharded mesh route")
ARTIFACT = "gchar3_dindex.npz"
#: the ops modules whose kernel wrappers count their launches
COUNTED_MODULES = ("fm_fused", "fm_stream", "fm_pallas", "traverse",
                   "dindex_probe")


def patched() -> bool:
    """PSI_G3_PATCHED, read as the script reads it: n=1 patched (the
    alternative alleles covered by patch paths, few loci) when set."""
    return os.environ.get("PSI_G3_PATCHED", "") not in ("", "0")


def rss_gb() -> float:
    """The process's peak resident set so far, in GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def launches() -> dict:
    """Every kernel wrapper's launch count, as `module.function`."""
    import importlib

    out = {}
    for mod in COUNTED_MODULES:
        m = importlib.import_module(f"psi_tpu_torch.ops.{mod}")
        for name, fn in vars(m).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                out[f"{mod}.{name}"] = fn.launches
    return out


def make_graph(gchar: float = GCHAR):
    """The configuration's pan-genome graph."""
    from psi_tpu_torch.simulate import make_pangenome_graph

    return make_pangenome_graph(int(gchar * 1e9), variant_rate=1.0 / VAR_BP,
                                indel_frac=INDEL_FRAC, seed=GRAPH_SEED,
                                n_components=N_COMPONENTS)


def make_finder(graph, device=None):
    """A SeedFinder at k = SEED_LEN on `device` (the card when None)."""
    from psi_tpu_torch.seed_finder import SeedFinder

    return SeedFinder(graph, seed_len=SEED_LEN,
                      **({} if device is None else {"device": device}))


def build_index(finder) -> None:
    """The configuration's path index: the path, FM index, loci every
    STEP_SIZE bp and the distance index."""
    finder.create_path_index(n=N_PATHS, patched=patched(), context=CONTEXT,
                             step_size=STEP_SIZE, dmin=DMIN, dmax=DMAX)


def draw_reads(graph, n_reads: int):
    """The chunk: n_reads READ_LEN bp reads of the label text by
    RandomState(READS_SEED) as chr_scale draws them (the two scripts draw
    alike, at the same length), named r0, r1, ..."""
    from psi_tpu_torch.records import Records

    seqs = chr_scale.draw_reads(chr_scale.label_text(graph), n_reads,
                                np.random.RandomState(READS_SEED))
    return Records([f"r{i}" for i in range(n_reads)], seqs)


def check_artifact(di, graph, workdir: str) -> dict:
    """Save the distance index into `workdir`, load it memory-mapped and
    hold N_PROBES random verify pairs of the two equal. Returns the
    artifact's MB and side files."""
    from psi_tpu_torch.dindex import DistanceIndex

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, ARTIFACT)
    di.save(path)
    di2 = DistanceIndex.load(path)
    rng = np.random.RandomState(PROBE_SEED)
    n = graph.node_count
    for _ in range(N_PROBES):
        v = int(rng.randint(1, n + 1))
        u = int(rng.randint(1, n + 1))
        if di.verify(graph, v, 0, u, 0) != di2.verify(graph, v, 0, u, 0):
            raise AssertionError("artifact probe mismatch")
    stem = ARTIFACT[:-len("npz")]
    side = sorted(f for f in os.listdir(workdir)
                  if f.startswith(stem) and f.endswith(".npy"))
    return {"dindex_artifact_mb": sum(
                os.path.getsize(os.path.join(workdir, f))
                for f in [ARTIFACT] + side) / 1e6,
            "dindex_side_files": side}


def warm_query(finder, seeds, index, card) -> dict:
    """The chunk queried again, the index's device arrays and the
    off-path route's tables built: each route's seconds and hits, and
    the seeds per second of the two."""
    import torch

    out = {}
    for name, fn in (("on_path", finder.seeds_on_paths_arrays),
                     ("off_path", finder.seeds_off_paths_arrays)):
        t0 = time.monotonic()
        arr = fn(seeds, index)
        if card is not None:
            torch.cuda.synchronize(card)
        out[name + "_s"] = time.monotonic() - t0
        out[name + "_hits"] = 0 if arr is None else len(arr)
    out["seeds"] = int(seeds.valid.sum())
    out["seeds_per_s"] = out["seeds"] / (out["on_path_s"] + out["off_path_s"])
    return out


def run(gchar: float = GCHAR, n_reads: int = N_READS, device=None,
        workdir: str | None = None, out_json: str | None = None,
        graph=None, keep: dict | None = None, warm: bool = False,
        log=print) -> dict:
    """The staged run; returns the script's JSON record and the port's
    keys. A `graph` (this configuration's at `gchar`) skips graph_gen's
    generation (it is still timed). `keep`, a dict, receives the graph,
    the finder, the reads, the seeds, their index and the cold query's
    on-path and off-path hits (`on`, `off`). `warm` queries the
    chunk a second time (`warm`: seconds, hits and seeds/s)."""
    import torch

    res = {"gchar": gchar, "dmin": DMIN, "dmax": DMAX, "k": SEED_LEN,
           "var_bp": VAR_BP}
    card = None

    def stage(name, fn):
        if card is not None:
            torch.cuda.reset_peak_memory_stats(card)
        before = launches()
        t0 = time.monotonic()
        out = fn()
        if card is not None:
            torch.cuda.synchronize(card)
        res[name + "_s"] = time.monotonic() - t0
        res[name + "_peak_gb"] = rss_gb()
        if card is not None:
            res[name + "_card_peak_mb"] = (
                torch.cuda.max_memory_allocated(card) / 1e6)
        if name in ("on_path", "off_path"):
            res[name + "_launches"] = {
                k: v - before[k] for k, v in launches().items()}
        log(f"[{time.strftime('%H:%M:%S')}] {name}: {res[name + '_s']:.1f} s "
            f"(peak {res[name + '_peak_gb']:.2f} GB)")
        if out_json:
            with open(out_json, "w") as fh:
                json.dump(res, fh, indent=1)
        return out

    graph = stage("graph_gen", lambda: graph if graph is not None
                  else make_graph(gchar))
    res["nodes"] = int(graph.node_count)
    finder = make_finder(graph, device)
    res["device"] = str(finder.device)
    if finder.device.type == "cuda":
        from psi_tpu_torch.tools.timing import card_line

        card = finder.device
        res["card"] = card_line()
    res["patched"] = patched()
    stage("path_index", lambda: build_index(finder))
    res["fm_chars"] = int(finder.pindex.fm.size)
    stage("uncovered_loci", finder.add_uncovered_loci)
    res["loci"] = len(finder.get_starting_loci())

    di = finder.dindex
    if di is not None and not di.empty:
        res["dindex_intervals"] = len(di.dst)
        with tempfile.TemporaryDirectory(prefix="gchar3_") as tmp:
            res.update(stage("dindex_artifact",
                             lambda: check_artifact(di, graph, workdir or tmp)))

    reads = draw_reads(graph, n_reads)
    seeds = stage("seeding", lambda: finder.get_seeds(reads))
    index = stage("read_index", lambda: finder.index_reads(seeds))
    res["distinct_keys"] = len(np.unique(index.sorted_keys))
    if finder.pindex.fm.size < QUERY_MAX_CHARS:
        on = stage("on_path", lambda: finder.seeds_on_paths_arrays(seeds,
                                                                   index))
        res["on_hits"] = 0 if on is None else len(on)
        off = stage("off_path", lambda: finder.seeds_off_paths_arrays(seeds,
                                                                      index))
        res["off_hits"] = 0 if off is None else len(off)
        res["off_path_route"] = finder.offpath_route()
        if warm:
            res["warm"] = warm_query(finder, seeds, index, card)
            log(f"warm query: {res['warm']}")
    else:
        on = off = None
        res["query_note"] = QUERY_NOTE

    res["total_s"] = sum(v for k, v in res.items() if k.endswith("_s"))
    res["peak_gb"] = rss_gb()
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(res, fh, indent=1)
    if keep is not None:
        keep.update(graph=graph, finder=finder, reads=reads, seeds=seeds,
                    index=index, on=on, off=off)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gchar", nargs="?", type=float, default=GCHAR)
    ap.add_argument("--n-reads", type=int, default=N_READS)
    ap.add_argument("--device", choices=CHOICES, default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="where the distance-index artifact goes (default: "
                    "a new temporary directory)")
    ap.add_argument("--json", default="", help="write the result here, "
                    "after every stage")
    ap.add_argument("--warm", action="store_true",
                    help="query the chunk a second time, warm")
    args = ap.parse_args(argv)
    from psi_tpu_torch.device import resolve

    res = run(args.gchar, args.n_reads, resolve(args.device), args.workdir,
              args.json or None, warm=args.warm)
    print(json.dumps(res, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
