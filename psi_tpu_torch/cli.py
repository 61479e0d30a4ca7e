"""psikt on PyTorch: the seed-finding CLI with `--device {cuda,cpu}`.

Same flags, chunk loop and output as psi_tpu.cli (raw little-endian int64
quadruples (node_id, node_offset, read_id, read_offset) per hit), with
this package's SeedFinder. `--device cuda` runs the CUDA kernels and
raises without a GPU; `--device cpu` runs their plain PyTorch versions.
The on-path route is the trie chain, planned on the producer thread
(`SeedFinder.prepare_onpath`) and located on the device. `-m/-M`
build the distance index over the insert-size range (on `--device` under
PSI_DINDEX_BUILD=device); with `-I PREFIX` it is saved as
PREFIX_dist_mat_m{dmin}M{dmax}.npz beside the path index and loaded from
there by later runs, as psi_tpu does. `--devices N|auto` (default:
every visible card on cuda, one device on the CPU; PSI_DEVICES too)
shards the query over a mesh of that many devices of `--device`'s type
(psi_tpu_torch/parallel): `--device cpu --devices 2` runs it on two
virtual shards of the CPU.

    python -m psi_tpu_torch.cli GRAPH -f READS -l 20 -n 2 -P -c 100000 \\
        --device cuda -o hits.bin [--report report.json]

The report is psi_tpu's JSON schema plus "device", "build" (the
seconds of the graph's parse and of each host stage of the index's build
or load, the ftab's included), "offpath" (the off-path route taken: the
WalkTree with its node count, or the device traversal with its last
chunk's final cap and attempts) and "chunks": one
record per chunk with its read, seed and distinct-key counts, on-path
and off-path hits and seconds, the producer's parse + seed + index
seconds (`produce_s`), the trie plan's seconds on the prepare thread
(`prepare_s`), how long the query waited for that plan, `t_done_s`,
the time from the start of seed finding to that chunk's hits being
written, and from the program's span store (stats.py) the chunk's
seconds by stage (`spans`: seeding, index-reads, prepare-onpath and its
plan-keys / plan-schedule / plan-upload, seeds-on-paths and its
onpath-keys / onpath-trie / onpath-locate / onpath-join, seeds-off-path
and its offpath-fetch / offpath-columns) and its `counters` (h2d-bytes
and d2h-bytes copied, plan-device-keys: the keys whose plan the card
built, traverse-retries; with --mismatches plan-ball-keys, the plan's
distinct search keys, approx-slots, k x the state cap of each
approximate traversal attempt: the rows range_refine4 runs over,
approx-step-launches, the launches of the approximate traversal's step
kernel on the card (k an attempt; none on the CPU), and from
--mismatches 2 ball-dedup-rows, the Hamming balls' rows sorted to drop
repeats, which a ball of one mismatch does not hold).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional

import numpy as np

from psi_tpu_torch.device import CHOICES

log = logging.getLogger("psikt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="psikt-torch",
        description="Pan-genome seed finder (PSI) on PyTorch + CUDA.",
    )
    p.add_argument("graph", metavar="GRAPH_FILE", help="graph file (vg or gfa)")
    p.add_argument("-f", "--fastq", required=True, help="reads in FASTQ format")
    p.add_argument("-o", "--output", default="out.gam", help="output file")
    p.add_argument("-I", "--path-index", default="", help="path index prefix")
    p.add_argument("-l", "--seed-length", type=int, required=True)
    p.add_argument(
        "-c", "--chunk-size", type=int, default=0,
        help="reads chunk size (0 = all reads as one chunk)",
    )
    p.add_argument(
        "-e", "--step-size", type=int, default=1,
        help="min approximate distance between consecutive starting loci",
    )
    p.add_argument(
        "-d", "--distance", type=int, default=0,
        help="distance between seeds (default: seed length)",
    )
    p.add_argument(
        "-n", "--path-num", type=int, default=0,
        help="number of paths included in the path index",
    )
    p.add_argument(
        "-P", "--no-patched", action="store_true",
        help="use full genome-wide paths",
    )
    p.add_argument("-t", "--context", type=int, default=0, help="patching context")
    p.add_argument(
        "-r", "--gocc-threshold", type=int, default=0,
        help="seed genome occurrence count threshold",
    )
    p.add_argument(
        "-E", "--max-mem", type=int, default=0,
        help="maximum number of MEMs on paths",
    )
    p.add_argument("-m", "--min-insert-size", type=int, default=0)
    p.add_argument("-M", "--max-insert-size", type=int, default=0)
    p.add_argument(
        "--dindex-mode", choices=["per-component", "whole"],
        default="per-component",
    )
    p.add_argument(
        "-i", "--index", default="WOTD",
        choices=["SA", "ESA", "WOTD", "DFI", "QGRAM", "FM"],
        help="reads-side index type (accepted for compatibility; the "
        "engine always uses the sorted packed k-mer index)",
    )
    p.add_argument("-x", "--index-only", action="store_true")
    p.add_argument("-L", "--log-file", default="psi.log")
    p.add_argument("-Q", "--no-log-file", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-C", "--no-color", action="store_true")
    p.add_argument("-D", "--disable-log", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "--mismatches", type=int, default=0,
        help="allowed mismatches per seed (extension: the reference "
        "declares but never implements approximate matching)",
    )
    p.add_argument(
        "--device", choices=CHOICES, default="cuda",
        help="cuda runs the CUDA kernels (and fails without a GPU); cpu "
        "runs their plain PyTorch versions",
    )
    p.add_argument(
        "--devices", default=None, metavar="N|auto",
        help="device-mesh width for the sharded query pipeline: a "
        "count, or 'auto' for all local devices (default: all devices "
        "on accelerator backends, 1 on CPU; also via PSI_DEVICES)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="resume an interrupted run from <output>.ckpt (skips already "
        "processed read chunks; requires identical arguments)",
    )
    p.add_argument(
        "--report", default="",
        help="write an end-of-run JSON metrics report",
    )
    return p


def setup_logging(args):
    handlers = []
    if not args.quiet:
        handlers.append(logging.StreamHandler(sys.stderr))
    if not args.no_log_file and not args.disable_log:
        handlers.append(logging.FileHandler(args.log_file))
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s",
        handlers=handlers if not args.disable_log else [logging.NullHandler()],
    )


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args)

    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.io.fastq import FastxStream
    from psi_tpu_torch.records import Records
    from psi_tpu_torch.stats import SeedFinderStats, Timer, chunk_totals
    from psi_tpu_torch.device import resolve
    from psi_tpu_torch.seed_finder import SeedFinder

    device = resolve(args.device)
    # the timers are process-global: a run reports its own time only
    Timer.reset_all()
    stats = SeedFinderStats()
    SeedFinderStats.track(stats)
    SeedFinderStats.install_signal_handler()

    t0 = time.monotonic()
    log.info("Loading input graph from '%s'...", args.graph)
    graph = load_graph(args.graph)
    graph_load_s = time.monotonic() - t0
    log.info(
        "Loaded the graph in %.3fs (%d nodes, %d edges, %d paths).",
        graph_load_s, graph.node_count, graph.edge_count,
        graph.get_path_count(),
    )

    finder = SeedFinder(
        graph,
        args.seed_length,
        gocc_threshold=args.gocc_threshold,
        max_mem=args.max_mem,
        seed_mismatches=args.mismatches,
        stats=stats,
        devices=args.devices,
        device=device,
    )
    log.info("Query device: %s.", device)

    loaded = False
    if args.path_index:
        log.info("Opening path index '%s'...", args.path_index)
        loaded = finder.load_path_index(
            args.path_index, args.context, args.step_size,
            args.min_insert_size, args.max_insert_size,
        )
        if loaded:
            log.info("Path index loaded.")
        else:
            log.info("No valid path index found; creating...")
    if not loaded:
        finder.create_path_index(
            args.path_num,
            not args.no_patched,
            args.context,
            args.step_size,
            args.min_insert_size,
            args.max_insert_size,
            per_component=(args.dindex_mode == "per-component"),
        )
        log.info("Picked paths in %.3fs.", Timer.get_duration_ts("pick-paths"))
        if args.path_index:
            log.info("Saving path index...")
            if not finder.serialize_path_index(args.path_index, args.step_size):
                log.warning("Specified path index file is not writable. Skipping...")

    log.info(
        "Number of starting loci (in %d nodes of total %d): %d",
        finder.get_nof_uniq_nodes(), graph.node_count,
        len(finder.get_starting_loci()),
    )

    if args.index_only:
        log.info("Skipping seed finding as requested...")
        return 0

    found = 0
    covered_reads = set()
    n_chunks = 0
    chunk_records = []

    # checkpoint/resume: deterministic restart from serialized indexes +
    # read offset
    ckpt_path = args.output + ".ckpt"
    resume_reads = 0
    resume_bytes = 0
    if args.resume and os.path.exists(ckpt_path):
        with open(ckpt_path) as fh:
            ck = json.load(fh)
        resume_reads = ck.get("reads_consumed", 0)
        resume_bytes = ck.get("bytes_written", 0)
        found = ck.get("found", 0)
        log.info(
            "Resuming after %d reads (%d bytes of hits).",
            resume_reads, resume_bytes,
        )
    if resume_bytes and os.path.exists(args.output):
        out = open(args.output, "r+b")
        out.truncate(resume_bytes)
        out.seek(resume_bytes)
    else:
        resume_reads = 0
        resume_bytes = 0
        out = open(args.output, "wb")

    log.info("Finding seeds...")
    stream = FastxStream(args.fastq)
    while stream.counts() < resume_reads:
        skip = min(
            resume_reads - stream.counts(),
            args.chunk_size or resume_reads,
        )
        if not stream.read_chunk(skip)[0]:
            break
    t_find = time.monotonic()

    # host pipeline: a producer thread parses the next chunk, builds its
    # k-mer index and (in a one-thread pool) its trie plan and upload,
    # while this thread queries the current chunk
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    work_q: "queue.Queue" = queue.Queue(maxsize=2)
    prep_pool = ThreadPoolExecutor(max_workers=1)

    def timed_prepare(index):
        t = time.monotonic()
        finder.prepare_onpath(index)
        return time.monotonic() - t

    def producer():
        try:
            while True:
                t = time.monotonic()
                offset = stream.counts()
                names, packed = stream.read_chunk_packed(args.chunk_size)
                if not names:
                    work_q.put(None)
                    return
                chunk = Records(names, rec_offset=offset, packed=packed)
                seeds = finder.get_seeds(chunk, args.distance)
                index = finder.index_reads(seeds)
                produce_s = time.monotonic() - t
                fut = prep_pool.submit(timed_prepare, index)
                work_q.put((chunk, seeds, index, fut, produce_s))
                if args.chunk_size == 0:
                    work_q.put(None)
                    return
        except BaseException as exc:
            # hand the failure to the consumer, which re-raises it
            work_q.put(exc)
            raise

    threading.Thread(target=producer, daemon=True).start()

    def timer_s(name):
        return Timer.get_duration_ts(name)

    try:
        while True:
            item = work_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            chunk, seeds, index, prep_fut, produce_s = item
            log.info(
                "Fetched %d reads with total length of %dbp (%d seeds).",
                len(chunk), chunk.length_sum(), len(seeds),
            )
            t_wait = time.monotonic()
            prepare_s = prep_fut.result()  # on-path plan built off-thread
            t_q = time.monotonic()
            on0, off0 = timer_s("seeds-on-paths"), timer_s("seeds-off-path")
            on_hits, off_hits = finder.seeds_all_arrays(seeds, index,
                                                        split=True)
            t_end = time.monotonic()
            hits = np.concatenate([on_hits, off_hits])
            found += len(hits)
            n_chunks += 1
            covered_reads.update(np.unique(hits["read_id"]).tolist())
            # bulk binary write of (node_id, node_offset, read_id,
            # read_offset); hits on reverse twins of node-doubled
            # bidirected inputs carry the NEGATED original node id
            cols = np.empty((len(hits), 4), dtype="<i8")
            if graph.rc_base:
                fwd, rev = graph.forward_strand(hits["node_id"])
                cols[:, 0] = np.where(rev, -fwd, fwd)
            else:
                cols[:, 0] = hits["node_id"]
            cols[:, 1] = hits["node_offset"]
            cols[:, 2] = hits["read_id"]
            cols[:, 3] = hits["read_offset"]
            cols.tofile(out)
            out.flush()
            rec = {
                "reads": len(chunk),
                "seeds": int(index.size),
                "keys": _distinct(index.sorted_keys),
                "hits_on": int(len(on_hits)),
                "hits_off": int(len(off_hits)),
                "produce_s": produce_s,
                "prepare_s": prepare_s,
                "prep_wait_s": t_q - t_wait,
                "query_s": t_end - t_q,
                "onpath_s": timer_s("seeds-on-paths") - on0,
                "offpath_s": timer_s("seeds-off-path") - off0,
                "t_done_s": time.monotonic() - t_find,
            }
            rec["spans"], rec["counters"] = chunk_totals(chunk.rec_offset)
            chunk_records.append(rec)
            log.info(
                "Chunk %d: %d on-path + %d off-path hits; on-path %.3fs, "
                "off-path %.3fs.", n_chunks, rec["hits_on"],
                rec["hits_off"], rec["onpath_s"], rec["offpath_s"],
            )
            with open(ckpt_path, "w") as fh:
                json.dump(
                    {
                        "reads_consumed": chunk.rec_offset + len(chunk),
                        "bytes_written": out.tell(),
                        "found": found,
                    },
                    fh,
                )
    finally:
        out.close()
        prep_pool.shutdown(wait=True)
    if os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # clean finish

    log.info("Found seeds in %.3fs.", time.monotonic() - t_find)
    log.info("Total number of seeds found: %d", found)
    log.info("Number of reads covered by seeds: %d", len(covered_reads))
    for name, timer in sorted(Timer.get_timers().items()):
        log.info("%s time: %.3fs", name, timer.lap())

    if args.report:
        _write_report(args, finder, graph, found, covered_reads, n_chunks)
        with open(args.report) as fh:
            report = json.load(fh)
        report["device"] = str(device)
        report["build"] = _build_times(graph_load_s)
        report["offpath"] = finder.offpath_route()
        report["chunks"] = chunk_records
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=2)
    return 0


def _distinct(sorted_keys: np.ndarray) -> int:
    """Distinct values of a sorted key array: the chunk's k-mer queries."""
    if not len(sorted_keys):
        return 0
    return int(np.count_nonzero(sorted_keys[1:] != sorted_keys[:-1])) + 1


#: the index's host stages, by the timers that SeedFinder runs them under
BUILD_TIMERS = {
    "pick_paths_s": ("pick-paths",), "index_paths_s": ("index-paths",),
    "loci_s": ("find-uncovered",), "dindex_s": ("index-distances",),
    "save_s": ("save-pindex", "save-starts", "save-dindex"),
    "load_s": ("load-pindex", "load-starts", "load-dindex"),
    "ftab_s": ("build-ftab",),
}


def _build_times(graph_load_s: float) -> dict:
    """Seconds of each host stage of the index's build (or load), the
    graph's parse first."""
    from psi_tpu_torch.stats import Timer

    return {"graph_load_s": graph_load_s,
            **{key: sum(Timer.get_duration_ts(n) for n in names)
               for key, names in BUILD_TIMERS.items()}}


def _write_report(args, finder, graph, found, covered_reads, n_chunks):
    """End-of-run metrics in the reference's benchmark schema
    (field list per script/parse2csv_psikt_config.yaml)."""
    import json as _json

    from psi_tpu_torch.stats import Timer

    def t(name):
        total = 0.0
        for tname, timer in Timer.get_timers().items():
            if tname.startswith(name):
                total += timer.lap()
        return round(total, 4)

    report = {
        "dataset": args.graph,
        "seedlen": args.seed_length,
        "distance": args.distance or args.seed_length,
        "pathno": args.path_num,
        "patched": not args.no_patched,
        "context": finder.pindex.get_context(),
        "readsindex": "sorted-kmer",
        "chunksize": args.chunk_size,
        "stepsize": args.step_size,
        "pathpicktime": t("pick-paths"),
        "pathindextime": t("index-paths"),
        "pathsavetime": t("save-pindex"),
        "pindexsize": int(finder.pindex.fm.size) if finder.pindex.fm else 0,
        "locino": len(finder.get_starting_loci()),
        "uniqnodes": finder.get_nof_uniq_nodes(),
        "totalnodes": graph.node_count,
        "pathquerytimeperchunk": round(
            t("seeds-on-paths") / max(1, n_chunks), 4
        ),
        "traversetimeperchunk": round(
            t("seeds-off-path") / max(1, n_chunks), 4
        ),
        "seedhits": found,
        "coveredreads": len(covered_reads),
        # traversal counters (ref: TraverserStats fed end-of-run report,
        # psikt.cpp:59-80)
        "godowns": finder.stats.get_this_thread_stats().godowns,
        "traversedpaths": finder.stats.get_this_thread_stats().paths_traversed,
        "avgpathlen": round(
            finder.stats.get_this_thread_stats().avg_pathlen(), 2
        ),
    }
    with open(args.report, "w") as fh:
        _json.dump(report, fh, indent=2)


if __name__ == "__main__":
    sys.exit(main())
