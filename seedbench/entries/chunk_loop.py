"""psikt's exact chunk pipeline, driven for a fixed time.

The three-stage loop of psi_tpu_torch/cli.py (the CLI cannot be driven
for a fixed time, and writes every hit to disk): a producer thread
parses a chunk (`FastxStream.read_chunk_packed`) and calls
`SeedFinder.get_seeds` and `index_reads`; a one-thread pool runs
`SeedFinder.prepare_onpath`; the main thread waits for that plan, runs
`seeds_all_arrays(seeds, index, split=True)` and builds the hit columns,
which are kept in memory. The queue holds 2 chunks. A closed loop with
one client: the next chunk is taken as soon as the queue has room.

Set-up (timed as setup_s): the graph, haplotypes and a pool of chunks
drawn from the seed and written as GFA and FASTQ, the GFA's load,
`create_path_index`, and the first warm chunks, which build the prefix
table and the off-path WalkTree (or find it over its cap). Then the
window: chunks cycle through the pool, read ids offset so that each pass
is new reads, until the first chunk that completes `seconds` after the
window opened. Then the loop stops, the card's peak is read, the
program's state is freed, and every chunk completed in the window is
compared with the plain reference (reference.py).
"""

from __future__ import annotations

import contextlib
import gc
import os
import queue
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from seedbench import gen, reference
from seedbench.harness import Run

#: chunks run before the window: the first builds the prefix table and
#: the WalkTree (or finds it over its cap), the second runs warm
WARM_CHUNKS = 2


class Inputs:
    """A run's inputs, made from its seed in a directory of their own:
    the graph (its GFA) and the pool of chunks, each its own FASTQ."""

    def __init__(self, config: dict, traffic: dict, seed: int, workdir: str):
        gseed, hseed, rseed = gen.derive_seeds(seed)
        graph = gen.make_pangenome_graph(
            config["ref_len"], config["variant_rate"], config["indel_frac"],
            seed=gseed)
        self.gfa = os.path.join(workdir, "pangenome.gfa")
        gen.write_gfa(graph, self.gfa)
        haps = gen.simulate_haplotypes(graph, config["haplotypes"], hseed)
        n, pool = traffic["chunk_reads"], traffic["pool_chunks"]
        reads = gen.draw_reads(haps, n * pool, traffic["read_len"],
                               traffic["error_rate"], rseed)
        self.chunks = [reads[i * n:(i + 1) * n] for i in range(pool)]
        self.fastq = []
        for i, r in enumerate(self.chunks):
            path = os.path.join(workdir, f"chunk{i}.fastq")
            gen.write_fastq(r, path)
            self.fastq.append(path)


def _timer(name: str) -> float:
    from psi_tpu_torch.stats import Timer

    return Timer.get_duration_ts(name)


class Pipeline:
    """The CLI's loop over the pool: `next()` completes one chunk and
    returns its record and hit columns; `close()` stops the producer and
    waits for every thread."""

    def __init__(self, finder, inputs: Inputs, traffic: dict):
        self.finder, self.inputs = finder, inputs
        self.n = traffic["chunk_reads"]
        self.rc = bool(finder.graph.rc_base)
        self.q: queue.Queue = queue.Queue(maxsize=2)
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._produce, daemon=True)
        self.leg = _no_leg
        self.thread.start()

    def _prepare(self, index):
        t = time.monotonic()
        self.finder.prepare_onpath(index)
        return time.monotonic() - t

    def _produce(self):
        from psi_tpu_torch.io.fastq import FastxStream
        from psi_tpu_torch.records import Records

        try:
            j = 0
            while not self.stop.is_set():
                t = time.monotonic()
                pool_i = j % len(self.inputs.fastq)
                names, packed = FastxStream(
                    self.inputs.fastq[pool_i]).read_chunk_packed(self.n)
                chunk = Records(names, rec_offset=j * self.n, packed=packed)
                seeds = self.finder.get_seeds(chunk)
                index = self.finder.index_reads(seeds)
                produce_s = time.monotonic() - t
                fut = self.pool.submit(self._prepare, index)
                self.q.put((j, pool_i, t, chunk, seeds, index, fut, produce_s))
                j += 1
        except BaseException as exc:
            self.q.put(exc)
            raise
        self.q.put(None)

    def next(self):
        with self.leg("wait_chunk"):
            item = self.q.get()
        if isinstance(item, BaseException):
            raise item
        j, pool_i, t_take, chunk, seeds, index, fut, produce_s = item
        t_wait = time.monotonic()
        with self.leg("wait_plan"):
            prepare_s = fut.result()
        t_q = time.monotonic()
        on0, off0 = _timer("seeds-on-paths"), _timer("seeds-off-path")
        with self.leg("query"):
            on_hits, off_hits = self.finder.seeds_all_arrays(
                seeds, index, split=True)
        t_end = time.monotonic()
        with self.leg("columns"):
            hits = np.concatenate([on_hits, off_hits])
            cols = np.empty((len(hits), 4), dtype="<i8")
            if self.rc:
                fwd, rev = self.finder.graph.forward_strand(hits["node_id"])
                cols[:, 0] = np.where(rev, -fwd, fwd)
            else:
                cols[:, 0] = hits["node_id"]
            cols[:, 1] = hits["node_offset"]
            cols[:, 2] = hits["read_id"]
            cols[:, 3] = hits["read_offset"]
        t_done = time.monotonic()
        keys = index.sorted_keys
        rec = {
            "chunk": j, "pool": pool_i, "reads": len(chunk),
            "keys": (int(np.count_nonzero(keys[1:] != keys[:-1])) + 1
                     if len(keys) else 0),
            "hits": len(hits), "hits_on": len(on_hits),
            "hits_off": len(off_hits), "t_take": t_take, "t_done": t_done,
            "produce_s": produce_s, "prepare_s": prepare_s,
            "prep_wait_s": t_q - t_wait, "query_s": t_end - t_q,
            "onpath_s": _timer("seeds-on-paths") - on0,
            "offpath_s": _timer("seeds-off-path") - off0,
        }
        return rec, cols

    def close(self):
        self.stop.set()
        while True:
            try:
                item = self.q.get(timeout=60)
            except queue.Empty:
                break
            if item is None or isinstance(item, BaseException):
                break
            item[6].result()
        self.thread.join(timeout=60)
        self.pool.shutdown(wait=True)


def _no_leg(name):
    return contextlib.nullcontext()


def _leg(name):
    """A main-thread leg (wait_chunk, wait_plan, query, columns) or the
    window, as a profiler range seedbench.<name>."""
    return torch.profiler.record_function(f"seedbench.{name}")


def build_finder(inputs: Inputs, config: dict, traffic: dict, device):
    """The program's SeedFinder over the GFA, with psikt's path index
    (`-n`, `-P`, step 1) built, on `device` alone."""
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.seed_finder import SeedFinder
    from psi_tpu_torch.stats import SeedFinderStats, Timer

    Timer.reset_all()
    finder = SeedFinder(load_graph(inputs.gfa), config["seed_len"],
                        seed_mismatches=traffic["mismatches"],
                        stats=SeedFinderStats(), devices=1, device=device)
    finder.create_path_index(config["paths"], config["patched"], 0, 1, 0, 0)
    return finder


def run(cell, device, trace_dir=None) -> Run:
    """One run of the cell: set-up, the window, the comparison. With
    `trace_dir`, the window runs under torch.profiler and its Chrome
    trace is written there."""
    config, traffic = cell.config, cell.traffic
    workdir = tempfile.mkdtemp(prefix="seedbench-")
    try:
        return _run(cell, config, traffic, device, trace_dir, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, config, traffic, device, trace_dir, workdir) -> Run:
    t = time.monotonic()
    inputs = Inputs(config, traffic, cell.seed, workdir)
    t_inputs = time.monotonic()
    finder = build_finder(inputs, config, traffic, device)
    t_index = time.monotonic()
    if device.type == "cuda":
        torch.empty(1, device=device)       # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(device)
    pipe = Pipeline(finder, inputs, traffic)
    prof = None
    done, kept = [], []
    try:
        for _ in range(WARM_CHUNKS):
            pipe.next()
        setup_parts = {"before": t - cell.t_start,
                       "inputs": t_inputs - t, "index": t_index - t_inputs,
                       "warm": time.monotonic() - t_index}
        if trace_dir is not None:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            pipe.leg = _leg
            window = _leg("window")
            window.__enter__()
        t0 = time.monotonic()
        setup_s = t0 - cell.t_start
        while True:
            rec, cols = pipe.next()
            done.append(rec)
            kept.append(cols)
            if rec["t_done"] - t0 >= cell.seconds:
                break
        t1 = rec["t_done"]
        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window.__exit__(None, None, None)
            pipe.leg = _no_leg
            prof.__exit__(None, None, None)
    finally:
        pipe.close()
    trace_path = None
    if prof is not None:
        trace_path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(trace_path)
        del prof
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loci = _loci_chars(finder)
    del finder, pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.monotonic()
    g = reference.GfaGraph(inputs.gfa)
    checks, failed, parts = check(g, inputs, config, traffic, done, kept,
                                  device)
    run = Run(cell=cell, device=device, setup_s=setup_s, window_s=t1 - t0,
              chunks=done, memory_peak_bytes=peak, trace_path=trace_path,
              checks=checks, failed=failed, check_parts=parts,
              check_s=time.monotonic() - t, inputs=inputs, ref_graph=g,
              loci_chars=loci, setup_parts=setup_parts)
    return run


def _loci_chars(finder) -> np.ndarray:
    """The starting loci the program's traversal is given, as (node id,
    offset) pairs, read through its public `get_starting_loci`."""
    loci = finder.get_starting_loci()
    return np.array([(p.node_id(), p.offset()) for p in loci],
                    dtype=np.int64).reshape(-1, 2)


def check(g, inputs: Inputs, config: dict, traffic: dict, done: list,
          kept: list, device) -> tuple[dict, int, dict]:
    """Compare every chunk completed in the window with the reference.
    `g` is the reference's reading of the run's GFA. Returns (checks,
    chunks that failed, parts): the one number compared, `wrong_hits`
    with its limit 0, counts over the chunks the reference's hits that
    the program left out (`missing`), the program's hits the reference
    does not hold (`spurious`) and rows that name no possible hit
    (`malformed`); `parts` gives the three apart, with the reference's
    distinct hits and the program's rows (`distinct`, `emitted`). Each
    record gains the reference's counts of its chunk, which the rates
    read: its distinct seed keys (`ref_keys`) and distinct hits
    (`ref_hits`)."""
    k, n, length = (config["seed_len"], traffic["chunk_reads"],
                    traffic["read_len"])
    table = reference.WalkTable(g, k, device)
    coder = reference.HitCoder(g.chars, n, length)
    want, n_keys = {}, {}
    parts = {"missing": 0, "spurious": 0, "malformed": 0}
    distinct = emitted = failed = 0
    for rec, cols in zip(done, kept):
        if rec["pool"] not in want:
            reads = inputs.chunks[rec["pool"]]
            want[rec["pool"]] = reference.chunk_hits(
                table, reads, traffic["mismatches"], coder)
            n_keys[rec["pool"]] = len(np.unique(
                reference.seed_keys(reads, k)[0]))
        rec["ref_keys"] = n_keys[rec["pool"]]
        rec["ref_hits"] = len(want[rec["pool"]])
        got, bad = reference.program_hits(g, cols, rec["chunk"] * n, n,
                                          length, k, coder, device)
        m, s = reference.compare(want[rec["pool"]], got)
        parts["missing"] += m
        parts["spurious"] += s
        parts["malformed"] += bad
        distinct += len(want[rec["pool"]])
        emitted += len(cols)
        failed += bool(m or s or bad)
    wrong = sum(parts.values())
    return ({"wrong_hits": [wrong, 0]}, failed,
            {**parts, "distinct": distinct, "emitted": emitted})
