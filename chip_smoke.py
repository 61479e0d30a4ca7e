#!/usr/bin/env python3
"""Drive psi_tpu_torch's psikt main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the full-size run (one GPU)
    python3 chip_smoke.py --gchar3 2.0 --gchar3-full   # tools/gchar3
                                     # alone, its kernels timed at that
                                     # size; no other phase, no result

It imports psi_tpu_torch, torch, numpy and the standard library, and
nothing of psi_tpu or jax. Phases, one or more lines each (any failure
exits non-zero and prints no result):

 1. the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from psi_tpu_torch/csrc (nvcc, one process per
    source) and, side by side, the port's native host library from
    psi_tpu_torch/csrc/host (g++); both must load;
 3. generate the data from fixed seeds into a temporary directory: a
    bacterial-scale pan-genome graph (simulate.make_pangenome_graph,
    5 Mbp reference, a SNP or insertion bubble every ~250 bp) as GFA 1,
    and reads of random haplotypes (100 bp, 1% substitutions) as FASTQ;
 4. [kernels] the four level kernels against their plain PyTorch
    versions on the card at the main path's shapes (the 10 Mbp index of
    2 paths and the first chunk's 2^19-slot frontier, every level),
    bit-equal over all slots, with CUDA-event device times (a spin kernel
    queued first), the enqueued time and the plain time, and each
    kernel's bound from the bytes this run's inputs need; the distinct
    payloadC sectors (and, for comparison, payloadR records) per child
    of trie_level and payloadR records per position of rank4; compact
    also warm, as its route runs it (rank4_pair for the level just
    before, events around compact alone), with the distinct rank-table
    sectors per child and a bound from them; rank at the trie step's
    positions too; the plan's builder trie_schedule on chunk 1's distinct
    keys and the ftab, bit-equal to its plain version on the CPU and to
    the plan the main path built, with its device, enqueued and plain
    times, device operations a call and bound; expand + locate time;
 5. [routes] on chunk 1's distinct keys, each level route through
    `trie_search` (fused; two-pass with rank4_pair; two-pass with two
    rank4 launches) and `backward_search_sorted` from the ftab frontier,
    launch counters set to 0 just before each and read just after: the
    leaf ranges of the three routes are equal, the counts of the
    backward search equal the trie's, and each route launched its
    kernels once per level (the backward search: rank_lf_pair once per
    step and nothing else); then rank_lf_pair against its plain version
    on every step's inputs of the backward search, with its times, bound
    and rank records read per key there, and the per-query rank, which
    no route runs any more, replayed through `rank_stream` on the same
    steps' lo and hi arrays (two launches a step, which check the
    wrapper and count on no path), against its plain version, with its
    times; and rank4 on the same arrays, the scattered positions of a
    backward search, against its plain version, with its times and
    records per position;
 6. [gather] the FM gather route on chunk 1's distinct keys: the ranges
    of `backward_search_codes` on the dense (LF-step kernel, one launch
    per step and nothing else), bit-plane and checkpointed layouts equal
    each other and the trie's, with ms per chunk; the LF-step kernel
    (occ_lf_pair) against its plain version on every step's inputs over
    the dense [n+1, 4] table and psi_tpu's padded [n+1, 8] table, with
    device, enqueued and plain times, its bound from the table sectors this
    run's words land on, and the sectors per key; the row gather on the
    same steps' positions, scattered as the route gives them and sorted,
    with device, enqueued, plain and `torch.index_select` times, the
    distinct table sectors per position and the bounds from the bytes and
    from the sectors; `backward_search_pallas` on the padded table (one LF-step
    launch per column) and `gather_occ_rows_blocked` (one row gather)
    agree; the dense search's device operations by the profiler; then
    the MEM API: `find_mems_arrays` over chunk 1's reads on cuda equals
    it on the cpu (and the scalar `seeds_on_paths_seq` on the first
    1,000 reads), with its launches (one LF step per cursor step) and
    time;
 7. [offpath] the off-path traversal on chunk 1 (the cell's uncovered
    loci): the WalkTree probed on the host (NumPy) and on the card equal
    each other; `traverse_device` on the card, its k steps run under
    torch.cuda.set_sync_debug_mode("error") with the launch counters set
    to 0 just before and read just after (traverse_step once per step
    and nothing else), gives the probe's survivors, order and
    TraverserStats; traverse_step against its plain version on every
    step's inputs of that run, over the whole cap, with the kernel's
    device time per step beside its bound, and the fused and plain
    traversals' wall, busy, enqueued and peak-memory figures; the time
    of each off-path form (host probe, device probe,
    device traversal); then `traverse_device_approx` (m = 1, cap doubled
    until it fits; range_refine4 and traverse_step_approx k an attempt
    and nothing else) on the card equal to it on the CPU, and
    range_refine4 against its plain version on the final attempt's
    inputs, timed the same way;
 8. the CLI (`psi_tpu_torch.cli.main`) with --device cuda, launch
    counters set to 0 just before and read just after: the trie-level
    kernel must have run for every chunk and level, trie_schedule once a
    chunk (each plan built on the card; every later phase that plans on
    the card counts it the same way), and nothing else;
 9. [cli-trav] the same command with PSI_TRAV_CACHE=0 (the device
    traversal every chunk): only trie_level and traverse_step (k launches
    per chunk and attempt), and a lexsorted hit stream byte-identical to
    phase 8's;
10. the same command with --device cpu (the plain versions): the
    lexsorted hit streams must be byte-identical;
11. [cli-mismatch] --mismatches 1 on cuda over the first chunk's 100,000
    reads: only trie_level (one chunk's levels), range_refine4 and
    traverse_step_approx (k of each per attempt, as the chunk's
    approx-step-launches counter says), with its hits and rates; then
    cuda and cpu on the first 5,000 reads give byte-identical lexsorted
    hit streams;
12. counts of 10,000 sampled distinct keys against FMIndex.backward_search;
13. [baseline] the single-core C++ backward search (csrc/host/psi_fm.cpp
    through native.fm_backward_batch, the speed baseline, built with
    psi_tpu's native/Makefile flags) over chunk 1's distinct keys, warmed
    up on the first 1,024, in turns with the card's on-path trie search
    of the same keys, five calls each (trie_search: the plan built on the
    card, the trie_level launches and the download; launch counters
    set to 0 just before and read just after: one trie_level a level and
    one trie_schedule a call, nothing else): the leaf ranges agree in every pair (hi - lo
    everywhere, lo where the range is not empty), with both median rates
    in kmer-queries/s, each pair's ratio and their median, the levels'
    device time by CUDA events, the compiler command line and the host
    CPU's model (lscpu);
14. [tools] the tool CLIs on the cell's path index, saved to the
    temporary directory: pindexctl inspect --device cuda (its SeedFinder
    on the card; its uncovered-loci count is phase 3's), to-fasta (the
    paths' total length is inspect's) and to-gam with the loci as edits;
    loci_stats -c; sloci export then import gives the loci array back;
    ggsim -t fastq -n 100000 -l 100 -S 7, single and paired-end (-d 500
    -s 50), with the records counted; SeedFinder.nof_uncovered_kmers;
    each with its wall time;
15. [offpath-scale] the dense cell (psi_tpu_torch/tools/dense.py: 5 Mbp,
    a bubble every ~50 bp, ~3 x 10^5 loci, the WalkTree over its cap of
    2^23 nodes, so traverse_device is the route): (a) the traversal as in
    phase 7, traverse_step bit-equal to plain at every step over the
    whole cap, both forms timed; (d) the WalkTree probe with
    PSI_TRAV_CACHE_CAP raised past the tree, equal to the traversal and
    timed beside it as each route runs (a measurement, not a route);
    (b) the CLI on one chunk: only trie_level and traverse_step, then
    cuda and cpu on its first 5,000 reads give byte-identical lexsorted
    hit streams; (c) at 10^6 loci or more (10 Mbp, a bubble every ~33 bp)
    the traversal alone, as in (a), with no FM index built;
16. [dindex] the distance index on phase 3's graph: (a) the native build
    at the insert-size ranges (250, 450), (500, 2000) and (1000, 10000),
    with intervals, seconds and artifact bytes; (b) PSI_DINDEX_BUILD=device
    (path doubling on the card) at the first two, byte-identical to (a),
    with rounds, wall seconds, CUDA-event time and peak MB; (c) 2^22
    locus pairs per probed index from simulated haplotypes (7/8 on one
    haplotype, the gap uniform in [0, 2 dmax]; 1/8 anywhere); (d) at
    (250, 450) and (1000, 10000), the probe kernel (dindex_probe.cu,
    one launch per verify_batch_device call) bit-equal to
    probe_bisect_plain and probe_sort on the card, to the NumPy
    verify_batch, and on 10,000 sampled pairs to the scalar verify; its
    device time in turns with torch.searchsorted's, its enqueued and plain times and probe_sort's,
    its bounds by bytes and by 32-byte sectors, the table sectors a pair
    reads; the upload's time and its key directory's build time, bytes
    and buckets; verify_batch_device's wall time split into the host's
    pair arithmetic, the upload, the probe and the download; (e) psikt
    -m 250 -M 450 -I on 5,000 reads saves the index, a second run loads
    it without a rebuild, and both give the hits of the run without
    -m/-M; (f) alice dstats over 10^6 read pairs of (c)
    as GAF prints the same counts on cuda (one probe launch and nothing
    else) and on the NumPy host probe (PSI_DINDEX_DEVICE=0), the counts
    that the pairs' loci give;
17. [mesh] the multi-device pipeline (psi_tpu_torch/parallel) on chunk 1
    of phase 3's cell, the path index loaded as phase 14 saved it: (a)
    SeedFinder(devices=(card, card)), a mesh naming the one card twice,
    launch counters set to 0 just before its query and read just after:
    its lexsorted hits byte-identical to the single-device finder's,
    trie_level once a level a shard and traverse_step once a step a
    shard and attempt, and nothing else; the query's wall, the sharded
    plan's seconds, the peak MB, and per shard its plan's host ms and
    its levels' and traversal's device ms (a replay); with two cards
    visible the same on cuda:0 and cuda:1, else a line saying why not;
    (b) --mismatches 1 on the same mesh over the first 10,000 reads,
    equal to the single-device finder, with its range_refine4 launches;
    (c) two psi_tpu_torch.tools.multihost_worker processes sharing the
    card (gloo on a free localhost port, one shard each, a timeout on
    each, a non-zero exit fails the phase): sharded count and trie search
    equal to a global oracle, under PSI_MH_EMIT=shard the two streams
    partition the single-device stream, under full each equals it, with
    each process's launches and walls; (d) graft.dryrun_multichip(2) on
    the card named twice; (e) psikt --devices auto -I on chunk 1: with
    one card the single route, [cli-cuda]'s chunk-1 hits byte for byte.
    Each kernel of the kernels line gains `mesh_launches`, its launches
    in each of these runs;
18. [chr-scale] psi_tpu's chromosome-scale configuration
    (psi_tpu_torch/tools/chr_scale.py: a 4-component pan-genome, variant
    rate 0.01, 20% insertions, k = 30, 6 patched paths with context 30,
    loci every 10 bp, the distance index over (300, 500)) at --chr-mbp
    Mbp (CHR_MBP), written as GFA with 8 chunks of 20,000 error-free 150
    bp reads: (a) psikt -l 30 -n 6 -t 30 -e 10 -m 300 -M 500 -c 20000 -I
    on the card, the index built and saved once, launch counters set to
    0 just before and read just after (trie_level once a level and
    chunk, traverse_step k an attempt only where the device traversal is
    the route, nothing else), each host stage of the build timed, the
    index chars, nodes, loci and WalkTree beside psi_tpu's recorded run,
    the per-chunk legs and the sustained rates over chunks 2-8; (b) the
    same command with --device cpu on the first 2,000 reads, the index
    loaded, with the WalkTree and under PSI_TRAV_CACHE=0: lexsorted hit
    streams byte-identical to (a)'s on those reads; (c) chr_scale.run's
    stages on the loaded index; (d) trie_level at chunk 1's frontier and
    traverse_step over the loci (every step, the whole cap) bit-equal to
    their plain versions, with device, enqueued and plain times and
    bounds that count the payload, graph and seeds tables as HBM traffic,
    by bytes and by 32-byte sectors; (e) the native distance-index build
    (intervals, seconds), the device build byte-identical to it (rounds,
    wall, peak MB), and dindex_probe over 2^22 pairs drawn as [dindex]
    (c) draws them, bit-equal to its plain version and the NumPy verify,
    timed in turns with torch.searchsorted, beside its bounds. Each
    kernel of the kernels line gains `chr_scale_launches`, its launches
    in (a), and the three of (d) and (e) a `chr_scale` record;
19. [gchar3] psi_tpu's human-pan-genome-scale configuration
    (psi_tpu_torch/tools/gchar3.py, psi_tpu's scripts/gchar3_run.py: a
    16-component pan-genome, a bubble every ~1 kbp, 20% insertions,
    k = 30, one unpatched path a region, loci every 10 bp and then at
    every bp, the distance index over (250, 450), 100,000 error-free 150
    bp reads) at --gchar3 Gchar (GCHAR3_SMOKE), under PSI_SA_DISK=1 (the
    disk-spilled suffix array) and a lowered
    DistanceIndex.BIG_COL_BYTES (the artifact's side files, loaded
    memory-mapped): (a) gchar3.run on the card, launch counters set to 0
    just before and read just after: its stages and counts, trie_level
    once a level in on_path and traverse_step once a step and attempt in
    off_path (the loci put the WalkTree past its cap), nothing else,
    each stage's seconds and peak card memory; (b) gchar3.run with
    --device cpu over the first 2,000 reads: the same index counts and
    lexsorted hits as the card's on those reads; (c) trie_level at the
    chunk's frontier and traverse_step over the loci (every step, the
    whole cap) bit-equal to their plain versions, timed beside their
    bounds by bytes and by 32-byte sectors. Each kernel of the kernels
    line gains `gchar3_launches`, its launches in (a), and the two of
    (c) a `gchar3` record;
20. [approx-step] traverse_step_approx at the shape of the benchmark's
    g1k_common.mm1 cell (its graph and a 2,000-read chunk made by the
    port's generators at the cell's values): the approximate traversal
    from the route's cap, doubled until it fits, k traverse_step_approx
    and k range_refine4 an attempt and nothing else with no host sync in
    its steps; the kernel bit-equal to traverse_step_approx_plain at
    every step of every attempt over the whole cap; per cap, by CUDA
    events, the kernel's device us, range_refine4's, the step's and the
    plain step's, and the enqueued us a step, beside its bound.

Then, on lines of their own, the run's total seconds, the kernels JSON
and the card line, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from psi_tpu_torch.tools.bacterial import (  # noqa: E402
    CHUNK, N_CHUNKS, N_PATHS, REF_LEN, SEED_LEN, first_chunk_index,
    lf_steps as replay_lf_steps, make_data)
from psi_tpu_torch.tools.timing import (  # noqa: E402
    HBM_BYTES_PER_S, bracketed_ms, card_line, cuda_ms, probe_sectors,
    r4_sectors, row_sectors)

N_SAMPLED_KEYS = 10_000
DENSE_MIN_LOCI = 200_000   # the dense cell's loci, at the least
SCALE_MIN_LOCI = 1_000_000  # the scale point's loci, at the least
N_MISMATCH_READS = 5_000   # reads of the --mismatches cuda = cpu check
#: the distance index's insert-size ranges: a paired-end library, a wider
#: one, and the mate-pair horizon; the device build runs at the first two
DINDEX_HORIZONS = ((250, 450), (500, 2000), (1000, 10000))
DINDEX_PAIRS = 1 << 22     # locus pairs per probed index
DINDEX_SCALAR = 10_000     # of them checked by the scalar verify
DINDEX_CLI_READS = 5_000   # reads of the psikt -m/-M round trip
DINDEX_GAF_PAIRS = 1_000_000  # read pairs of alice dstats
BASELINE_WARM = 1024  # keys of the native baseline's warm-up call
BASELINE_REPS = 5     # timed pairs (baseline, card) over chunk 1's keys
GGSIM_READS = 100_000  # reads (pairs) of each ggsim run in [tools]
KERNEL_REPS = 20   # launches of 2^19 threads per timed kernel
PLAIN_REPS = 3     # the plain versions launch ~25-40 kernels per level
SCHEDULE_REPS = 10  # trie_schedule calls per timing (~50 launches a call)
ROUTE_REPS = 5     # whole-route runs per timing (up to ~60 launches each)
WARM_REPS = 8      # rounds of the 9 levels for compact's warm time
#: H100 SXM float32 rate outside the tensor cores (NVIDIA's data sheet),
#: taken for the kernels' 32-bit integer operations
INT32_OPS_PER_S = 67e12


class SmokeFailure(Exception):
    pass


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def build_all():
    """Build the CUDA kernels and the native host library side by side;
    returns (kernel library, seconds, host library note, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from psi_tpu_torch import _build, native

    def timed(fn):
        t0 = time.monotonic()
        out = fn()
        return out, time.monotonic() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        kernels = pool.submit(timed, _build.load)
        host = pool.submit(timed, native.available)
        (_, kernel_s), (loaded, host_s) = kernels.result(), host.result()
    require(loaded, f"the native host library did not build: "
            f"{native.load_error}")
    return (_build.BUILD_DIR / "libkernels.so", kernel_s,
            f"{_build.BUILD_DIR / 'libpsi_host.so'} ({native.built_with})",
            host_s)


# --- phase 4: kernels against their plain versions -----------------------------

def enqueue_ms(fn, reps: int) -> float:
    """Mean host milliseconds per fn() when runs follow each other and end
    in a synchronize: what the main path pays, launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def busy_ms(fn, per_run: int) -> float:
    """Device busy milliseconds per launch of fn() by torch.profiler: the
    sum of its kernels' times, without the gaps between them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / per_run


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) that one fn() runs, by
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def max_abs_err(got, want) -> int:
    require(got.shape == want.shape,
            f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max().item())


def profile_query(finder, seeds, index) -> dict:
    """Device busy share of one chunk's query (seeds_all_arrays on the
    prepared first chunk, WalkTree already built), by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    finder.seeds_all_arrays(seeds, index)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        finder.seeds_all_arrays(seeds, index)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    avg = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in avg
                  if e.device_type == DeviceType.CUDA)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke_profile.txt"),
              "w") as fh:
        fh.write(avg.table(sort_by="self_device_time_total", row_limit=25))
    phase("profile", f"one chunk's query: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.2f}%); WalkTree of "
          f"{finder._trav_tree[1].n_nodes} nodes")
    return {"query_wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3}


def n_unique(x) -> int:
    import torch

    return int(torch.unique(x).numel())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least milliseconds the card could take: the larger of the bytes
    over HBM bandwidth and the operations over the 32-bit rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# Compulsory traffic of one launch at this run's inputs, as (bytes,
# integer operations): each input array read once and each output
# written once. The payload (payloadT, 20 MB at 10 Mbp, or payloadR or
# payloadC, 10 MB each) is not counted: every launch of a route, and every
# timed launch below, reads the same payload, which stays in the 50 MB L2
# from one launch to the next. The
# rank tables that compact reads are counted, as the 4-byte words this
# run's (char, parent) pairs land on: they are an output of the launch
# before, and the timed loop cycles through every level's tables (9 x 16
# MiB), so they come from HBM there. The *_sector_work functions count,
# for compact and the row gather, the 32-byte sectors that such a table's
# words or rows land on instead, as occ_lf_pair_work does. Operations per
# element are counted from the kernel sources.

def trie_level_work(parents, chars, lo, hi):
    return nbytes(parents, chars, lo, hi) + nbytes(lo, hi), \
        20 * parents.numel()


def rank4_pair_work(lo, hi):
    return nbytes(lo, hi) * 5, 60 * lo.numel()


def rank4_work(pos):
    return nbytes(pos) * 5, 30 * pos.numel()


def compact_work(r4lo, parents, chars):
    pairs = n_unique((chars.long() - 1) * r4lo.shape[1] + parents.long())
    return nbytes(parents, chars) * 2 + 2 * 4 * pairs, 6 * parents.numel()


def compact_sector_work(r4lo, parents, chars):
    """Parents and chars read, lo' and hi' written, and one 32-byte
    sector of r4lo and one of r4hi for each distinct sector their words
    land on: a sector, not the 4-byte word that compact_work counts, is
    the least the card moves from a table past L2."""
    return (nbytes(parents, chars) * 2
            + 2 * 32 * r4_sectors(r4lo.shape[1], parents, chars)), \
        6 * parents.numel()


def rank_work(chars, pos):
    return nbytes(chars, pos) + nbytes(pos), 12 * pos.numel()


def occ_gather_work(occ, pos):
    """Positions read, the distinct rows they name read once, every
    output row written; a few integer operations per position."""
    row = occ.shape[1] * occ.element_size()
    return nbytes(pos) + row * (n_unique(pos) + pos.numel()), \
        4 * pos.numel()


def occ_gather_sector_work(occ, pos):
    """Positions read, every output row written, and one 32-byte sector
    for each distinct sector of the table (past L2) that the rows lie in,
    where occ_gather_work counts the distinct rows' bytes."""
    row = occ.shape[1] * occ.element_size()
    return (nbytes(pos) + row * pos.numel()
            + 32 * row_sectors(occ.shape[1], pos)), 4 * pos.numel()


def rank_lf_pair_work(c, lo, hi):
    """Chars, lo and hi read, lo' and hi' written; the rank records, like
    rows 1-9's payload, stay in L2 and are not counted."""
    return nbytes(c, lo, hi) + nbytes(lo, hi), 16 * lo.numel()


def records_per_item(*positions) -> float:
    """Distinct payloadR records (one 32-byte sector each) that one
    launch's positions land on, over the launch's items (the length of
    each positions array)."""
    import torch

    blocks = torch.cat([p.reshape(-1) for p in positions]) >> 5
    return n_unique(blocks) / positions[0].numel()


def char_sectors_per_child(nbpad, chars, lo, hi) -> float:
    """Distinct 32-byte sectors of payloadC (four blocks of one char
    each) that the (char, lo block) and (char, hi block) words of one
    launch's children land on, over its children."""
    import torch

    words = torch.cat([(chars.long() - 1) * nbpad + (p.long() >> 5)
                       for p in (lo, hi)])
    return n_unique(words >> 2) / chars.numel()


def occ_sectors(occ, c, lo, hi) -> int:
    """Distinct 32-byte sectors of the occ table that the words
    occ[lo, c-1] and occ[hi, c-1] land on."""
    import torch

    words = (torch.cat([lo, hi]).long() * occ.shape[1]
             + (c.long() - 1).repeat(2))
    return n_unique(words >> 3)          # 8 int32 words a sector


def occ_lf_pair_work(occ, c, lo, hi):
    """Chars, lo and hi read, lo' and hi' written, and one 32-byte sector
    for each distinct sector of the table (past L2) that the (lo, c) and
    (hi, c) words land on: a sector, not the 4-byte word, is the least
    the card moves. Row 10's bound counts whole rows instead."""
    return (nbytes(c, lo, hi) + nbytes(lo, hi)
            + 32 * occ_sectors(occ, c, lo, hi)), 8 * lo.numel()


def mean_bound(work) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes, operations) of the mean launch of
    `work`, a list of (bytes, operations) per launch."""
    bytes_moved = sum(b for b, _ in work) / len(work)
    ops = sum(o for _, o in work) / len(work)
    return (*bound(bytes_moved, ops), bytes_moved, ops)


def measure(name, kernel, plain, per_run, work, err, shape,
            plain_reps=PLAIN_REPS, library=None, tag="kernels") -> dict:
    """Device, enqueued and plain ms per launch of one kernel, beside its
    bound from `work` ((bytes, ops) per launch) and, where one PyTorch
    call computes the same function, that call's device ms; prints one
    line."""
    ms = cuda_ms(kernel, KERNEL_REPS) / per_run
    enq = enqueue_ms(kernel, KERNEL_REPS) / per_run
    plain_ms = cuda_ms(plain, plain_reps) / per_run
    library_ms = (None if library is None
                  else cuda_ms(library, KERNEL_REPS) / per_run)
    bound_ms, bound_by, bytes_moved, ops = mean_bound(work)
    lib = ("" if library_ms is None
           else f", library {1e3 * library_ms:.3f}")
    phase(tag, f"{name}: {1e3 * ms:.3f} us/launch on the device "
          f"(enqueued {1e3 * enq:.3f}, plain {1e3 * plain_ms:.3f}{lib}); "
          f"bound {1e3 * bound_ms:.3f} us by {bound_by} "
          f"({bytes_moved / 1e6:.2f} MB/launch); bit-equal over {shape}")
    return {"max_abs_err": err, "ms": ms, "enqueued_ms": enq,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": bytes_moved, "ops": ops, "shape": shape}


#: the kernel entry points: wrapper (module, attribute), source, the
#: TPU rows of the kernel table it replaces and their file:line
KERNELS = {
    "trie_level": (("fm_fused", "trie_level"),
                   "psi_tpu_torch/csrc/trie_level.cu", [1],
                   ["psi_tpu/ops/fm_fused.py:80"]),
    "rank4_pair": (("fm_stream", "rank4_pair_stream"),
                   "psi_tpu_torch/csrc/rank4_pair.cu", [2],
                   ["psi_tpu/ops/fm_stream.py:570"]),
    "compact": (("fm_stream", "compact_children"),
                "psi_tpu_torch/csrc/compact.cu", [3, 8],
                ["psi_tpu/ops/fm_stream.py:1036",
                 "psi_tpu/ops/fm_stream.py:1154"]),
    "rank4": (("fm_stream", "rank4_stream"), "psi_tpu_torch/csrc/rank4.cu",
              [4, 5, 6, 7],
              ["psi_tpu/ops/fm_stream.py:433", "psi_tpu/ops/fm_stream.py:361",
               "psi_tpu/ops/fm_stream.py:736",
               "psi_tpu/ops/fm_stream.py:878"]),
    "rank": (("fm_stream", "rank_stream"), "psi_tpu_torch/csrc/rank.cu", [9],
             ["psi_tpu/ops/fm_stream.py:166"]),
    "rank_lf_pair": (("fm_stream", "rank_lf_pair"),
                     "psi_tpu_torch/csrc/rank.cu", [9],
                     ["psi_tpu/ops/fm_stream.py:166"]),
    "occ_gather": (("fm_pallas", "gather_occ_rows"),
                   "psi_tpu_torch/csrc/occ_gather.cu", [10, 11],
                   ["psi_tpu/ops/fm_pallas.py:31",
                    "psi_tpu/ops/fm_pallas.py:200"]),
    "occ_lf_pair": (("fm_pallas", "lf_pair"),
                    "psi_tpu_torch/csrc/occ_gather.cu", [10, 11],
                    ["psi_tpu/ops/fm_pallas.py:31",
                     "psi_tpu/ops/fm_pallas.py:200"]),
    # no TPU kernel: psi_tpu's _range_refine and traverse_device are
    # plain XLA
    "traverse_step": (("traverse", "traverse_step"),
                      "psi_tpu_torch/csrc/traverse_step.cu", [],
                      ["psi_tpu/ops/traverse.py:267"]),
    "range_refine4": (("traverse", "range_refine4"),
                      "psi_tpu_torch/csrc/range_refine.cu", [],
                      ["psi_tpu/ops/traverse.py:230"]),
    "traverse_step_approx": (("traverse", "traverse_step_approx"),
                             "psi_tpu_torch/csrc/traverse_step_approx.cu",
                             [], ["psi_tpu/ops/traverse.py:411"]),
    # no TPU kernel: psi_tpu's probe_bisect and probe_sort are plain XLA
    "dindex_probe": (("dindex_probe", "probe_bisect"),
                     "psi_tpu_torch/csrc/dindex_probe.cu", [],
                     ["psi_tpu/ops/dindex_probe.py:30",
                      "psi_tpu/ops/dindex_probe.py:61"]),
    # no TPU kernel: psi_tpu builds the trie plan on the host
    # (build_schedule, then prepare's padding and upload)
    "trie_schedule": (("fm_trie", "trie_schedule"),
                      "psi_tpu_torch/csrc/trie_schedule.cu", [],
                      ["psi_tpu/ops/fm_trie.py:74",
                       "psi_tpu/ops/fm_trie.py:707"]),
}
#: the PyTorch call that computes each kernel's function, or why none does
LIBRARY = {
    "trie_level": "none: a payload gather by block, a match-word AND, a "
                  "masked popcount and C[c] added; torch has no popcount "
                  "operator and no call that fuses these",
    "rank4_pair": "none: four ranks at lo and at hi, each a payload gather "
                  "and a masked popcount; torch has no popcount operator",
    "compact": "none: C[c] + r4[c - 1, parent] is an index computation, a "
               "2-d gather and an add, no single call",
    "rank4": "none: four ranks at one position array, each a payload "
             "gather and a masked popcount; torch has no popcount operator",
    "rank": "none: a per-query rank-record gather chosen by the query's "
            "char, a masked popcount and an add; torch has no popcount "
            "operator",
    "rank_lf_pair": "none: per key a rank-record gather chosen by the "
                    "key's char at lo and at hi, masked popcounts and C[c] "
                    "added; torch has no popcount operator",
    "occ_gather": "torch.index_select(occ, 0, pos)",
    "occ_lf_pair": "none: a gather of one word of lo's row and one of hi's, "
                   "column chosen per key, and C[c] added; no single call "
                   "gathers by row and column and adds",
    "traverse_step": "none: a fork by prefix sum and searchsorted, clipped "
                     "gathers of edges and labels, a one-char rank and a "
                     "second prefix-sum compaction; no single call, and no "
                     "popcount operator",
    "range_refine4": "none: per state two occ-row and plane-word gathers, "
                     "four masked popcounts at lo and at hi and a prefix "
                     "sum over the chars; torch has no popcount operator",
    "traverse_step_approx": "none: a fork by prefix sum and searchsorted, "
                            "clipped gathers of edges and labels, a cost "
                            "and budget mask over four chars, a second "
                            "prefix-sum compaction and a rank-select of "
                            "the char; no single call",
    "dindex_probe": "torch.searchsorted(pk, qkey, right=True): the search "
                    "alone, without the row checks",
    "trie_schedule": "none: change depths of neighbouring keys, then per "
                     "level a bitmap of (char, parent slot) and its prefix "
                     "popcount scattered into the padded plan; torch has no "
                     "popcount operator, and a bool cumsum, a nonzero and "
                     "scatters a level are the plain version",
}
ZERO_COUNTS = dict.fromkeys(KERNELS, 0)
#: entry points that no route of the port runs (backward_search_sorted
#: now steps with rank_lf_pair): checked and timed on a replay of their
#: contract, with 0 launches on any path
OFF_PATH = {"rank"}


def _wrappers() -> dict:
    import importlib

    return {name: getattr(importlib.import_module(
        f"psi_tpu_torch.ops.{mod}"), attr)
        for name, ((mod, attr), *_) in KERNELS.items()}


def reset_counters() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def trie_schedule_work(n: int, levels: int, npad: int, frontier: int,
                       k: int) -> tuple[float, float]:
    """(bytes, operations) of one trie_schedule call on n keys: the keys
    read (8 B each), the frontier's ftab rows gathered (8 B a row), the
    padded plan written (parents and chars [levels, npad] int32, lo0 and
    hi0 [npad] where there is a frontier) and the leaf slot of each key
    (int32); a few integer operations a key and level for the change
    depths and the ranks."""
    written = 2 * 4 * levels * npad + (2 * 4 * npad if frontier else 0)
    return 8 * n + 8 * frontier + written + 4 * n, 4.0 * n * k


def schedule_record(finder, uniq, prep) -> dict:
    """trie_schedule at the main path's shape: chunk 1's distinct keys and
    the finder's ftab. The card's plan, bit-equal to its plain version on
    the CPU over the same inputs and to the plan the main path built
    (fm_trie.prepare, every padded slot and leaf_perm); one launch
    counted; device, enqueued and plain (on the card) ms a call, the
    device operations a call runs, and the bound."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import fm_trie

    k = finder.seed_len
    levels, npad = prep.parents.shape
    p = k - levels
    keys = torch.from_numpy(np.ascontiguousarray(uniq, dtype=np.uint64)
                            .view(np.int64))
    ftab = (torch.from_numpy(np.ascontiguousarray(finder._get_ftab(),
                                                  dtype=np.int32))
            if p else None)
    dev = finder.device
    keys_d = keys.to(dev)
    ftab_d = None if ftab is None else ftab.to(dev)
    torch.cuda.synchronize()
    reset_counters()
    got = fm_trie.trie_schedule(keys_d, k, p, ftab_d, npad)
    torch.cuda.synchronize()
    calls = read_counters()
    require(calls == {**ZERO_COUNTS, "trie_schedule": 1},
            f"trie_schedule launched {calls}")
    want = fm_trie.trie_schedule_plain(keys, k, p, ftab, npad)
    path = (prep.parents, prep.chars, prep.lo0, prep.hi0,
            torch.from_numpy(prep.leaf_perm))
    err = 0
    for name, g, w, q in zip(("parents", "chars", "lo0", "hi0", "leaf"),
                             got, want, path):
        if w is None:
            require(g is None and q is None, f"trie_schedule {name}: "
                    f"given where p is 0, or missing where p > 0")
            continue
        g = g.cpu()
        e = max(max_abs_err(g, w), max_abs_err(g, q.cpu()))
        require(e == 0 and g.dtype == torch.int32, f"trie_schedule {name} "
                f"differs from its plain version or the main path's plan "
                f"by {e} ({g.dtype})")
        err = max(err, e)
    frontier = 0 if p == 0 else len(np.unique(
        np.asarray(uniq, dtype=np.uint64) >> np.uint64(2 * (k - p))))

    def run():
        return fm_trie.trie_schedule(keys_d, k, p, ftab_d, npad)

    ms = cuda_ms(run, SCHEDULE_REPS)
    enq = enqueue_ms(run, SCHEDULE_REPS)
    plain_ms = cuda_ms(lambda: fm_trie.trie_schedule_plain(
        keys_d, k, p, ftab_d, npad), PLAIN_REPS)
    ops_a_call = device_ops(run)
    bound_ms, bound_by, bytes_moved, ops = mean_bound(
        [trie_schedule_work(len(uniq), levels, npad, frontier, k)])
    shape = (f"{len(uniq)} keys, p={p}, {levels} levels x {npad} slots, "
             f"{frontier} frontier slots")
    phase("kernels", f"trie_schedule: {1e3 * ms:.3f} us/call on the device "
          f"(enqueued {1e3 * enq:.3f}, plain {1e3 * plain_ms:.3f}), "
          f"{ops_a_call} device operations a call; bound "
          f"{1e3 * bound_ms:.3f} us by {bound_by} ({bytes_moved / 1e6:.2f} "
          f"MB/call); bit-equal to plain and to the main path's plan over "
          f"{shape}")
    return {"max_abs_err": err, "ms": ms, "enqueued_ms": enq,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": bytes_moved, "ops": ops,
            "shape": shape, "device_ops_per_call": ops_a_call}


def kernel_phase(finder, index) -> tuple[dict, dict]:
    """Each kernel against its plain version at the main path's shapes:
    every level of chunk 1's frontier. Returns per-kernel records (max
    error, device, enqueued and plain ms per launch, bound) and route
    facts."""
    import torch

    from psi_tpu_torch.ops import fm_fused, fm_stream, fm_trie

    sarr = finder._get_stream_arrays()
    uniq, prep = index._onpath_prep.uniq, index._onpath_prep.trie
    levels, npad = prep.parents.shape
    par, chs = prep.parents, prep.chars
    phase("kernels", f"index {sarr.n} chars; payloadC "
          f"{tuple(sarr.payloadC.shape)}, payloadR "
          f"{tuple(sarr.payloadR.shape)}, payloadT "
          f"{tuple(sarr.payloadT.shape)}; {len(uniq)} distinct keys in a "
          f"{npad}-slot frontier, {levels} levels")

    # the frontier of every level, by the trie-level kernel
    fronts = [(prep.lo0, prep.hi0)]
    err = dict.fromkeys(("trie_level", "rank4_pair", "compact", "rank4",
                         "rank"), 0)
    for j in range(levels):
        lo, hi = fronts[-1]
        out = (torch.empty_like(lo), torch.empty_like(hi))
        fm_fused.trie_level(sarr.payloadC, sarr.C, par[j], chs[j], lo, hi,
                            *out)
        want = fm_fused.trie_level_plain(sarr.payloadC, sarr.C, par[j],
                                         chs[j], lo, hi)
        err["trie_level"] = max(err["trie_level"], max_abs_err(out[0], want[0]),
                                max_abs_err(out[1], want[1]))
        fronts.append(out)

    # rank4_pair, rank4 and compact on every level's frontier; rank at
    # the parents' lo with the children's chars, which is the trie step
    r4s, ranked = [], []
    for j in range(levels):
        lo, hi = fronts[j]
        r4 = fm_stream.rank4_pair_stream(sarr, lo, hi)
        want = fm_stream.rank4_pair_plain(sarr, lo, hi)
        err["rank4_pair"] = max(err["rank4_pair"], max_abs_err(r4[0], want[0]),
                                max_abs_err(r4[1], want[1]))
        for pos, w in zip((lo, hi), want):
            got = fm_stream.rank4_stream(sarr, pos)
            err["rank4"] = max(err["rank4"], max_abs_err(got, w),
                               max_abs_err(got, fm_stream.rank4_plain(
                                   sarr.payloadR, pos)))
        got = fm_stream.compact_children(r4[0], r4[1], par[j], chs[j], sarr.C)
        want = fm_stream.compact_plain(r4[0], r4[1], par[j], chs[j], sarr.C)
        err["compact"] = max(err["compact"], max_abs_err(got[0], want[0]),
                             max_abs_err(got[1], want[1]))
        require(max_abs_err(got[0], fronts[j + 1][0]) == 0
                and max_abs_err(got[1], fronts[j + 1][1]) == 0,
                f"two-pass level {j} differs from the fused level")
        pos = lo[par[j].long()]
        rk = fm_stream.rank_stream(sarr, chs[j], pos)
        err["rank"] = max(err["rank"], max_abs_err(
            rk, fm_stream.rank_plain(sarr.payloadT, chs[j], pos)))
        require(max_abs_err(sarr.C[chs[j].long()] + rk, fronts[j + 1][0]) == 0,
                f"C[c] + rank(c, lo[parent]) differs from level {j}'s lo")
        r4s.append(r4)
        ranked.append(pos)
    torch.cuda.synchronize()
    for name, e in err.items():
        require(e == 0, f"{name} differs from its plain version by {e}")

    def each_level(fn):
        def run():
            for j in range(levels):
                fn(j)
        return run

    runs = {
        "trie_level": (
            lambda: fm_fused.trie_fused(sarr, par, chs, prep.lo0, prep.hi0),
            each_level(lambda j: fm_fused.trie_level_plain(
                sarr.payloadC, sarr.C, par[j], chs[j], *fronts[j])),
            levels,
            [trie_level_work(par[j], chs[j], *fronts[j])
             for j in range(levels)]),
        "rank4_pair": (
            each_level(lambda j: fm_stream.rank4_pair_stream(
                sarr, *fronts[j])),
            each_level(lambda j: fm_stream.rank4_pair_plain(
                sarr, *fronts[j])),
            levels,
            [rank4_pair_work(*fronts[j]) for j in range(levels)]),
        "rank4": (
            each_level(lambda j: [fm_stream.rank4_stream(sarr, p)
                                  for p in fronts[j]]),
            each_level(lambda j: [fm_stream.rank4_plain(sarr.payloadR, p)
                                  for p in fronts[j]]),
            2 * levels,
            [rank4_work(p) for j in range(levels) for p in fronts[j]]),
        "compact": (
            each_level(lambda j: fm_stream.compact_children(
                *r4s[j], par[j], chs[j], sarr.C)),
            each_level(lambda j: fm_stream.compact_plain(
                *r4s[j], par[j], chs[j], sarr.C)),
            levels,
            [compact_work(r4s[j][0], par[j], chs[j]) for j in range(levels)]),
        # the trie step's pattern-sorted positions; the rank kernel's own
        # path, the backward search, is measured in route_phase
        "rank (trie positions)": (
            each_level(lambda j: fm_stream.rank_stream(
                sarr, chs[j], ranked[j])),
            each_level(lambda j: fm_stream.rank_plain(
                sarr.payloadT, chs[j], ranked[j])),
            levels,
            [rank_work(chs[j], ranked[j]) for j in range(levels)]),
    }
    shape = f"{npad} slots x {levels} levels"
    records = {name: measure(name, *run, err[name.split(" ")[0]], shape)
               for name, run in runs.items()}
    records["trie_schedule"] = schedule_record(finder, uniq, prep)

    # compact as its route runs it ("warm"): rank4_pair for the level just
    # before, so the rank tables it reads sit in L2, with CUDA events
    # around compact alone; its bound from the sectors the cold loop
    # above reads (9 levels of 16 MB tables cycled)
    cp = records["compact"]
    cp["warm_ms"] = bracketed_ms(
        lambda j: fm_stream.rank4_pair_stream(sarr, *fronts[j]),
        lambda j, r4: fm_stream.compact_children(*r4, par[j], chs[j], sarr.C),
        levels, WARM_REPS)
    cp["sector_bound_ms"], _, cp["sector_bytes"], _ = mean_bound(
        [compact_sector_work(r4s[j][0], par[j], chs[j])
         for j in range(levels)])
    cp["r4_sectors_per_child"] = sum(
        r4_sectors(npad, par[j], chs[j]) for j in range(levels)) / (
        levels * npad)
    phase("kernels", f"compact warm (rank4_pair just before, events around "
          f"compact alone): {1e3 * cp['warm_ms']:.3f} us/launch (cold "
          f"{1e3 * cp['ms']:.3f}); {cp['r4_sectors_per_child']:.4f} "
          f"distinct sectors of each rank table per child; sector bound "
          f"{1e3 * cp['sector_bound_ms']:.3f} us "
          f"({cp['sector_bytes'] / 1e6:.2f} MB/launch), byte bound "
          f"{1e3 * cp['bound_ms']:.3f} us")

    # the rank words each launch reads: for trie_level, distinct payloadC
    # sectors per child (siblings of one char, neighbouring parents and lo
    # and hi of a narrow range share one) and the words one child loads
    # (lo's, and hi's where its block differs), beside the distinct
    # payloadR records the same children would need; for rank4, distinct
    # payloadR records per position; averaged over the launches
    ends = [(chs[j], lo[par[j].long()], hi[par[j].long()])
            for j, (lo, hi) in enumerate(fronts[:-1])]
    nbpad = sarr.payloadC.shape[1]
    tl = records["trie_level"]
    tl["sectors_per_child"] = sum(
        char_sectors_per_child(nbpad, *end) for end in ends) / levels
    tl["words_loaded_per_child"] = 1 + sum(
        float(((lo >> 5) != (hi >> 5)).float().mean())
        for _, lo, hi in ends) / levels
    tl["records_per_child"] = sum(
        records_per_item(lo, hi) for _, lo, hi in ends) / levels
    records["rank4"]["records_per_position"] = sum(
        records_per_item(p) for j in range(levels)
        for p in fronts[j]) / (2 * levels)
    phase("kernels", f"trie_level reads {tl['sectors_per_child']:.4f} "
          f"distinct payloadC sectors per child and level (one child loads "
          f"{tl['words_loaded_per_child']:.4f} words; payloadR would need "
          f"{tl['records_per_child']:.4f} records); rank4 "
          f"{records['rank4']['records_per_position']:.4f} payloadR records "
          f"per position")

    # expand + locate of the chunk's leaf ranges (torch operators)
    lo, hi = fronts[-1]
    counts = (hi - lo)[: len(uniq)]
    total = int(counts.clamp(min=0).sum().item())
    maps = finder._get_map_arrays()
    sa = finder._get_sa()
    ms_expand = cuda_ms(lambda: fm_trie.expand_locate(
        sa, maps.str_starts, maps.lengths, maps.seq_off, lo, hi,
        len(uniq), 2**31 - 1, finder.seed_len, total), PLAIN_REPS)
    phase("kernels", f"expand + locate of {total} occurrences: "
          f"{ms_expand:.3f} ms/chunk")
    extra = {"levels": levels, "npad": npad, "keys": len(uniq),
             "expand_locate_ms": ms_expand, "occurrences": total}
    return records, extra


def route_phase(finder, index) -> tuple[dict, dict, dict, dict, dict]:
    """The level routes and the backward search on chunk 1's keys, each
    through its entry point with the launch counters set to 0 just before
    and read just after. Returns the launch counts per kernel (from the
    route that runs it), (device, enqueued) ms per chunk per route, and
    the records of rank_lf_pair, of the per-query rank and of rank4 on
    the backward search's own inputs."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import fm_stream, fm_trie

    sarr = finder._get_stream_arrays()
    ftab = finder._get_ftab()
    uniq, prep = index._onpath_prep.uniq, index._onpath_prep.trie
    k = finder.seed_len
    levels = prep.parents.shape[0]
    p = k - levels
    routes = {
        "fused": dict(fused=True),
        "two-pass pair": dict(fused=False, pair=True),
        "two-pass unpaired": dict(fused=False, pair=False),
    }
    expect = {
        "fused": {"trie_level": levels},
        "two-pass pair": {"rank4_pair": levels, "compact": levels},
        "two-pass unpaired": {"rank4": 2 * levels, "compact": levels},
        "backward_search_sorted": {"rank_lf_pair": levels},
    }
    launches, ms = {}, {}
    leaves = {}
    for name, kw in routes.items():
        reset_counters()
        leaves[name] = fm_trie.trie_search(sarr, uniq, k, ftab=ftab,
                                           prepared=prep, **kw)
        got = read_counters()
        require(got == {**ZERO_COUNTS, **expect[name]},
                f"route {name} launched {got}, expected {expect[name]}")
        launches.update(expect[name])
        run = (lambda kw=kw: fm_trie._trie_device(
            sarr, prep.parents, prep.chars, prep.lo0, prep.hi0, **kw))
        ms[name] = (cuda_ms(run, ROUTE_REPS), enqueue_ms(run, ROUTE_REPS))
    for name in routes:
        for got, want in zip(leaves[name], leaves["fused"]):
            require(np.array_equal(got, want),
                    f"route {name}: leaf ranges differ from the fused route")

    # backward search over the keys' code rows from the ftab frontier
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    codes = ((uniq[:, None] >> shifts) & np.uint64(3)).astype(np.int32) + 1
    rows = ftab[(uniq >> np.uint64(2 * (k - p))).astype(np.int64)]
    dev = sarr.payloadT.device
    args = (torch.from_numpy(np.ascontiguousarray(codes[:, p:])).to(dev),
            torch.from_numpy(np.ascontiguousarray(rows[:, 0])).to(dev),
            torch.from_numpy(np.ascontiguousarray(rows[:, 1])).to(dev))
    torch.cuda.synchronize()
    reset_counters()
    blo, bhi = fm_stream.backward_search_sorted(sarr, *args)
    torch.cuda.synchronize()
    got = read_counters()
    require(got == {**ZERO_COUNTS, **expect["backward_search_sorted"]},
            f"backward_search_sorted launched {got}")
    launches.update(expect["backward_search_sorted"])
    run = lambda: fm_stream.backward_search_sorted(sarr, *args)  # noqa: E731
    ms["backward_search_sorted"] = (cuda_ms(run, ROUTE_REPS),
                                    enqueue_ms(run, ROUTE_REPS))

    # the LF-step kernel on its own path: every step's (chars, lo, hi) of
    # the backward search, replayed with the plain version; after the
    # first step these positions are scattered (random gathers)
    cols = args[0].t().contiguous()
    lo, hi = args[1], args[2]
    steps = []
    for j in range(cols.shape[0]):
        steps.append((cols[j], lo, hi))
        lo, hi = fm_stream.rank_lf_pair_plain(sarr, cols[j], lo, hi)
    require(max_abs_err(lo, blo) == 0 and max_abs_err(hi, bhi) == 0,
            "backward_search_sorted differs from its plain replay")
    pair_err = max(max(max_abs_err(g, w) for g, w in zip(
        fm_stream.rank_lf_pair(sarr, *step),
        fm_stream.rank_lf_pair_plain(sarr, *step))) for step in steps)
    require(pair_err == 0, f"rank_lf_pair differs from its plain version by "
            f"{pair_err} on the backward search's steps")
    # records read per key: one, and a second where hi's block differs
    records = sum(float(((lo >> 5) != (hi >> 5)).float().mean())
                  for _, lo, hi in steps) / len(steps) + 1
    shape = f"{len(uniq)} keys x {len(steps)} steps of backward_search_sorted"
    pair_rec = measure(
        "rank_lf_pair",
        lambda: [fm_stream.rank_lf_pair(sarr, *step) for step in steps],
        lambda: [fm_stream.rank_lf_pair_plain(sarr, *step) for step in steps],
        len(steps), [rank_lf_pair_work(*step) for step in steps], pair_err,
        shape, plain_reps=1, tag="routes")
    pair_rec["records_per_key"] = records
    phase("routes", f"rank_lf_pair reads {records:.4f} rank records (32-byte "
          f"sectors) per key and step")

    # the per-query rank (psi_tpu's rank_stream contract), which no route
    # of the port runs any more: a replay through its entry point on the
    # same steps' lo and hi, 2 launches a step, that checks the wrapper
    queries = [(c, pos) for c, lo, hi in steps for pos in (lo, hi)]
    torch.cuda.synchronize()
    reset_counters()
    ranked = [fm_stream.rank_stream(sarr, c, pos) for c, pos in queries]
    torch.cuda.synchronize()
    got = read_counters()
    require(got == {**ZERO_COUNTS, "rank": len(queries)},
            f"rank_stream over {len(queries)} arrays launched {got}")
    rank_err = max(max_abs_err(r, fm_stream.rank_plain(sarr.payloadT, c, pos))
                   for r, (c, pos) in zip(ranked, queries))
    require(rank_err == 0, f"rank differs from its plain version by "
            f"{rank_err} on the backward search's positions")
    rank_rec = measure(
        "rank",
        lambda: [fm_stream.rank_stream(sarr, c, pos) for c, pos in queries],
        lambda: [fm_stream.rank_plain(sarr.payloadT, c, pos)
                 for c, pos in queries],
        len(queries), [rank_work(c, pos) for c, pos in queries], rank_err,
        f"{len(uniq)} keys x {len(queries)} launches (lo and hi per step) of "
        f"backward_search_sorted", plain_reps=1, tag="routes")
    rank_rec["replay_launches"] = len(queries)

    # rank4 at the same scattered positions (its own path, the unpaired
    # two-pass route, gives it a frontier's near-sorted ones)
    positions = [pos for _, pos in queries]
    reset_counters()
    ranked = [fm_stream.rank4_stream(sarr, pos) for pos in positions]
    torch.cuda.synchronize()
    got = read_counters()
    require(got == {**ZERO_COUNTS, "rank4": len(positions)},
            f"rank4_stream over {len(positions)} arrays launched {got}")
    r4_err = max(max_abs_err(r, fm_stream.rank4_plain(sarr.payloadR, pos))
                 for r, pos in zip(ranked, positions))
    require(r4_err == 0, f"rank4 differs from its plain version by "
            f"{r4_err} on the backward search's positions")
    r4_rec = measure(
        "rank4 (backward-search positions)",
        lambda: [fm_stream.rank4_stream(sarr, pos) for pos in positions],
        lambda: [fm_stream.rank4_plain(sarr.payloadR, pos)
                 for pos in positions],
        len(positions), [rank4_work(pos) for pos in positions], r4_err,
        f"{len(uniq)} positions x {len(positions)} launches (lo and hi per "
        f"step) of backward_search_sorted", plain_reps=1, tag="routes")
    r4_rec["records_per_position"] = sum(
        records_per_item(pos) for pos in positions) / len(positions)
    phase("routes", f"rank4 reads {r4_rec['records_per_position']:.4f} "
          f"distinct rank records per position there")
    blo, bhi = blo.cpu().numpy(), bhi.cpu().numpy()
    tlo, thi = leaves["fused"]
    require(np.array_equal(bhi - blo, thi - tlo),
            "backward_search_sorted counts differ from the trie's")
    found = thi > tlo
    require(np.array_equal(blo[found], tlo[found]),
            "backward_search_sorted lo differs from the trie's")
    phase("routes", f"{len(uniq)} keys, {levels} levels from the p={p} "
          f"ftab: leaf ranges of the fused, paired and unpaired routes "
          f"equal; backward_search_sorted counts equal the trie's "
          f"({int(found.sum())} keys present); launches {launches}")
    for name, (dev_ms, enq) in ms.items():
        phase("routes", f"{name}: {dev_ms:.4f} ms/chunk on the device, "
              f"{enq:.4f} enqueued")
    return launches, ms, pair_rec, rank_rec, r4_rec


def _same_ranges(got, want) -> bool:
    """R3: equal hi - lo everywhere, equal lo where the range is not
    empty."""
    import numpy as np

    (lo, hi), (wlo, whi) = got, want
    found = whi > wlo
    return (np.array_equal(hi - lo, whi - wlo)
            and np.array_equal(lo[found], wlo[found]))


def seed_rows(arr):
    """Lexsorted int64 rows of a SEED_DTYPE array."""
    import numpy as np

    cols = np.stack([arr[f].astype(np.int64) for f in arr.dtype.names],
                    axis=1)
    return cols[np.lexsort(cols.T[::-1])]


def gather_phase(finder, reads, index) -> tuple[dict, dict, dict]:
    """The FM gather route on chunk 1: the three rank layouts, the LF-step
    kernel and the row gather on the route's own inputs at both table
    widths, the padded-table and blocked entry points, and the MEM API.
    Returns the row gather's record, the LF-step kernel's and the route
    facts."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import fm as fm_ops
    from psi_tpu_torch.ops import fm_pallas, fm_trie
    from psi_tpu_torch.seed_finder import SeedFinder

    fm = finder.pindex.fm
    k = finder.seed_len
    dev = finder.device
    uniq, prep = index._onpath_prep.uniq, index._onpath_prep.trie
    t0 = time.monotonic()
    arrays = finder._get_fm_arrays()
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    require(arrays.occ_dense is not None and arrays.ftab is not None,
            "the gather route did not take the dense layout with the ftab")
    p = (arrays.ftab.shape[0].bit_length() - 1) // 2
    steps = k - p
    codes = torch.from_numpy(fm_ops.keys_to_codes(uniq, k)).to(dev)
    phase("gather", f"dense occ [{fm.size + 1}, 4] built on the device in "
          f"{build_s:.3f} s; {len(uniq)} keys, ftab p={p}, {steps} LF steps")

    # the three rank layouts, each through backward_search_codes
    both = fm_ops.to_device(fm, dev, bitplanes=True, sa=arrays.sa)._replace(
        ftab=arrays.ftab)
    layouts = {"dense": arrays, "bit-plane": both,
               "checkpointed": both._replace(planes=None)}
    ranges, layout_ms = {}, {}
    for name, arr in layouts.items():
        reset_counters()
        lo, hi = fm_ops.backward_search_codes(arr, codes)
        torch.cuda.synchronize()
        got = read_counters()
        want = {**ZERO_COUNTS,
                "occ_lf_pair": steps if name == "dense" else 0}
        require(got == want, f"backward_search_codes ({name}) launched {got}")
        ranges[name] = (lo.cpu().numpy(), hi.cpu().numpy())
        # one sync per call (the code check), so time it on the host clock
        layout_ms[name] = enqueue_ms(
            lambda arr=arr: fm_ops.backward_search_codes(arr, codes),
            ROUTE_REPS)
    trie = fm_trie.trie_search(finder._get_stream_arrays(), uniq, k,
                               ftab=finder._get_ftab(), prepared=prep)
    for name in layouts:
        require(_same_ranges(ranges[name], trie),
                f"backward_search_codes ({name}) differs from the trie")
    found = int((trie[1] > trie[0]).sum())

    # every step's inputs of the dense route, replayed with the plain
    # version; after the first step the positions scatter over the text
    lf_steps, (lo, hi) = replay_lf_steps(arrays, codes, p)
    require(_same_ranges((lo.cpu().numpy(), hi.cpu().numpy()),
                         ranges["dense"]),
            "backward_search_codes differs from its plain replay")
    occ8_np = fm_pallas.occ_dense_padded(fm)
    tables = {4: arrays.occ_dense, 8: torch.from_numpy(occ8_np).to(dev)}

    # the LF-step kernel on every step at both widths
    lf_err, lf_variants = 0, {}
    for width, occ in tables.items():
        e = max(max(max_abs_err(g, w) for g, w in zip(
            fm_pallas.lf_pair(occ, arrays.C, *st),
            fm_pallas.lf_pair_plain(occ, arrays.C, *st)))
            for st in lf_steps)
        require(e == 0, f"occ_lf_pair W={width} differs from lf_pair_plain "
                f"by {e}")
        lf_err = max(lf_err, e)
        work = [occ_lf_pair_work(occ, *st) for st in lf_steps]
        run = (lambda occ=occ: [fm_pallas.lf_pair(occ, arrays.C, *st)
                                for st in lf_steps])
        rec = measure(
            f"occ_lf_pair W={width}", run,
            lambda occ=occ: [fm_pallas.lf_pair_plain(occ, arrays.C, *st)
                             for st in lf_steps],
            len(lf_steps), work, e,
            f"{len(lf_steps)} launches of {len(uniq)} keys (lo and hi per LF "
            f"step), table {tuple(occ.shape)}", tag="gather")
        rec["sectors_per_key"] = sum(
            occ_sectors(occ, *st) for st in lf_steps) / (
            len(lf_steps) * len(uniq))
        rec["busy_ms"] = busy_ms(run, len(lf_steps))
        phase("gather", f"occ_lf_pair W={width}: "
              f"{rec['sectors_per_key']:.4f} distinct table sectors per key "
              f"and step; device busy by the profiler "
              f"{1e3 * rec['busy_ms']:.3f} us/launch")
        lf_variants[f"W{width}"] = rec

    # the row gather on the same steps' positions, scattered as the route
    # gives them and sorted, as gather_occ_rows_blocked gives them
    positions = [torch.cat([lo, hi]) for _, lo, hi in lf_steps]
    orders = {"scattered": positions,
              "sorted": [torch.sort(q).values for q in positions]}
    err, variants = 0, {}
    for width, occ in tables.items():
        for order, pos in orders.items():
            e = max(max_abs_err(fm_pallas.gather_occ_rows(occ, q),
                                fm_pallas.gather_occ_rows_plain(occ, q))
                    for q in pos)
            e_lib = max(max_abs_err(torch.index_select(occ, 0, q),
                                    fm_pallas.gather_occ_rows_plain(occ, q))
                        for q in pos)
            require(e == 0 and e_lib == 0, f"occ_gather W={width} {order}: "
                    f"kernel {e}, index_select {e_lib} off the plain version")
            err = max(err, e)
            rec = measure(
                f"occ_gather W={width} {order}",
                lambda occ=occ, pos=pos: [fm_pallas.gather_occ_rows(occ, q)
                                          for q in pos],
                lambda occ=occ, pos=pos: [
                    fm_pallas.gather_occ_rows_plain(occ, q) for q in pos],
                len(pos), [occ_gather_work(occ, q) for q in pos], e,
                f"{len(pos)} launches of {positions[0].numel()} positions "
                f"(lo and hi per LF step), table {tuple(occ.shape)}",
                library=lambda occ=occ, pos=pos: [
                    torch.index_select(occ, 0, q) for q in pos],
                tag="gather")
            # the same three by the profiler's kernel times, gaps left out
            rec["busy_ms"] = {
                name: busy_ms(lambda f=f, pos=pos, occ=occ: [
                    f(occ, q) for q in pos], len(pos))
                for name, f in (
                    ("kernel", fm_pallas.gather_occ_rows),
                    ("plain", fm_pallas.gather_occ_rows_plain),
                    ("library", lambda o, q: torch.index_select(o, 0, q)))}
            phase("gather", f"occ_gather W={width} {order}, device busy by "
                  f"the profiler (us/launch): " + ", ".join(
                      f"{k} {1e3 * v:.3f}" for k, v in rec["busy_ms"].items()))
            rec["sector_bound_ms"], _, rec["sector_bytes"], _ = mean_bound(
                [occ_gather_sector_work(occ, q) for q in pos])
            rec["sectors_per_position"] = sum(
                row_sectors(occ.shape[1], q) for q in pos) / (
                len(pos) * pos[0].numel())
            phase("gather", f"occ_gather W={width} {order}: "
                  f"{rec['sectors_per_position']:.4f} distinct table sectors "
                  f"per position; sector bound "
                  f"{1e3 * rec['sector_bound_ms']:.3f} us "
                  f"({rec['sector_bytes'] / 1e6:.2f} MB/launch), byte bound "
                  f"{1e3 * rec['bound_ms']:.3f} us")
            variants[f"W{width} {order}"] = rec

    # psi_tpu's padded-table search (from the root) and blocked gather,
    # each through its entry point
    reset_counters()
    plo, phi = fm_pallas.backward_search_pallas(tables[8], arrays.C, fm.size,
                                                codes)
    got = read_counters()
    require(got == {**ZERO_COUNTS, "occ_lf_pair": k},
            f"backward_search_pallas launched {got}")
    require(_same_ranges((plo.cpu().numpy(), phi.cpu().numpy()), trie),
            "backward_search_pallas differs from the trie")
    q = positions[1].cpu().numpy()
    reset_counters()
    blocked = fm_pallas.gather_occ_rows_blocked(occ8_np, q, device=dev)
    blocked_launches = read_counters()
    require(blocked_launches == {**ZERO_COUNTS, "occ_gather": 1},
            f"gather_occ_rows_blocked launched {blocked_launches}")
    require(np.array_equal(blocked, occ8_np[q]),
            "gather_occ_rows_blocked differs from the table's rows")
    del tables[8]
    # device operations (kernels, copies, fills) of one dense search
    dense_ops = device_ops(lambda: fm_ops.backward_search_codes(arrays, codes))
    phase("gather", f"ranges of the dense, bit-plane and checkpointed "
          f"layouts and of backward_search_pallas equal the trie's ({found} "
          f"keys present); gather_occ_rows_blocked equal on "
          f"{len(q)} positions; the dense search ran {dense_ops} device "
          f"operations for {steps} LF steps")
    for name, t in layout_ms.items():
        phase("gather", f"backward_search_codes ({name}): {t:.4f} ms/chunk "
              f"(host clock, ends in a synchronize)")

    # the MEM API on the card and on the CPU (same index, paths, ftab)
    cpu = SeedFinder(finder.graph, k, device="cpu")
    cpu.pindex, cpu._path_map, cpu._ftab_np = (
        finder.pindex, finder._path_map, finder._ftab_np)
    reset_counters()
    t0 = time.monotonic()
    mems = finder.find_mems_arrays(reads)
    mem_s = time.monotonic() - t0
    mem_launches = read_counters()
    L = int(np.diff(reads.packed_view()[1]).max())
    require(mem_launches == {**ZERO_COUNTS, "occ_lf_pair": L},
            f"find_mems_arrays launched {mem_launches}, expected {L}")
    t0 = time.monotonic()
    mems_cpu = cpu.find_mems_arrays(reads)
    cpu_s = time.monotonic() - t0
    rows = seed_rows(mems)
    require(len(rows) > 0 and rows.tobytes() == seed_rows(mems_cpu).tobytes(),
            f"find_mems_arrays: cuda {len(mems)} rows, cpu {len(mems_cpu)}")
    scalar = []
    n_scalar = min(1000, len(reads))
    for rid, seq in enumerate(reads.seqs[:n_scalar]):
        finder.seeds_on_paths_seq(seq, lambda h, r=rid: scalar.append(
            (h.node_id, h.node_offset, r, h.read_offset, h.match_len,
             h.gocc)))
    scalar = np.array(scalar, dtype=np.int64).reshape(-1, 6)
    scalar = scalar[np.lexsort(scalar.T[::-1])]
    require(np.array_equal(scalar, rows[rows[:, 2] < n_scalar]),
            "find_mems_arrays differs from seeds_on_paths_seq")
    phase("gather", f"find_mems_arrays over {len(reads)} reads: {len(mems)} "
          f"MEM hits, {mem_s:.3f} s on cuda ({L} launches of occ_lf_pair), "
          f"{cpu_s:.3f} s on cpu, equal; first {n_scalar} reads equal "
          f"seeds_on_paths_seq ({len(scalar)} hits)")
    rec = dict(variants["W4 scattered"])
    rec["variants"] = variants
    rec["max_abs_err"] = err
    lf_rec = dict(lf_variants["W4"])
    lf_rec["variants"] = lf_variants
    lf_rec["max_abs_err"] = lf_err
    facts = {"steps": steps, "dense_build_s": build_s,
             "layout_ms_per_chunk": layout_ms, "keys_present": found,
             "dense_device_ops": dense_ops,
             "blocked_launches": blocked_launches["occ_gather"],
             "mems": {"reads": len(reads), "hits": len(mems),
                      "launches": L, "cuda_s": mem_s, "cpu_s": cpu_s}}
    return rec, lf_rec, facts


# --- phase 7: the off-path traversal ----------------------------------------

@contextlib.contextmanager
def recorded(module, name: str):
    """Within the block, `module.name` is a recorder that keeps each
    call's arguments and calls the wrapper. The wrapper's body counts
    its launches on the module attribute, so the recorder carries the
    count and hands it back at the end."""
    orig = getattr(module, name)
    counted = hasattr(orig, "launches")
    calls = []

    def recorder(*args):
        calls.append(args)
        return orig(*args)

    if counted:
        recorder.launches = orig.launches
    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, orig)
        if counted:
            orig.launches = recorder.launches


@contextlib.contextmanager
def plain_steps():
    """Within the block, traverse_device steps with traverse_step_plain:
    on the card, the plain step's torch operations and
    range_refine_plain's, launched one by one."""
    from psi_tpu_torch.ops import traverse as trav

    orig = trav.traverse_step
    trav.traverse_step = trav.traverse_step_plain
    try:
        yield
    finally:
        trav.traverse_step = orig


def wall_ms(fn, reps: int) -> float:
    """Mean host milliseconds of fn(), which ends in a download (so in a
    synchronize), after one warm-up run."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def refine4_work(seeds, depth, lo, hi):
    """lo and hi read, the four (lo', hi') pairs written; the seeds index
    (k depths of occ rows and plane words, a few MB) stays in L2 and is
    not counted. Operations: two blocks' four masked popcounts and the
    prefix sum, counted from the kernel source."""
    return nbytes(lo, hi) * 5, 40 * lo.numel()


def approx_packed(finder, g, sa, k: int, device):
    """traverse_device_packed with one mismatch on `device`, the cap
    doubled from the route's until it does not overflow, as the finder's
    collect does: (packed int64 vector on the host, final cap, attempts)."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import traverse as trav

    sn, so = finder._get_loci_np()
    n = len(sn)
    cap = max(1 << 15, 1 << (n - 1).bit_length())
    attempts = 0
    while True:
        attempts += 1
        starts = np.zeros((2, cap), dtype=np.int32)
        starts[0, :n], starts[1, :n] = sn, so
        snd, sod = (torch.from_numpy(a).to(device) for a in starts)
        packed = trav.traverse_device_packed(g, sa, snd, sod, n, k, cap,
                                             1).cpu().numpy()
        if not packed[3 * cap + 1]:
            return packed, cap, attempts
        cap *= 2


def host_ms(fn, reps: int) -> float:
    """Mean host milliseconds that fn() takes to return, each run started
    on an idle card: for a function with no host sync, what it costs to
    enqueue its work."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total * 1e3 / reps


def peak_mb(fn) -> float:
    """Device memory that one fn() allocates at its peak beyond what was
    allocated before it (torch.cuda.max_memory_allocated), in MB."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def step_work(n_used: int, new_n: int, n2: int, cap: int):
    """One traverse_step launch: (bytes, operations, live bytes). The
    live parents' five int32 fields read and every slot of the next
    state written (the contract writes the whole cap, padding included);
    the live bytes count the survivors' slots only. The graph arrays and
    the seeds index stay in L2 and are not counted. Operations: about 60
    integer operations per child formed (edge and label indexing, the
    rank's four masked popcounts at each end and the char pick), counted
    from the kernel source."""
    formed = min(new_n, cap)
    return 20 * n_used + 20 * cap, 60 * formed, 20 * n_used + 20 * n2


def step_table_work(g, seeds, t, state, n_used, cap):
    """(bytes, sector bytes) of the graph and seeds tables that one
    traverse_step reads, for a graph and a seeds index past L2: each
    element read once, or each distinct 32-byte sector those elements
    lie in. The live parents' label offsets and edge offsets, the edges
    of those at a node's end, the label char and label offset of every
    child formed, and the occ row and plane words of the block of its lo
    and of its hi at depth t; step_work counts the state."""
    import torch

    from psi_tpu_torch.ops import traverse as trav
    from psi_tpu_torch.records import BLOCK

    dev = state.node.device
    slot = torch.arange(cap, dtype=torch.int64, device=dev)
    new_n, parent, node, off, _ = trav._fork(g, state.node, state.off,
                                             n_used, slot, cap)
    n, m = int(n_used), min(int(new_n), cap)
    pn = state.node[:n].long().clamp(min=1)
    at_end = state.off[:n].long() >= (g.label_offsets[pn].long()
                                      - g.label_offsets[pn - 1].long())
    ends = pn[at_end]
    first, last = g.out_indptr[ends - 1].long(), g.out_indptr[ends].long()
    edges = (torch.repeat_interleave(first, last - first)
             + torch.arange(int((last - first).sum()), device=dev)
             - torch.repeat_interleave(torch.cumsum(last - first, 0)
                                       - (last - first), last - first))
    cn, par = node[:m].long().clamp(min=1), parent[:m]
    rows = t * seeds.occ.shape[1] + torch.cat(
        [state.lo[par], state.hi[par]]).long() // BLOCK
    tables = {"label_offsets": (4, torch.cat([pn - 1, pn, cn - 1])),
              "out_indptr": (4, torch.cat([pn - 1, pn])),
              "out_indices": (4, edges),
              "labels": (4, g.label_offsets[cn - 1].long() + off[:m].long()),
              "occ": (16, rows), "planes": (8, rows)}
    elems = sum(size * n_unique(idx) for size, idx in tables.values())
    sectors = sum(32 * n_unique((size * idx) >> 5)
                  for size, idx in tables.values())
    return elems, sectors


def traversal_record(finder, index, k: int, tag: str):
    """The exact device traversal over the finder's loci and the chunk's
    seeds index on the card, the cap doubled from the route's until it
    fits, as the finder's collect does. Each attempt runs under sync
    debug mode "error" with the counters set to 0 just before and read
    just after: k traverse_step launches and nothing else. Then
    traverse_step against traverse_step_plain at every step's inputs of
    the final attempt, over the whole cap, and both forms timed: wall
    (host clock to a synchronize), device busy (torch.profiler),
    enqueued per step, peak memory; the kernel's device time per step by
    CUDA events beside its bound. Returns (record, outputs on the host)."""
    import torch

    from psi_tpu_torch.ops import traverse as trav

    n = len(finder.starting_loci)
    g = finder._get_graph_arrays()
    sa = trav.seeds_to_device(index, finder.device)
    cap = max(1 << 15, 1 << (n - 1).bit_length())
    attempts = 0
    while True:
        attempts += 1
        sn_d, so_d = finder._get_loci_device(cap)
        torch.cuda.synchronize()
        reset_counters()
        with recorded(trav, "traverse_step") as calls:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = trav.traverse_device(g, sa, sn_d, so_d, n, k, cap)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            got = read_counters()
        require(got == {**ZERO_COUNTS, "traverse_step": k},
                f"traverse_device launched {got}, expected {k} traverse_step")
        out = tuple(a.cpu().numpy() for a in out)
        if not out[4]:
            break
        cap *= 2
    err, steps = 0, []
    for c in calls:
        (gs, *gc), (ws, *wc) = (trav.traverse_step(*c),
                                trav.traverse_step_plain(*c))
        err = max(err, *(max_abs_err(a, b)
                         for a, b in zip((*gs, *gc), (*ws, *wc))))
        steps.append((int(c[4]), int(wc[0]), int(wc[1])))
    require(err == 0, f"traverse_step differs from its plain version by {err}")

    def fused():
        return trav.traverse_device(g, sa, sn_d, so_d, n, k, cap)

    def plain():
        with plain_steps():
            return trav.traverse_device(g, sa, sn_d, so_d, n, k, cap)

    forms = {}
    for name, fn in (("fused", fused), ("plain", plain)):
        forms[name] = {
            "peak_mb": peak_mb(fn),
            "wall_ms": wall_ms(lambda: (fn(), torch.cuda.synchronize()), 3),
            "busy_ms": busy_ms(fn, 1),
            "enqueued_us_per_step": 1e3 * host_ms(fn, 3) / k,
        }
    # the fused form's device time by CUDA events too, beside the
    # profiler's sum (the plain form's ~4,400 launches a traversal overrun
    # the launch queue that the events' spin kernel needs)
    forms["fused"]["device_ms"] = cuda_ms(fused, 3)
    forms["plain"]["device_ops_per_step"] = device_ops(
        lambda: trav.traverse_step_plain(*calls[0]))
    kernel_ms = cuda_ms(lambda: [trav.traverse_step(*c) for c in calls],
                        5) / k
    work = [step_work(nu, nn, n2, cap) for nu, nn, n2 in steps]
    bound_ms, bound_by, bytes_moved, ops = mean_bound(
        [(b, o) for b, o, _ in work])
    live_bound_ms = bound(sum(w[2] for w in work) / k, ops)[0]
    tables = [step_table_work(*c) for c in calls]
    table_bytes = bytes_moved + sum(b for b, _ in tables) / k
    table_sector_bytes = bytes_moved + sum(sb for _, sb in tables) / k
    hbm_bound_ms, hbm_bound_by = bound(table_bytes, ops)
    sector_bound_ms, _ = bound(table_sector_bytes, ops)
    rec = {"max_abs_err": err, "ms": kernel_ms,
           "enqueued_ms": forms["fused"]["enqueued_us_per_step"] / 1e3,
           "plain_ms": forms["plain"]["busy_ms"] / k, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved,
           "ops": ops, "live_bound_ms": live_bound_ms,
           "hbm_bound_ms": hbm_bound_ms, "hbm_bound_by": hbm_bound_by,
           "hbm_bytes": table_bytes, "sector_bound_ms": sector_bound_ms,
           "sector_bytes": table_sector_bytes,
           "shape": f"{cap} slots x {k} steps of traverse_device, {n} loci",
           "loci": n, "cap": cap, "attempts": attempts, "survivors":
           int(out[3]), "steps": steps, "forms": forms}
    f, p = forms["fused"], forms["plain"]
    phase(tag, f"traverse_device over {n} loci: cap {cap} after {attempts} "
          f"attempt(s), {rec['survivors']} survivors; {k} traverse_step "
          f"launches an attempt and nothing else, no host sync in its steps;"
          f" traverse_step bit-equal to plain at all {k} steps over the "
          f"whole cap (live parents {steps[0][0]} .. {steps[-1][0]})")
    phase(tag, f"traverse_step: {1e3 * kernel_ms:.3f} us/step on the device "
          f"(enqueued {f['enqueued_us_per_step']:.3f}, plain busy "
          f"{1e3 * rec['plain_ms']:.3f}); bound {1e3 * bound_ms:.3f} us by "
          f"{bound_by} ({bytes_moved / 1e6:.2f} MB/step), live-only "
          f"{1e3 * live_bound_ms:.3f} us; with the graph and seeds tables "
          f"read from HBM {1e3 * hbm_bound_ms:.3f} us by {hbm_bound_by} "
          f"({table_bytes / 1e6:.2f} MB/step), by their sectors "
          f"{1e3 * sector_bound_ms:.3f} us "
          f"({table_sector_bytes / 1e6:.2f} MB/step)")
    for name, fm in forms.items():
        events = (f", device by events {fm['device_ms']:.3f} ms"
                  if "device_ms" in fm else
                  f", {fm['device_ops_per_step']} device operations a step")
        phase(tag, f"{name} traversal: wall {fm['wall_ms']:.3f} ms, device "
              f"busy {fm['busy_ms']:.3f} ms{events}, enqueued "
              f"{fm['enqueued_us_per_step']:.2f} us/step, peak "
              f"{fm['peak_mb']:.1f} MB")
    return rec, out


def offpath_phase(finder, index) -> tuple[dict, dict, dict, dict]:
    """The off-path traversal on chunk 1: the WalkTree probes, the exact
    (fused, traverse_step) and the mismatch-tolerant device traversals,
    and range_refine4 on its inputs. Returns the records of range_refine4
    and traverse_step and the phase's facts."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import traverse as trav

    k = finder.seed_len
    dev = finder.device
    keys = index.sorted_keys
    n = len(finder.starting_loci)
    t_phase = t0 = time.monotonic()
    dtree = finder._get_trav_tree()
    tree = finder._trav_tree[1]
    require(dtree is not None, "the cell's WalkTree exceeds its cap")
    host = trav.walks_match(tree, keys)
    probe = trav.walks_match_device(dtree, keys)
    require(all(np.array_equal(a, b) for a, b in zip(host, probe)),
            "the device WalkTree probe differs from the host probe")
    phase("offpath", f"{n} loci, WalkTree of {tree.n_nodes} nodes (built "
          f"and uploaded in {time.monotonic() - t0:.2f} s); {len(host[0])} "
          f"surviving states; device probe equal to the host probe")

    # the exact traversal, one traverse_step a step, against the probe
    g = finder._get_graph_arrays()
    sa = trav.seeds_to_device(index, dev)
    step_rec, (li, lo, hi, nu, ov, ts) = traversal_record(finder, index, k,
                                                          "offpath")
    cap = step_rec["cap"]
    nu = int(nu)
    require(np.array_equal(li[:nu], host[0])
            and np.array_equal(lo[:nu], host[1])
            and np.array_equal(hi[:nu], host[2])
            and tuple(int(v) for v in ts) == host[3:],
            "traverse_device differs from the WalkTree probe")
    phase("offpath", f"traverse_device at cap {cap}: {nu} survivors, order "
          f"and TraverserStats {tuple(int(v) for v in ts)} equal to the "
          f"probe's")

    # the rank inputs of the plain step's traversal on the card, on which
    # range_refine4's plain version counts its operations below
    sn_d, so_d = finder._get_loci_device(cap)
    with plain_steps(), recorded(trav, "range_refine_plain") as calls:
        trav.traverse_device(g, sa, sn_d, so_d, n, k, cap)
    calls = list(calls)
    require(len(calls) == k, f"the plain traversal ran {len(calls)} ranks")

    # the three off-path forms of one chunk, each as the route pays it
    forms = {
        "host probe": lambda: trav.walks_match(tree, keys),
        "device probe": lambda: trav.walks_match_device(dtree, keys),
        "device traversal": lambda: trav.traverse_device_packed(
            g, trav.seeds_to_device(index, dev), sn_d, so_d, n, k,
            cap).cpu(),
    }
    form_ms = {name: wall_ms(fn, 3) for name, fn in forms.items()}
    busy = {name: busy_ms(fn, 1) for name, fn in forms.items()
            if name != "host probe"}
    cols_ms = wall_ms(lambda: trav.traverse_columnar_from_states(
        index, finder.starting_loci, *host[:3], k), 3)
    for name, t in form_ms.items():
        phase("offpath", f"{name}: {t:.3f} ms/chunk (host clock)"
              + (f", device busy {busy[name]:.3f} ms" if name in busy
                 else ""))
    phase("offpath", f"hit columns from the survivors: {cols_ms:.3f} ms")

    # the mismatch-tolerant traversal, m = 1, on the card and on the CPU
    reset_counters()
    with recorded(trav, "range_refine4") as calls4:
        t0 = time.monotonic()
        packed, cap4, attempts = approx_packed(finder, g, sa, k, dev)
        approx_s = time.monotonic() - t0
        got = read_counters()
    require(got == {**ZERO_COUNTS, "range_refine4": k * attempts,
                    "traverse_step_approx": k * attempts},
            f"traverse_device_approx launched {got}, expected "
            f"{k * attempts} range_refine4 and traverse_step_approx")
    t0 = time.monotonic()
    cpu_packed, cpu_cap, _ = approx_packed(
        finder, trav.graph_to_device(finder.graph, "cpu"),
        trav.seeds_to_device(index, "cpu"), k, "cpu")
    cpu_s = time.monotonic() - t0
    require(cpu_cap == cap4 and np.array_equal(packed, cpu_packed),
            "traverse_device_approx on cuda differs from it on the cpu")
    last = calls4[-k:]
    err4 = max(max(max_abs_err(a, b) for a, b in zip(
        trav.range_refine4(*c), trav.range_refine4_plain(*c))) for c in last)
    require(err4 == 0, f"range_refine4 differs from its plain version by "
            f"{err4}")
    rec4 = measure(
        "range_refine4", lambda: [trav.range_refine4(*c) for c in last],
        lambda: [trav.range_refine4_plain(*c) for c in last], k,
        [refine4_work(*c) for c in last], err4,
        f"{cap4} slots x {k} steps of traverse_device_approx (m=1)",
        plain_reps=1, tag="offpath")
    # operations a step do not depend on the count; the profiler dropped
    # most of them at 2^20 slots, so count on the exact traversal's step
    rec4["plain_ops_per_step"] = device_ops(
        lambda: trav.range_refine4_plain(*calls[0][:4]))
    rec4["launches_per_traversal"] = k * attempts
    n_approx = int(packed[3 * cap4])
    phase("offpath", f"traverse_device_approx (m=1): cap {cap4} after "
          f"{attempts} attempts, {n_approx} survivors, {approx_s:.3f} s on "
          f"cuda ({k * attempts} range_refine4 launches), {cpu_s:.3f} s on "
          f"cpu, equal; range_refine4 plain: {rec4['plain_ops_per_step']} "
          f"device operations a step; phase {time.monotonic() - t_phase:.1f} "
          f"s")
    facts = {"loci": n, "tree_nodes": tree.n_nodes, "survivors": nu,
             "cap": cap, "form_ms_per_chunk": form_ms,
             "form_busy_ms": busy, "columns_ms": cols_ms,
             "approx": {"cap": cap4, "attempts": attempts,
                        "survivors": n_approx, "cuda_s": approx_s,
                        "cpu_s": cpu_s}}
    return rec4, step_rec, facts


# --- phase 20: the approximate step at the mm1 cell's shape -------------------

#: g1k_common.mm1's graph and chunk, made by the port's own generators at
#: the values of that benchmark cell (seedbench/configs/g1k_common_mm1.json,
#: seedbench/traffic/mm1.json): a 5 Mbp reference with a bubble every
#: ~360 bp, 4% of them insertions, 4 haplotypes, 2,000 reads of 100 bp
#: with 1% substitutions, k = 20 with one substitution, 2 unpatched paths
MM1_REF_LEN = 5_000_000
MM1_VARIANT_RATE = 0.0028
MM1_INDEL_FRAC = 0.04
MM1_CHUNK = 2_000
MM1_SEEDS = (5, 7, 11)  # graph, haplotypes, reads
APPROX_REPS = 3  # traversals per timing: 20 steps of a few launches each


def approx_step_work(n_used: int, n2: int, cap: int):
    """One traverse_step_approx_kernel launch: (bytes, operations, bytes
    of the whole cap). Per live parent its 24 bytes of state (locus,
    node, offset, lo, hi, budget: lo and hi read by range_refine4 just
    before) and its 32-byte lo4 / hi4 row read, 24 bytes written per
    survivor inside the cap, as traverse_step's bound counts live states
    only; the whole-cap figure writes every slot of the cap instead, the
    padding the contract fills included. The graph arrays stay in L2 and
    are not counted. Operations: about 40 integer operations a live
    parent (edge and label indexing, the four chars' masks), counted
    from the kernel source."""
    live = min(n_used, cap)
    return 56 * live + 24 * min(n2, cap), 40 * live, 48 * live + 24 * cap


def approx_step_inputs(tmp: str, device="cuda"):
    """The mm1 cell's graph and first chunk (MM1_*), written as GFA and
    FASTQ and read back as the CLI reads them: a SeedFinder on `device`
    with one substitution a seed, the CLI's starting loci (N_PATHS paths
    unpatched, the uncovered-loci scan; no FM index) and the chunk's
    seeds index. Returns (finder, index)."""
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.io.fastq import FastxStream
    from psi_tpu_torch.pathutil import sequence
    from psi_tpu_torch.records import Records
    from psi_tpu_torch.seed_finder import SeedFinder
    from psi_tpu_torch.simulate import make_pangenome_graph
    from psi_tpu_torch.tools.bacterial import write_gfa, write_reads
    from psi_tpu_torch.tools.ggsim import simulate_haplotypes

    gseed, hseed, rseed = MM1_SEEDS
    graph = make_pangenome_graph(MM1_REF_LEN, MM1_VARIANT_RATE,
                                 indel_frac=MM1_INDEL_FRAC, seed=gseed)
    gfa, fastq = (os.path.join(tmp, f"mm1.{ext}") for ext in ("gfa", "fastq"))
    write_gfa(graph, gfa)
    haps = [sequence(h) for _, h in simulate_haplotypes(graph, 4, seed=hseed)]
    write_reads(haps, fastq, MM1_CHUNK, seed=rseed)
    finder = SeedFinder(load_graph(gfa), SEED_LEN, seed_mismatches=1,
                        device=device)
    finder.pick_paths(N_PATHS, patched=False)
    finder.add_uncovered_loci(1)
    names, packed = FastxStream(fastq).read_chunk_packed(MM1_CHUNK)
    reads = Records(names, rec_offset=0, packed=packed)
    return finder, finder.index_reads(finder.get_seeds(reads))


def approx_step_phase(tmp: str) -> tuple[dict, dict]:
    """[approx-step]: traverse_step_approx at the shape of g1k_common.mm1
    (approx_step_inputs): the approximate traversal from the route's cap,
    doubled until it fits, each attempt's k steps under sync debug mode
    "error" with the launch counters set to 0 before the first and read
    after the last (k traverse_step_approx and k range_refine4 an
    attempt, nothing else); the kernel against traverse_step_approx_plain
    at every step of every attempt, over the whole cap; per cap, by CUDA
    events, the kernel's device us a launch (each launch right after its
    range_refine4, events around the kernel alone), range_refine4's, the
    whole step's and the plain step's, and the step's enqueued us, beside
    the kernel's bound; a kernel time of 0 or below its bound fails.
    Returns (record, facts)."""
    import torch

    from psi_tpu_torch.ops import traverse as trav

    tag = "approx-step"
    t_phase = time.monotonic()
    workdir = os.path.join(tmp, "approx_step")
    os.makedirs(workdir, exist_ok=True)
    finder, index = approx_step_inputs(workdir)
    k, mm = finder.seed_len, finder.seed_mismatches
    n = len(finder.starting_loci)
    g = finder._get_graph_arrays()
    sa = trav.seeds_to_device(index, finder.device)
    phase(tag, f"g1k_common.mm1's shape: {n} loci, {index.size} seeds in "
          f"{MM1_CHUNK} reads; set-up {time.monotonic() - t_phase:.1f} s")

    cap = max(1 << 15, 1 << (n - 1).bit_length())
    attempts = []
    reset_counters()
    with recorded(trav, "traverse_step_approx") as calls:
        while True:
            sn_d, so_d = finder._get_loci_device(cap)
            torch.cuda.synchronize()
            first = len(calls)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = trav.traverse_device_approx(g, sa, sn_d, so_d, n, k,
                                                  cap, mm)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            attempts.append((cap, calls[first:]))
            if not bool(out[4].cpu()):
                break
            cap *= 2
    got = read_counters()
    steps = k * len(attempts)
    require(got == {**ZERO_COUNTS, "range_refine4": steps,
                    "traverse_step_approx": steps},
            f"traverse_device_approx launched {got}, expected {steps} "
            f"range_refine4 and traverse_step_approx")
    survivors = int(out[3].cpu())

    err, per_cap = 0, []
    for cap_a, calls_a in attempts:
        counts = []
        for c in calls_a:
            (gs, *gc), (ws, *wc) = (trav.traverse_step_approx(*c),
                                    trav.traverse_step_approx_plain(*c))
            err = max(err, *(max_abs_err(a, b)
                             for a, b in zip((*gs, *gc), (*ws, *wc))))
            counts.append((int(c[4]), int(wc[0]), int(wc[1])))
        require(err == 0, f"traverse_step_approx differs from its plain "
                f"version by {err} at cap {cap_a}")
        n_used = [torch.as_tensor(c[4], dtype=torch.int64, device=sa.occ.device)
                  for c in calls_a]

        def refine(j, calls_a=calls_a):
            _, seeds, t, st, _, _ = calls_a[j]
            return trav.range_refine4(seeds, t, st.lo, st.hi)

        def kernel(j, rows, calls_a=calls_a, n_used=n_used):
            g_, _, _, st, _, cap_ = calls_a[j]
            return trav._launch_step_approx(g_, st, *rows, n_used[j], cap_)

        def fused(calls_a=calls_a):
            return [trav.traverse_step_approx(*c) for c in calls_a]

        work = [approx_step_work(nu, n2, cap_a) for nu, _, n2 in counts]
        bound_ms, bound_by, bytes_moved, ops = mean_bound(
            [(b, o) for b, o, _ in work])
        cap_bound_ms = bound(sum(w[2] for w in work) / k, ops)[0]
        ms = bracketed_ms(refine, kernel, k, APPROX_REPS)
        per_cap.append({
            "cap": cap_a, "steps": counts, "ms": ms,
            "range_refine4_ms": cuda_ms(
                lambda: [refine(j) for j in range(k)], APPROX_REPS) / k,
            "step_ms": cuda_ms(fused, APPROX_REPS) / k,
            "enqueued_ms": host_ms(fused, APPROX_REPS) / k,
            "plain_ms": sum(cuda_ms(
                lambda c=c: trav.traverse_step_approx_plain(*c), 2)
                for c in calls_a) / k,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": bytes_moved, "ops": ops, "cap_bound_ms": cap_bound_ms,
        })
        r = per_cap[-1]
        phase(tag, f"cap {cap_a}: bit-equal to plain at all {k} steps over "
              f"the whole cap (live parents {counts[0][0]} .. "
              f"{counts[-1][0]}, overflow "
              f"{'yes' if cap_a != cap else 'no'}); kernel "
              f"{1e3 * ms:.3f} us/launch on the device (range_refine4 "
              f"{1e3 * r['range_refine4_ms']:.3f}, the step "
              f"{1e3 * r['step_ms']:.3f}), enqueued "
              f"{1e3 * r['enqueued_ms']:.3f} us/step, plain "
              f"{1e3 * r['plain_ms']:.3f} us/step; bound "
              f"{1e3 * bound_ms:.3f} us by {bound_by} "
              f"({bytes_moved / 1e6:.3f} MB/launch), with the whole cap "
              f"written {1e3 * cap_bound_ms:.3f} us")
        require(ms > 0 and ms >= bound_ms,
                f"traverse_step_approx at cap {cap_a}: {1e3 * ms:.3f} us a "
                f"launch, not above its bound {1e3 * bound_ms:.3f} us")
    last = per_cap[-1]
    rec = {"max_abs_err": err, **{key: last[key] for key in (
        "ms", "enqueued_ms", "plain_ms", "bound_ms", "bound_by", "bytes",
        "ops", "cap_bound_ms")}, "library_ms": None,
           "shape": f"{cap} slots x {k} steps of traverse_device_approx "
                    f"(m={mm}), {n} loci of g1k_common.mm1's shape, the "
                    f"final of {len(attempts)} attempts", "caps": per_cap}
    facts = {"loci": n, "seeds": index.size, "attempts": len(attempts),
             "cap": cap, "survivors": survivors,
             "phase_s": time.monotonic() - t_phase}
    phase(tag, f"{n} loci: caps {[c for c, _ in attempts]}, {survivors} "
          f"survivors; {steps} traverse_step_approx and range_refine4 "
          f"launches, no host sync in any attempt's steps; phase "
          f"{facts['phase_s']:.1f} s")
    del finder, index, sa, g, attempts, calls
    torch.cuda.empty_cache()
    return rec, facts


# --- phases 8 to 11: the CLI ---------------------------------------------------

#: psikt's flags of the bacterial cell: k = 20, 2 unpatched paths
BACTERIAL_FLAGS = ("-l", str(SEED_LEN), "-n", str(N_PATHS), "-P")


def run_cli(gfa: str, fastq: str, tmp: str, device: str, chunk: int,
            tag: str = "", extra: tuple = (), flags: tuple = BACTERIAL_FLAGS):
    """psikt on one cell (`flags`: its seed length and paths) through the
    CLI's entry point: (lexsorted hits, report, wall seconds)."""
    import numpy as np

    from psi_tpu_torch import cli

    out = os.path.join(tmp, f"hits_{device}{tag}.bin")
    report = os.path.join(tmp, f"report_{device}{tag}.json")
    t0 = time.monotonic()
    rc = cli.main([gfa, "-f", fastq, *flags, "-c", str(chunk), "--device",
                   device, "-o", out, "--report", report, "-q", "-Q",
                   *extra])
    wall = time.monotonic() - t0
    require(rc == 0, f"cli --device {device} returned {rc}")
    with open(report) as fh:
        rep = json.load(fh)
    hits = np.fromfile(out, dtype="<i8").reshape(-1, 4)
    hits = hits[np.lexsort(hits.T[::-1])]
    return hits, rep, wall


@contextlib.contextmanager
def env(name: str, value: str):
    """The variable set around the block only."""
    os.environ[name] = value
    try:
        yield
    finally:
        del os.environ[name]


def head_fastq(src: str, dst: str, n: int) -> str:
    """The first n records of a four-line FASTQ, written to dst."""
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        for _ in range(4 * n):
            fout.write(fin.readline())
    return dst


def summarize(rep: dict, device: str, wall: float) -> dict:
    """Per-chunk lines and the sustained rates of one CLI run; `device`
    names the phase (cli-<device>)."""
    chunks = rep["chunks"]
    on = sum(c["hits_on"] for c in chunks)
    off = sum(c["hits_off"] for c in chunks)
    phase(f"cli-{device}", f"{len(chunks)} chunks, {rep['seedhits']} hits "
          f"({on} on path, {off} off path), {rep['locino']} loci, "
          f"pindex {rep['pindexsize']} chars, wall {wall:.1f} s")
    for i, c in enumerate(chunks, 1):
        phase(f"cli-{device}",
              f"chunk {i}: {c['keys']} keys, {c['seeds']} seeds; on-path "
              f"{c['onpath_s']:.4f} s, off-path {c['offpath_s']:.4f} s, "
              f"query {c['query_s']:.4f} s; producer {c['produce_s']:.4f} s,"
              f" prepare {c['prepare_s']:.4f} s, prep wait "
              f"{c['prep_wait_s']:.4f} s")
    res = {"hits_on": on, "hits_off": off, "chunks": chunks}
    if len(chunks) >= 3:
        span = chunks[-1]["t_done_s"] - chunks[0]["t_done_s"]
        keys = sum(c["keys"] for c in chunks[1:])
        hits = sum(c["hits_on"] + c["hits_off"] for c in chunks[1:])
        res["kmer_queries_per_s"] = keys / span
        res["hits_per_s"] = hits / span
        phase(f"cli-{device}", f"sustained over chunks 2-{len(chunks)}: "
              f"{keys / span:.1f} kmer-queries/s, {hits / span:.1f} hits/s")
    return res


# --- phase 15: the off-path traversal at scale ------------------------------

def offpath_scale_phase(tmp: str, n_reads: int) -> tuple[dict, dict, int]:
    """[offpath-scale]: the dense cell (tools/dense.py), where the WalkTree
    exceeds its cap and traverse_device is the route: (a) the traversal,
    fused and plain, traverse_step bit-equal to plain at every step;
    (d) the WalkTree probe with PSI_TRAV_CACHE_CAP raised past the tree,
    timed beside the fused traversal as the route runs it, and equal to
    it; (b) the CLI on one chunk (trie_level and traverse_step only),
    then cuda = cpu on its first reads; (c) the traversal alone at 10^6
    loci or more. Returns (traverse_step's record on the dense cell, the
    phase's facts, traverse_step launches of the dense CLI run)."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import traverse as trav
    from psi_tpu_torch.tools import dense

    tag = "offpath-scale"
    t_phase = t0 = time.monotonic()
    gfa, fastq = dense.make_dense(tmp, dense.REF_LEN, dense.VARIANT_RATE,
                                  n_reads)
    finder, index = dense.offpath_inputs(gfa, fastq, "cuda", n_reads)
    n, k = len(finder.starting_loci), finder.seed_len
    made_s = time.monotonic() - t0
    t0 = time.monotonic()
    require(finder._get_trav_tree() is None,
            "the dense cell's WalkTree fits its cap")
    attempt_s = time.monotonic() - t0
    require(n >= DENSE_MIN_LOCI, f"the dense cell has {n} loci, under "
            f"{DENSE_MIN_LOCI}")
    phase(tag, f"dense cell ({dense.REF_LEN} bp, variant rate "
          f"{dense.VARIANT_RATE}): {n} loci, {index.size} seeds of "
          f"{n_reads} reads (made and loaded in {made_s:.1f} s); the WalkTree "
          f"build gives up past its cap of {trav.NODE_CAP} nodes after "
          f"{attempt_s:.2f} s, once per loci set (the CLI's chunk 1 pays it "
          f"in its off-path leg)")

    # (a) the traversal, fused and plain
    rec, (li, lo, hi, nu, _, ts) = traversal_record(finder, index, k, tag)
    nu, cap, n_seeds = int(nu), rec["cap"], index.size

    # (d) the WalkTree probe with the cap raised: a measurement, not a route
    with env("PSI_TRAV_CACHE_CAP", str(1 << 27)):
        finder._trav_tree = None
        t0 = time.monotonic()
        dtree = finder._get_trav_tree()
        build_s = time.monotonic() - t0
    require(dtree is not None, "the dense cell's WalkTree exceeds 2^27 nodes")
    tree_nodes = finder._trav_tree[1].n_nodes
    keys = index.sorted_keys
    probe = trav.walks_match_device(dtree, keys)
    require(np.array_equal(probe[0], li[:nu])
            and np.array_equal(probe[1], lo[:nu])
            and np.array_equal(probe[2], hi[:nu])
            and tuple(probe[3:]) == tuple(int(v) for v in ts),
            "the WalkTree probe differs from the fused traversal")
    g = finder._get_graph_arrays()
    sn_d, so_d = finder._get_loci_device(cap)
    route = {
        "WalkTree probe": lambda: trav.walks_match_device(dtree, keys),
        "fused traversal": lambda: trav.traverse_device_packed(
            g, trav.seeds_to_device(index, finder.device), sn_d, so_d, n, k,
            cap).cpu(),
    }
    route_ms = {name: wall_ms(fn, 3) for name, fn in route.items()}
    route_busy = {name: busy_ms(fn, 1) for name, fn in route.items()}
    phase(tag, f"WalkTree of {tree_nodes} nodes (PSI_TRAV_CACHE_CAP raised) "
          f"built and uploaded in {build_s:.1f} s, its probe equal to the "
          f"traversal; per chunk, as each route runs: "
          + "; ".join(f"{name} {route_ms[name]:.3f} ms (busy "
                      f"{route_busy[name]:.3f})" for name in route))
    finder._trav_tree = None
    del dtree, probe, route, finder
    torch.cuda.empty_cache()

    # (b) the CLI on one chunk, then cuda = cpu on its first reads
    reset_counters()
    hits, rep, wall = run_cli(gfa, fastq, tmp, "cuda", n_reads, tag="_dense")
    got = read_counters()
    (c1,) = rep["chunks"]
    steps = got["traverse_step"]
    require(got == {**ZERO_COUNTS, "trie_level": got["trie_level"],
                    "trie_schedule": 1, "traverse_step": steps}
            and got["trie_level"] > 0 and steps >= k and steps % k == 0,
            f"the dense cell's CLI run launched {got}, expected trie_level, "
            f"one trie_schedule and a multiple of {k} traverse_step only")
    require(c1["hits_off"] > 0, "the dense cell's CLI found no off-path hit")
    small = head_fastq(fastq, os.path.join(tmp, "dense_small.fastq"),
                       N_MISMATCH_READS)
    (h_cuda, _, w_cuda), (h_cpu, _, w_cpu) = (
        run_cli(gfa, small, tmp, device, n_reads, tag="_dense_small")
        for device in ("cuda", "cpu"))
    require(len(h_cuda) > 0 and h_cuda.tobytes() == h_cpu.tobytes(),
            f"the dense cell on {N_MISMATCH_READS} reads: cuda "
            f"{len(h_cuda)} vs cpu {len(h_cpu)} hits")
    cli = {"reads": c1["reads"], "keys": c1["keys"], "hits_on": c1["hits_on"],
           "hits_off": c1["hits_off"], "query_s": c1["query_s"],
           "onpath_s": c1["onpath_s"], "offpath_s": c1["offpath_s"],
           "prepare_s": c1["prepare_s"], "produce_s": c1["produce_s"],
           "wall_s": wall, "kmer_queries_per_s": c1["keys"] / c1["query_s"],
           "launches": got, "small": {"reads": N_MISMATCH_READS,
                                      "hits": len(h_cuda),
                                      "cuda_wall_s": w_cuda,
                                      "cpu_wall_s": w_cpu}}
    phase(tag, f"CLI on the dense cell: {c1['reads']} reads, {c1['keys']} "
          f"keys, {len(hits)} hits ({c1['hits_off']} off path); query "
          f"{c1['query_s']:.3f} s (on-path {c1['onpath_s']:.3f}, off-path "
          f"{c1['offpath_s']:.3f}), {cli['kmer_queries_per_s']:.1f} "
          f"kmer-queries/s, wall {wall:.1f} s; launches {got}; first "
          f"{N_MISMATCH_READS} reads: cuda ({w_cuda:.1f} s) and cpu "
          f"({w_cpu:.1f} s) lexsorted hit streams identical "
          f"({len(h_cuda)} hits)")

    # (c) the traversal alone at 10^6 loci or more
    t0 = time.monotonic()
    gfa, fastq = dense.make_dense(tmp, dense.SCALE_REF_LEN,
                                  dense.SCALE_VARIANT_RATE, n_reads)
    finder, index = dense.offpath_inputs(gfa, fastq, "cuda", n_reads)
    n_big = len(finder.starting_loci)
    require(n_big >= SCALE_MIN_LOCI, f"the scale point has {n_big} loci, "
            f"under {SCALE_MIN_LOCI}")
    phase(tag, f"scale point ({dense.SCALE_REF_LEN} bp, variant rate "
          f"{dense.SCALE_VARIANT_RATE}): {n_big} loci, {index.size} seeds "
          f"(made and loaded in {time.monotonic() - t0:.1f} s)")
    big, _ = traversal_record(finder, index, k, tag)
    del finder
    torch.cuda.empty_cache()
    phase(tag, f"phase {time.monotonic() - t_phase:.1f} s")
    facts = {"dense": {"ref_len": dense.REF_LEN,
                       "variant_rate": dense.VARIANT_RATE, "loci": n,
                       "seeds": n_seeds, "tree_nodes": tree_nodes,
                       "tree_attempt_s": attempt_s,
                       "tree_build_s": build_s, "route_ms": route_ms,
                       "route_busy_ms": route_busy, "traversal": rec,
                       "cli": cli},
             "scale": {"ref_len": dense.SCALE_REF_LEN,
                       "variant_rate": dense.SCALE_VARIANT_RATE,
                       "loci": n_big, "traversal": big}}
    return rec, facts, steps


# --- phase 16: the distance index ---------------------------------------------

def bisect_touched(pk, qkey):
    """Indices of pk that the searches of qkey read (every mid of every
    bisection, as the kernel's loop visits them) and r, each query's
    searchsorted-right, by the plain bisection on the card."""
    import torch

    n = pk.shape[0]
    lo = torch.zeros(qkey.shape[0], dtype=torch.int64, device=pk.device)
    hi = torch.full_like(lo, n)
    mids = []
    for _ in range(max(n.bit_length(), 1)):
        live = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mids.append(torch.unique(mid[live]))
        le = pk[mid.clamp(0, n - 1)] <= qkey
        lo = torch.where(live & le, mid + 1, lo)
        hi = torch.where(live & ~le, mid, hi)
    return torch.unique(torch.cat(mids)), lo


def probe_work(t, q):
    """(bytes, sector bytes, operations, steps) of one probe_bisect launch
    at these inputs: the query columns read and the answers written, plus
    the table entries the searches read (the distinct keys on their
    bisection paths and the distinct rows checked, each once), or the
    distinct 32-byte sectors those lie in."""
    import torch

    touched, r = bisect_touched(t.pk, q[0])
    rows = torch.unique((r - 1)[r >= 1])
    io = nbytes(*q) + q[0].numel()           # + one bool written a query
    steps = max(t.pk.shape[0].bit_length(), 1)
    elems = 8 * touched.numel() + 16 * rows.numel()
    sectors = n_unique(touched >> 2) + 4 * n_unique(rows >> 3)
    return io + elems, io + 32 * sectors, 8 * steps * q[0].numel(), steps


def verify_breakdown(idx, graph, v, o, u, p) -> dict:
    """verify_batch_device's wall time in parts: the host's pair
    arithmetic before the probe, the upload of the five query columns,
    the probe (its kernel by CUDA events, and the whole call), the
    download of the answers and the host's work after it. The call runs
    as it is, probe_bisect timed by a stand-in around it; the upload and
    the download are then replayed on the same arrays to split them from
    the host's work."""
    import torch

    from psi_tpu_torch.ops import dindex_probe as dp

    orig, marks = dp.probe_bisect, {}

    def timed(t, *q):
        torch.cuda.synchronize()
        marks["enter"] = time.monotonic()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(t, *q)
        end.record()
        end.synchronize()
        marks.update(exit=time.monotonic(), q=q, out=out,
                     kernel_ms=start.elapsed_time(end))
        return out

    timed.launches = orig.launches
    dp.probe_bisect = timed
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        idx.verify_batch_device(graph, v, o, u, p)
        wall = time.monotonic() - t0
    finally:
        dp.probe_bisect = orig
        orig.launches = timed.launches
    host_cols = [x.cpu().numpy() for x in marks["q"]]
    torch.cuda.synchronize()
    t1 = time.monotonic()
    for c in host_cols:
        torch.as_tensor(c).to("cuda")
    torch.cuda.synchronize()
    upload = time.monotonic() - t1
    t1 = time.monotonic()
    marks["out"].cpu().numpy()
    download = time.monotonic() - t1
    before, call = marks["enter"] - t0, marks["exit"] - marks["enter"]
    return {"wall_s": wall, "host_before_s": before - upload,
            "upload_s": upload, "upload_bytes": sum(c.nbytes
                                                    for c in host_cols),
            "probe_call_s": call, "kernel_ms": marks["kernel_ms"],
            "download_s": download,
            "host_after_s": wall - before - call - download}


def device_build(graph, dmin: int, dmax: int, want, tag: str) -> dict:
    """The distance index built on the card (PSI_DINDEX_BUILD=device, path
    doubling), byte-identical to `want`, the native build: its rounds,
    join pairs and pieces, wall seconds, CUDA-event ms and peak MB."""
    import numpy as np
    import torch

    from psi_tpu_torch.dindex import DistanceIndex
    from psi_tpu_torch.ops import dindex_build

    orig, info = dindex_build.build_super_device, {}
    dindex_build.build_super_device = (
        lambda *a, **k: orig(*a, info=info, **k))
    try:
        with env("PSI_DINDEX_BUILD", "device"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.monotonic()
            start.record()
            dev_idx = DistanceIndex.build(graph, dmin, dmax)
            end.record()
            end.synchronize()
            wall = time.monotonic() - t0
    finally:
        dindex_build.build_super_device = orig
    peak = (torch.cuda.max_memory_allocated() - before) / 1e6
    require(info.get("rounds", 0) > 0, "the device build did not run")
    for name in ("src_indptr", "dst", "iv_lo", "iv_hi"):
        a, b = getattr(dev_idx, name), getattr(want, name)
        require(a.dtype == b.dtype and np.array_equal(a, b),
                f"({dmin}, {dmax}): the device build's {name} differs "
                f"from the native build's")
    phase(tag, f"device build ({dmin}, {dmax}) byte-identical to native: "
          f"{info['rounds']} rounds, {info['join_pairs']} join pairs in "
          f"{info['pieces']} pieces; wall {wall:.3f} s, CUDA events "
          f"{start.elapsed_time(end):.3f} ms, peak {peak:.1f} MB")
    return {**info, "wall_s": wall, "events_ms": start.elapsed_time(end),
            "peak_mb": peak}


def dindex_phase(tmp: str, gfa: str, fastq: str, chunk: int):
    """[dindex]: the distance index on the bacterial cell's graph. (a) the
    native build at the three horizons; (b) the device build (path
    doubling on the card, PSI_DINDEX_BUILD=device) byte-identical to it at
    the first two; (c) 2^22 locus pairs per probed index; (d) the probe
    kernel against its plain version, probe_sort, the NumPy probe and the
    scalar verify, timed beside its bounds and torch.searchsorted; (e)
    psikt -m 250 -M 450 -I: saved, loaded without a rebuild, the hits of
    the run without -m/-M; (f) alice dstats over 10^6 read pairs on cuda
    and on the host probe. Returns (dindex_probe's record, the phase's
    facts, its launches in the dstats run)."""
    import io as _io

    import numpy as np
    import torch

    from psi_tpu_torch.dindex import DistanceIndex, contract_chains
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.ops import dindex_probe as dp
    from psi_tpu_torch.tools import alice, pairs
    from psi_tpu_torch.tools.ggsim import simulate_haplotypes

    tag = "dindex"
    t_phase = time.monotonic()
    graph = load_graph(gfa)
    node_len = np.diff(graph.label_offsets)
    t0 = time.monotonic()
    sup = contract_chains(node_len, graph.out_indptr, graph.out_indices)
    S = len(sup[3])
    phase(tag, f"{graph.node_count} nodes -> {S} supernodes, "
          f"{len(sup[5])} supernode edges ({time.monotonic() - t0:.2f} s)")

    # (a) the native build at the three horizons
    built, facts = {}, {"supernodes": S, "native": {}, "device": {},
                        "probe": {}}
    for dmin, dmax in DINDEX_HORIZONS:
        t0 = time.monotonic()
        idx = DistanceIndex.build(graph, dmin, dmax)
        build_s = time.monotonic() - t0
        require(idx.mode == "super" and len(idx.dst) > 0,
                f"({dmin}, {dmax}): a {idx.mode} index of {len(idx.dst)} rows")
        path = os.path.join(tmp, f"dist_m{dmin}M{dmax}.npz")
        t0 = time.monotonic()
        idx.save(path)
        save_s = time.monotonic() - t0
        size = os.path.getsize(path)
        built[dmax] = (idx, path)
        facts["native"][f"{dmin},{dmax}"] = {
            "intervals": len(idx.dst), "build_s": build_s, "save_s": save_s,
            "artifact_bytes": size}
        phase(tag, f"native build ({dmin}, {dmax}): {len(idx.dst)} intervals "
              f"in {build_s:.3f} s; artifact {size} bytes (saved in "
              f"{save_s:.2f} s)")

    # (b) the device build, byte-identical to (a)
    for dmin, dmax in DINDEX_HORIZONS[:2]:
        facts["device"][f"{dmin},{dmax}"] = device_build(
            graph, dmin, dmax, built[dmax][0], tag)

    # (c) the pairs: haplotypes of the graph, 2^22 pairs per probed index
    t0 = time.monotonic()
    haps = [h for _, h in simulate_haplotypes(graph, 2, seed=13)]
    coords = pairs.hap_coords(graph, haps)
    sets = {}
    for dmin, dmax in (DINDEX_HORIZONS[0], DINDEX_HORIZONS[2]):
        pr = pairs.sample_pairs(coords, DINDEX_PAIRS, 2 * dmax, seed=dmax)
        sets[dmax] = (pr, *pairs.loci(coords, pr["hap_a"], pr["pos_a"]),
                      *pairs.loci(coords, pr["hap_b"], pr["pos_b"]))
    phase(tag, f"{len(haps)} haplotypes, {DINDEX_PAIRS} pairs for each of "
          f"dmax {DINDEX_HORIZONS[0][1]} and {DINDEX_HORIZONS[2][1]} (7/8 "
          f"on one haplotype, gap uniform in [0, 2 dmax]) in "
          f"{time.monotonic() - t0:.1f} s")

    # (d) the probe on the card against every other form
    record = None
    for dmin, dmax in (DINDEX_HORIZONS[0], DINDEX_HORIZONS[2]):
        idx = built[dmax][0]
        _, v, o, u, p = sets[dmax]
        t0 = time.monotonic()
        want = idx.verify_batch(graph, v, o, u, p)
        host_s = time.monotonic() - t0
        # the upload: keys, row records and the key directory, once
        torch.cuda.synchronize()
        t0 = time.monotonic()
        idx._device_tables(torch.device("cuda", torch.cuda.current_device()))
        torch.cuda.synchronize()
        upload_s = time.monotonic() - t0
        n0 = dp.probe_bisect.launches
        with recorded(dp, "probe_bisect") as calls:
            t0 = time.monotonic()
            got = idx.verify_batch_device(graph, v, o, u, p)
            route_s = time.monotonic() - t0
        require(len(calls) == 1 and dp.probe_bisect.launches == n0 + 1,
                f"verify_batch_device made {len(calls)} probe_bisect calls "
                f"and {dp.probe_bisect.launches - n0} launches")
        require(np.array_equal(got, want), f"({dmin}, {dmax}): "
                f"verify_batch_device differs from verify_batch")
        sample = np.random.RandomState(dmax).choice(
            len(v), DINDEX_SCALAR, replace=False)
        for i in sample:
            require(idx.verify(graph, int(v[i]), int(o[i]), int(u[i]),
                               int(p[i])) == bool(want[i]),
                    f"({dmin}, {dmax}): scalar verify differs at pair {i}")
        t, *q = calls[0]
        kernel = dp.probe_bisect(t, *q)
        plain = dp.probe_bisect_plain(t, *q)
        sort = dp.probe_sort(t, *q)
        torch.cuda.synchronize()
        require(torch.equal(kernel, plain) and torch.equal(kernel, sort),
                f"({dmin}, {dmax}): the probe kernel differs from "
                f"probe_bisect_plain or probe_sort")
        B, n = q[0].numel(), t.pk.numel()
        # in turns: kernel, search, search, kernel
        turns = {"kernel": lambda: dp.probe_bisect(t, *q),
                 "search": lambda: torch.searchsorted(t.pk, q[0],
                                                      right=True)}
        timed = {name: [] for name in turns}
        for name in (*turns, *reversed(turns)):
            timed[name].append(cuda_ms(turns[name], KERNEL_REPS))
        ms, lib_ms = (sum(x) / 2 for x in timed.values())
        enq = enqueue_ms(lambda: dp.probe_bisect(t, *q), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: dp.probe_bisect_plain(t, *q), PLAIN_REPS)
        sort_ms = cuda_ms(lambda: dp.probe_sort(t, *q), PLAIN_REPS)
        bytes_moved, sector_bytes, ops, steps = probe_work(t, q)
        bound_ms, bound_by = bound(bytes_moved, ops)
        sector_ms, _ = bound(sector_bytes, ops)
        # the directory: its build on the card, bytes and buckets
        torch.cuda.synchronize()
        t0 = time.monotonic()
        top, sub, shift = dp.directory(t.pk)
        torch.cuda.synchronize()
        dir_ms = 1e3 * (time.monotonic() - t0)
        require(torch.equal(top, t.top) and torch.equal(sub, t.sub)
                and shift == t.shift,
                f"({dmin}, {dmax}): the directory differs from the upload's")
        split = top[:, 2] >= 0
        sizes = (top[:, 1] - top[:, 0])[~split].double()
        directory = {"build_ms": dir_ms,
                     "bytes": (top.numel() + sub.numel()) * 4,
                     "top_bytes": top.numel() * 4,
                     "sub_bytes": sub.numel() * 4, "shift": shift,
                     "buckets": top.shape[0],
                     "empty": int((sizes == 0).sum()),
                     "split": int(split.sum()),
                     "split_rows": int(n - sizes.sum()),
                     "rows_per_row_bucket": float(
                         (sizes * sizes).sum() / max(float(sizes.sum()), 1))}
        sectors = probe_sectors(t, q[0])
        parts = verify_breakdown(idx, graph, v, o, u, p)
        rec = {"max_abs_err": max_abs_err(kernel, plain), "ms": ms,
               "enqueued_ms": enq, "plain_ms": plain_ms,
               "library_ms": lib_ms, "sort_ms": sort_ms,
               "turns_ms": timed,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bytes": bytes_moved, "ops": ops,
               "sector_bound_ms": sector_ms, "sector_bytes": sector_bytes,
               "sectors_per_pair": sectors, "directory": directory,
               "upload_s": upload_s, "verify_parts": parts,
               "steps": steps, "pairs_per_s": B / (ms / 1e3),
               "rows": n, "queries": B, "accepted": int(want.sum()),
               "host_verify_s": host_s, "route_s": route_s,
               "shape": f"{B} pairs over {n} rows ({dmin}, {dmax})"}
        facts["probe"][f"{dmin},{dmax}"] = rec
        record = record or rec
        phase(tag, f"({dmin}, {dmax}): {B} pairs over {n} rows, "
              f"{rec['accepted']} accepted; kernel = plain = probe_sort = "
              f"NumPy verify_batch, scalar verify on {DINDEX_SCALAR}; "
              f"kernel {1e3 * ms:.3f} us on the device "
              f"(enqueued {1e3 * enq:.3f}, torch.searchsorted {1e3 * lib_ms:.3f}, plain "
              f"{1e3 * plain_ms:.3f}, probe_sort {1e3 * sort_ms:.3f}); "
              f"bound {1e3 * bound_ms:.3f} us by {bound_by} "
              f"({bytes_moved / 1e6:.2f} MB), by sectors "
              f"{1e3 * sector_ms:.3f} us ({sector_bytes / 1e6:.2f} MB); "
              f"{sectors:.4f} table sectors a pair; "
              f"{rec['pairs_per_s']:.4g} pairs/s")
        phase(tag, f"({dmin}, {dmax}) upload {upload_s:.4f} s; the key "
              f"directory built in {dir_ms:.3f} ms, "
              f"{directory['bytes'] / 1e6:.3f} MB (top "
              f"{directory['top_bytes'] / 1e6:.3f}, sub "
              f"{directory['sub_bytes'] / 1e6:.3f}): shift {shift}, "
              f"{directory['buckets']} top buckets, {directory['empty']} "
              f"empty, {directory['split']} split ({directory['split_rows']} "
              f"rows), {directory['rows_per_row_bucket']:.2f} rows in an "
              f"unsplit row's bucket")
        phase(tag, f"({dmin}, {dmax}) verify_batch on the host {host_s:.3f} "
              f"s; verify_batch_device {route_s:.3f} s, timed again "
              f"{parts['wall_s']:.4f} s: host before the probe "
              f"{parts['host_before_s']:.4f}, upload {parts['upload_s']:.4f} "
              f"({parts['upload_bytes'] / 1e6:.1f} MB), probe call "
              f"{parts['probe_call_s']:.4f} (kernel "
              f"{parts['kernel_ms']:.3f} ms), download "
              f"{parts['download_s']:.4f}, host after "
              f"{parts['host_after_s']:.4f}")
        del calls, kernel, plain, sort, t, q, top, sub
    torch.cuda.empty_cache()

    # (e) the CLI: -m 250 -M 450 with a path index prefix
    small = head_fastq(fastq, os.path.join(tmp, "dindex_reads.fastq"),
                       DINDEX_CLI_READS)
    prefix = os.path.join(tmp, "dindex_pidx")
    (dmin, dmax), builds = DINDEX_HORIZONS[0], []
    dist = ("-m", str(dmin), "-M", str(dmax), "-I", prefix)
    orig_build = DistanceIndex.build
    DistanceIndex.build = staticmethod(
        lambda *a, **k: builds.append(a) or orig_build(*a, **k))
    try:
        runs = [run_cli(gfa, small, tmp, "cuda", chunk, tag=f"_dist{i}",
                        extra=dist) for i in (1, 2)]
    finally:
        DistanceIndex.build = orig_build
    artifact = f"{prefix}_dist_mat_m{dmin}M{dmax}.npz"
    require(len(builds) == 1 and os.path.exists(artifact),
            f"psikt -m {dmin} -M {dmax}: {len(builds)} builds (expected one "
            f"and then a load)")
    loaded = DistanceIndex.load(artifact)
    require(np.array_equal(loaded.dst, built[dmax][0].dst)
            and np.array_equal(loaded.iv_hi, built[dmax][0].iv_hi),
            "the CLI's artifact differs from the native build")
    plain_hits, _, plain_wall = run_cli(gfa, small, tmp, "cuda", chunk,
                                        tag="_nodist", extra=("-I", prefix))
    for hits, _, _ in runs:
        require(hits.tobytes() == plain_hits.tobytes(),
                f"psikt -m/-M changed the hit stream: {len(hits)} vs "
                f"{len(plain_hits)} hits")
    facts["cli"] = {"reads": DINDEX_CLI_READS, "hits": len(plain_hits),
                    "build_wall_s": runs[0][2], "load_wall_s": runs[1][2],
                    "plain_wall_s": plain_wall}
    phase(tag, f"psikt -m {dmin} -M {dmax} -I on {DINDEX_CLI_READS} reads: "
          f"built and saved ({runs[0][2]:.1f} s), loaded with no rebuild "
          f"({runs[1][2]:.1f} s); hit streams identical to the run without "
          f"-m/-M ({len(plain_hits)} hits)")

    # (f) alice dstats over 10^6 read pairs, cuda and the host probe
    pr = {k: a[::4][:DINDEX_GAF_PAIRS] for k, a in sets[dmax][0].items()}
    gaf = os.path.join(tmp, "pairs.gaf")
    t0 = time.monotonic()
    pairs.write_gaf(graph, coords, pr, gaf, DINDEX_GAF_PAIRS)
    gaf_s = time.monotonic() - t0
    outs, walls = {}, {}
    for route in ("cuda", "host"):
        buf = _io.StringIO()
        with contextlib.ExitStack() as stack:
            if route == "host":
                stack.enter_context(env("PSI_DINDEX_DEVICE", "0"))
            stack.enter_context(contextlib.redirect_stdout(buf))
            reset_counters()
            t0 = time.monotonic()
            rc = alice.main(["dstats", gaf, "-g", gfa, "-d",
                             built[dmax][1]] + (["--device", "cuda"]
                                                if route == "cuda" else []))
            walls[route] = time.monotonic() - t0
            counts = read_counters()
        require(rc == 0, f"alice dstats ({route}) returned {rc}")
        outs[route] = buf.getvalue()
        if route == "cuda":
            launches = counts
    require(launches == {**ZERO_COUNTS, "dindex_probe": 1},
            f"alice dstats on cuda launched {launches}, expected one "
            f"dindex_probe")
    require(outs["cuda"] == outs["host"], f"alice dstats: cuda printed "
            f"{outs['cuda']!r}, the host probe {outs['host']!r}")
    printed = dict(line.split(": ") for line in outs["cuda"].splitlines())
    _, v, o, u, p = sets[dmax]
    want = built[dmax][0].verify_batch(graph, v[::4][:DINDEX_GAF_PAIRS],
                                       o[::4][:DINDEX_GAF_PAIRS],
                                       u[::4][:DINDEX_GAF_PAIRS],
                                       p[::4][:DINDEX_GAF_PAIRS])
    require(int(printed["pairs"]) == DINDEX_GAF_PAIRS
            and int(printed["accepted"]) == int(want.sum()),
            f"alice dstats printed {printed}, the pairs' loci give "
            f"{int(want.sum())} accepted of {DINDEX_GAF_PAIRS}")
    facts["dstats"] = {"pairs": DINDEX_GAF_PAIRS, "printed": printed,
                       "gaf_bytes": os.path.getsize(gaf), "gaf_write_s": gaf_s,
                       "cuda_wall_s": walls["cuda"],
                       "host_wall_s": walls["host"]}
    phase(tag, f"alice dstats over {DINDEX_GAF_PAIRS} read pairs "
          f"({os.path.getsize(gaf)} byte GAF, written in {gaf_s:.1f} s): "
          f"{printed}, the same on cuda ({walls['cuda']:.2f} s, one "
          f"dindex_probe launch) and on the host probe "
          f"({walls['host']:.2f} s)")
    phase(tag, f"phase {time.monotonic() - t_phase:.1f} s")
    return record, facts, launches["dindex_probe"]


# --- phase 12: sampled counts against the host FM index ---------------------------

def check_sampled_counts(finder, uniq, n: int) -> int:
    import numpy as np

    from psi_tpu_torch.ops import fm_trie

    rng = np.random.RandomState(3)
    keys = np.sort(rng.choice(uniq, size=min(n, len(uniq)), replace=False))
    k = finder.seed_len
    lo, hi = fm_trie.trie_search(finder._get_stream_arrays(), keys, k,
                                 ftab=finder._get_ftab())
    fm = finder.pindex.fm
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    codes = (keys[:, None] >> shifts[None, :]) & np.uint64(3)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    present = 0
    for i, row in enumerate(codes):
        s = alphabet[row.astype(np.int64)].tobytes().decode("ascii")
        # codes are fed first to last: backward search of the reversal
        want_lo, want_hi = fm.backward_search(s[::-1])
        require(hi[i] - lo[i] == want_hi - want_lo,
                f"key {s}: count {hi[i] - lo[i]} != {want_hi - want_lo}")
        if want_hi > want_lo:
            require(lo[i] == want_lo, f"key {s}: lo {lo[i]} != {want_lo}")
            present += 1
    return present


# --- phase 13: the single-core native baseline against the card ---------------

def cpu_model() -> str:
    """The host CPU as lscpu names it. A virtualised host may hide the model
    name ("unknown"): then its vendor, family, model and stepping, which
    identify the part."""
    import subprocess

    text = subprocess.run(["lscpu"], capture_output=True, text=True,
                          timeout=60, check=True).stdout
    fields = dict(line.split(":", 1) for line in text.splitlines()
                  if ":" in line)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    name = fields.get("Model name", "unknown")
    if name in ("", "-", "unknown"):
        name = (f"model name {name or 'absent'}; " + ", ".join(
            f"{k} {fields.get(k, 'absent')}" for k in (
                "Vendor ID", "CPU family", "Model", "Stepping")))
    return f"{name}; {fields.get('CPU(s)', '?')} CPUs"


def baseline_phase(finder, index) -> dict:
    """[baseline]: psi_fm.cpp's single-core backward search and the card's
    trie search over chunk 1's distinct keys: the same leaf ranges, both
    rates and their ratio."""
    import numpy as np

    from psi_tpu_torch import native
    from psi_tpu_torch.ops import fm_stream, fm_trie

    tag = "baseline"
    fm = finder.pindex.fm
    k = finder.seed_len
    sarr, ftab = finder._get_stream_arrays(), finder._get_ftab()
    uniq, prep = index._onpath_prep.uniq, index._onpath_prep.trie
    levels = prep.parents.shape[0]
    n_keys = len(uniq)
    # the trie's keys fed column 0 first: the codes psi_fm.cpp reads
    shifts = 2 * np.arange(k - 1, -1, -1, dtype=np.uint64)
    codes = ((uniq[:, None] >> shifts) & np.uint64(3)).astype(np.int32) + 1
    payload = fm_stream.payload_host(fm)
    C = fm.C.astype(np.int32)
    require(native.fm_backward_batch(payload, C, fm.size,
                                     codes[:BASELINE_WARM]) is not None,
            f"the native baseline is missing: {native.load_error}")
    # the two in turns, so that each ratio pairs calls made close together
    # on the shared host
    host_s, card_s = [], []
    reset_counters()
    for _ in range(BASELINE_REPS):
        t0 = time.perf_counter()
        lo, hi, nonempty = native.fm_backward_batch(payload, C, fm.size, codes)
        host_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tlo, thi = fm_trie.trie_search(sarr, uniq, k, ftab=ftab)
        card_s.append(time.perf_counter() - t0)
        require(_same_ranges((lo, hi), (tlo, thi)),
                "the native baseline's leaf ranges differ from the card's")
        require(nonempty == int((thi > tlo).sum()) > 0,
                f"nonempty {nonempty} != the card's {int((thi > tlo).sum())}")
    got = read_counters()
    require(got == {**ZERO_COUNTS, "trie_level": levels * BASELINE_REPS,
                    "trie_schedule": BASELINE_REPS},
            f"the trie search launched {got}, expected {levels} trie_level "
            f"and one trie_schedule a call")
    levels_ms = cuda_ms(lambda: fm_trie._trie_device(
        sarr, prep.parents, prep.chars, prep.lo0, prep.hi0), ROUTE_REPS)
    ratios = [h / c for h, c in zip(host_s, card_s)]
    base_s = float(np.median(host_s))
    res = {"keys": n_keys, "k": k, "levels": levels, "nonempty": nonempty,
           "cpu": cpu_model(), "built_with": native.built_with,
           "baseline_s": host_s,
           "baseline_kmer_queries_per_s": n_keys / base_s,
           "card_wall_s": card_s,
           "card_wall_kmer_queries_per_s": n_keys / float(np.median(card_s)),
           "card_levels_ms": levels_ms,
           "card_levels_kmer_queries_per_s": n_keys / (levels_ms / 1e3),
           "ratios_wall": ratios, "ratio_wall": float(np.median(ratios)),
           "launches": got}
    res["ratio_levels"] = res["card_levels_kmer_queries_per_s"] / res[
        "baseline_kmer_queries_per_s"]
    phase(tag, f"host CPU: {res['cpu']}")
    phase(tag, f"{n_keys} distinct keys (k = {k}), {nonempty} present: "
          f"leaf ranges of psi_fm.cpp and the card's trie search agree")
    phase(tag, f"psi_fm.cpp, one core, built with {native.built_with}: "
          f"{', '.join(f'{t:.4f}' for t in host_s)} s, median "
          f"{res['baseline_kmer_queries_per_s']:.1f} kmer-queries/s")
    phase(tag, f"card, trie_search (plan, upload, {levels} trie_level, "
          f"download), each call just after a baseline call: "
          f"{', '.join(f'{t:.4f}' for t in card_s)} s, median "
          f"{res['card_wall_kmer_queries_per_s']:.1f} kmer-queries/s; "
          f"each pair's ratio {', '.join(f'{r:.2f}' for r in ratios)}x, "
          f"median {res['ratio_wall']:.2f}x the baseline")
    phase(tag, f"the {levels} levels alone {levels_ms:.4f} ms on the device, "
          f"{res['card_levels_kmer_queries_per_s']:.1f} kmer-queries/s, "
          f"{res['ratio_levels']:.1f}x the median baseline; launches {got}")
    return res


# --- phase 14: the tool CLIs ------------------------------------------------------

def run_tool(main_fn, argv: list) -> tuple[int, str, str, float]:
    """A tool's main(argv) with its output captured: (exit code, stdout,
    stderr, wall seconds)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(argv)
    return rc, out.getvalue(), err.getvalue(), time.monotonic() - t0


@contextlib.contextmanager
def finder_devices():
    """The device of every SeedFinder made inside the block, in order."""
    from psi_tpu_torch.seed_finder import SeedFinder

    made, init = [], SeedFinder.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self.device.type)

    SeedFinder.__init__ = spy
    try:
        yield made
    finally:
        SeedFinder.__init__ = init


def tools_phase(finder, tmp: str, gfa: str) -> dict:
    """[tools]: pindexctl, loci_stats, sloci and ggsim on the cell's path
    index and graph, and nof_uncovered_kmers, each checked and timed."""
    import numpy as np

    from psi_tpu_torch.tools import ggsim, loci_stats, pindexctl, sloci

    tag = "tools"
    k = str(finder.seed_len)
    prefix = os.path.join(tmp, "pidx")
    n_loci = len(finder.get_starting_loci())
    walls = {}
    t0 = time.monotonic()
    require(finder.serialize_path_index(prefix), "serialize_path_index")
    walls["serialize_path_index"] = time.monotonic() - t0

    def tool(name, main_fn, argv, devices=None):
        with finder_devices() as made:
            rc, out, err, walls[name] = run_tool(main_fn, argv)
        require(rc == 0, f"{name} exited {rc}: {err.strip()}")
        if devices is not None:
            require(made == devices,
                    f"{name} made SeedFinders on {made}, expected {devices}")
        return out, err

    out, _ = tool("pindexctl inspect", pindexctl.main,
                  ["inspect", gfa, "-I", prefix, "-l", k, "--device", "cuda"],
                  ["cuda"])
    lines = dict(line.split(": ", 1) for line in out.splitlines())
    require(lines["uncovered loci"].split(" / ")[0] == str(n_loci),
            f"pindexctl inspect counts {lines['uncovered loci']} loci, "
            f"the index {n_loci}")
    fasta = os.path.join(tmp, "paths.fa")
    tool("pindexctl to-fasta", pindexctl.main,
         ["to-fasta", gfa, "-I", prefix, "-o", fasta, "--device", "cuda"],
         ["cuda"])
    with open(fasta) as fh:
        seqs = fh.read().splitlines()[1::2]
    require(len(seqs) == int(lines["number of paths"]) and sum(
        map(len, seqs)) == int(lines["total sequence length"]),
        "to-fasta's paths differ from inspect's count and length")
    gam = os.path.join(tmp, "paths.gam")
    _, err = tool("pindexctl to-gam -l", pindexctl.main,
                  ["to-gam", gfa, "-I", prefix, "-o", gam, "-l", k,
                   "--device", "cuda"], ["cuda"])
    require(f"wrote {len(seqs)} path alignments" in err, err.strip())
    out, _ = tool("loci_stats -c", loci_stats.main, [prefix, "-l", k, "-c"])
    require(out == f"{n_loci}\n", f"loci_stats -c printed {out!r}")
    loci = prefix + f"_loci_e1l{k}.npy"
    tsv, back = os.path.join(tmp, "loci.tsv"), os.path.join(tmp, "loci_back")
    tool("sloci export", sloci.main, ["export", loci, "-o", tsv])
    tool("sloci import", sloci.main, ["import", tsv, "-o", back])
    require(np.array_equal(np.load(back + ".npy"), np.load(loci)),
            "sloci export -> import changed the loci")
    for name, extra, records in (("ggsim", [], GGSIM_READS),
                                 ("ggsim -d 500 -s 50",
                                  ["-d", "500", "-s", "50"],
                                  2 * GGSIM_READS)):
        reads = os.path.join(tmp, "ggsim.fastq")
        tool(name, ggsim.main, [gfa, "-o", reads, "-t", "fastq", "-n",
                                str(GGSIM_READS), "-l", "100", "-S", "7",
                                *extra])
        with open(reads) as fh:
            lines_read = fh.read().splitlines()
        n_lines, lens = len(lines_read), set(map(len, lines_read[1::4]))
        require(n_lines == 4 * records and lens == {100},
                f"{name} wrote {n_lines // 4} records of lengths {lens}, "
                f"expected {records} of 100 bp")
    t0 = time.monotonic()
    uncovered = finder.nof_uncovered_kmers()
    walls["nof_uncovered_kmers"] = time.monotonic() - t0
    require(uncovered > 0, f"nof_uncovered_kmers gave {uncovered}")
    phase(tag, f"pindexctl inspect --device cuda: {n_loci} uncovered loci "
          f"of {lines['uncovered loci'].split(' / ')[1]}, "
          f"{lines['uncovered unique nodes']} nodes, as the index; "
          f"nof_uncovered_kmers {uncovered}")
    phase(tag, "wall s: " + ", ".join(f"{name} {s:.3f}"
                                      for name, s in walls.items()))
    return {"loci": n_loci, "nof_uncovered_kmers": uncovered,
            "inspect": lines, "wall_s": walls}


MESH_MM_READS = 10_000   # reads of [mesh] (b), --mismatches 1 on the mesh
WORKER_TIMEOUT_S = 420   # each process of [mesh] (c)


def _mesh_query(mf, seeds, index):
    """One chunk's query on a mesh finder, counters set to 0 just before
    and read just after: (lexsorted rows, launches, wall s, prepare s,
    peak MB of the query)."""
    import torch

    t0 = time.monotonic()
    mf.prepare_onpath(index)
    prep_s = time.monotonic() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.monotonic()
    hits = mf.seeds_all_arrays(seeds, index)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_counters()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    return seed_rows(hits), launches, wall, prep_s, peak


def _per_shard(mf, index, uniq, cap_local: int) -> list:
    """Per shard of mf's mesh: the trie plan's wall ms (fm_trie.prepare of
    its key slice on the shard's device: on a card the keys' copy, the
    trie_schedule build and leaf_perm's download), its levels' and its
    traversal's device ms (CUDA events), replayed after the counted
    run."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import fm_trie
    from psi_tpu_torch.ops import traverse as trav
    from psi_tpu_torch.tools.timing import cuda_ms

    mesh = mf._get_mesh()
    D = mesh.size
    per = -(-len(uniq) // D)
    npad = fm_trie.NPAD_MIN
    while npad < per:
        npad *= 2
    sn, so = mf._get_loci_np()
    lper = max(-(-len(sn) // D), 1)
    out = []
    for d in range(D):
        dev = mesh.device(d)
        keys = uniq[d * per: (d + 1) * per]
        t0 = time.monotonic()
        plan = fm_trie.prepare(keys, mf.seed_len, mf._get_ftab(), device=dev,
                               npad=npad)
        plan_ms = (time.monotonic() - t0) * 1e3
        sarr = mf._get_mesh_repl(mesh, "sarr", mf._get_stream_arrays)[d]
        with torch.cuda.device(dev):
            trie_ms = cuda_ms(lambda: fm_trie._trie_device(
                sarr, plan.parents, plan.chars, plan.lo0, plan.hi0), 5)
            g = trav.graph_to_device(mf.graph, dev)
            sa = trav.seeds_to_device(index, dev)
            m = max(min(len(sn) - d * lper, lper), 0)
            loci = np.zeros((2, cap_local), dtype=np.int32)
            loci[0, :m] = sn[d * lper: d * lper + m]
            loci[1, :m] = so[d * lper: d * lper + m]
            sn_d, so_d = (torch.from_numpy(a).to(dev) for a in loci)
            trav_ms = cuda_ms(lambda: trav.traverse_device_packed(
                g, sa, sn_d, so_d, m, mf.seed_len, cap_local), 3)
        out.append({"device": str(dev), "keys": int(len(keys)), "loci": m,
                    "plan_ms": plan_ms, "trie_ms": trie_ms,
                    "traversal_ms": trav_ms})
    return out


def mesh_phase(finder, reads, seeds, index, tmp: str, gfa: str, fastq: str,
               prefix: str, one: str, chunk: int, hits_cuda, levels: int,
               card) -> dict:
    """[mesh]: the multi-device pipeline on chunk 1 of the bacterial cell:
    (a) SeedFinder(devices=(card, card)) byte-identical to the
    single-device finder, 2 x levels trie_level and traverse_step 20 a
    shard and attempt (and on cuda:0, cuda:1 when there are two cards);
    (b) --mismatches 1 on the mesh over the first MESH_MM_READS reads;
    (c) two multihost_worker processes sharing the card (gloo on
    localhost), both emission modes; (d) graft.dryrun_multichip(2) on the
    card named twice; (e) psikt --devices auto on the card (one card: the
    single route). `card` is the finder's device."""
    import subprocess
    import socket

    import numpy as np
    import torch

    from psi_tpu_torch import graft
    from psi_tpu_torch.io.fastq import FastxStream
    from psi_tpu_torch.records import Records
    from psi_tpu_torch.seed_finder import SeedFinder

    tag = "mesh"
    t_phase = time.monotonic()
    res = {}
    k = finder.seed_len
    t0 = time.monotonic()
    single = finder.seeds_all_arrays(seeds, index)
    single_s = time.monotonic() - t0
    want = seed_rows(single)
    expect_path = os.path.join(tmp, "single_hits.npy")
    np.save(expect_path, single)

    layouts = [("card named twice", (card, card))]
    if card.type == "cuda" and torch.cuda.device_count() >= 2:
        layouts.append(("two cards", (card, torch.device("cuda", 1))))
    else:
        phase(tag, f"the run on two cards was not made: "
              f"{torch.cuda.device_count()} card is visible")
    for name, devices in layouts:
        t0 = time.monotonic()
        mf = SeedFinder(finder.graph, k, devices=devices, device=card)
        require(mf.load_path_index(prefix), f"load_path_index({prefix})")
        # the per-index state a first chunk builds, as the single-device
        # finder has it: not timed as the query's
        for build in (mf._get_ftab, mf._get_stream_arrays, mf._get_sa,
                      mf._get_map_arrays, mf._get_graph_arrays):
            build()
        load_s = time.monotonic() - t0
        mseeds = mf.get_seeds(reads)
        mindex = mf.index_reads(mseeds)
        rows, launches, wall, prep_s, peak = _mesh_query(mf, mseeds, mindex)
        D = mf._get_mesh().size
        steps = launches["traverse_step"]
        attempts = steps // (D * SEED_LEN)
        require(rows.shape == want.shape and rows.tobytes() == want.tobytes(),
                f"[mesh] {name}: {len(rows)} hits, the single-device "
                f"finder {len(want)}")
        require(launches == {**ZERO_COUNTS, "trie_level": D * levels,
                             "traverse_step": steps}
                and steps == attempts * D * SEED_LEN and attempts >= 1,
                f"[mesh] {name} launched {launches}, expected {D * levels} "
                f"trie_level and {D} x {SEED_LEN} traverse_step an attempt")
        loci = len(mf.get_starting_loci())
        per_loci = -(-loci // D)
        cap_local = max(1 << 12, 1 << (per_loci - 1).bit_length())
        uniq = mindex._onpath_prep.uniq
        shards = _per_shard(mf, mindex, uniq, cap_local << (attempts - 1))
        rec = {"devices": [str(d) for d in devices], "hits": len(rows),
               "keys": int(len(uniq)), "loci": loci,
               "loci_per_shard": per_loci, "cap_local": cap_local,
               "attempts": attempts, "launches": launches,
               "query_wall_s": wall, "prepare_s": prep_s,
               "single_query_s": single_s, "peak_mb": peak,
               "load_s": load_s, "shards": shards}
        res["a" if name == "card named twice" else "a_two_cards"] = rec
        phase(tag, f"(a) {name}: {len(rows)} hits byte-identical to the "
              f"single-device finder's ({single_s:.3f} s); query "
              f"{wall:.3f} s wall, sharded plan {prep_s:.3f} s, peak "
              f"{peak:.1f} MB; launches trie_level {launches['trie_level']}"
              f", traverse_step {steps} ({attempts} attempt(s) at cap_local "
              f"{cap_local}, {per_loci} loci a shard)")
        for d, sh in enumerate(shards):
            phase(tag, f"(a) shard {d} on {sh['device']}: {sh['keys']} keys, "
                  f"plan {sh['plan_ms']:.1f} ms (wall), levels "
                  f"{sh['trie_ms']:.4f} ms, traversal {sh['traversal_ms']:.4f}"
                  f" ms (device), {sh['loci']} loci")
        if name == "card named twice":
            mesh_finder = mf
        else:
            del mf

    # (b) --mismatches 1 on the mesh, the first MESH_MM_READS reads
    names, packed = FastxStream(fastq).read_chunk_packed(MESH_MM_READS)
    small = Records(names, rec_offset=0, packed=packed)
    outs = {}
    for label, f in (("single", finder), ("mesh", mesh_finder)):
        f.seed_mismatches = 1
        try:
            s_seeds = f.get_seeds(small)
            s_index = f.index_reads(s_seeds)
            t0 = time.monotonic()
            rows, launches, wall, prep_s, _ = _mesh_query(f, s_seeds,
                                                          s_index)
            outs[label] = (rows, launches, time.monotonic() - t0, wall,
                           prep_s)
        finally:
            f.seed_mismatches = 0
    (rows1, _, t1, _, _), (rowsm, lm, tm, wm, pm) = outs["single"], \
        outs["mesh"]
    refine4 = lm["range_refine4"]
    require(len(rowsm) > 0 and rowsm.tobytes() == rows1.tobytes(),
            f"[mesh] (b) --mismatches 1: mesh {len(rowsm)} hits, single "
            f"{len(rows1)}")
    require(lm == {**ZERO_COUNTS, "trie_level": 2 * levels,
                   "range_refine4": refine4, "traverse_step_approx": refine4}
            and refine4 > 0 and refine4 % (2 * SEED_LEN) == 0,
            f"[mesh] (b) launched {lm}")
    res["b"] = {"reads": MESH_MM_READS, "hits": len(rowsm),
                "launches": lm, "query_wall_s": wm, "prepare_s": pm,
                "total_s": tm, "single_total_s": t1}
    phase(tag, f"(b) --mismatches 1, first {MESH_MM_READS} reads: {len(rowsm)}"
          f" hits byte-identical to the single-device finder's; mesh "
          f"plan {pm:.3f} s + query {wm:.3f} s (single {t1:.3f} s in all); "
          f"range_refine4 and traverse_step_approx {refine4}, trie_level "
          f"{lm['trie_level']}")

    # (c) two processes sharing the card, gloo on localhost
    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    out_json = os.path.join(tmp, "mh.json")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "psi_tpu_torch.tools.multihost_worker",
         str(port), str(i), "2", out_json, "--device", card.type, "--gfa",
         gfa,
         "--fastq", fastq, "--index", prefix, "--chunk", str(chunk), "-l",
         str(SEED_LEN), "--expect", expect_path],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)]
    errors = []
    try:
        for i, proc in enumerate(procs):
            try:
                _, err = proc.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                errors.append(f"process {i} timed out after "
                              f"{WORKER_TIMEOUT_S} s")
                continue
            if proc.returncode != 0:
                errors.append(f"process {i} exited {proc.returncode}: "
                              f"{err.decode()[-3000:]}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    require(not errors, "[mesh] (c): " + "; ".join(errors))
    with open(out_json) as fh:
        mh = json.load(fh)
    mh["wall_s"] = time.monotonic() - t0
    require(mh["count_ok"] and mh["trie_ok"] and mh["disjoint"]
            and mh["shard_ok"] and mh["full_ok"]
            and mh["pipeline_hits"] == len(want),
            f"[mesh] (c) failed its checks: {mh}")
    for q, pr in enumerate(mh["processes"]):
        for mode in ("shard", "full"):
            got = pr[f"launches_{mode}"]
            require(got["fm_fused.trie_level"] == levels
                    and got["traverse.traverse_step"] > 0
                    and got["traverse.traverse_step"] % SEED_LEN == 0
                    and got["traverse.range_refine4"] == 0
                    and got["traverse.traverse_step_approx"] == 0
                    and got["fm_pallas.lf_pair"] == 0,
                    f"[mesh] (c) process {q} launched {got} ({mode})")
    res["c"] = mh
    pr0, pr1 = mh["processes"]
    phase(tag, f"(c) two processes on the card: sharded count and trie "
          f"search equal the oracle; PSI_MH_EMIT=shard streams disjoint "
          f"({pr0['hits_shard']} + {pr1['hits_shard']} hits), their union "
          f"the single-device stream ({mh['pipeline_hits']}); full: both "
          f"equal it; query walls shard {pr0['wall_shard_s']:.3f} / "
          f"{pr1['wall_shard_s']:.3f} s, full {pr0['wall_full_s']:.3f} / "
          f"{pr1['wall_full_s']:.3f} s; launches per process "
          f"{pr0['launches_shard']}; {mh['wall_s']:.1f} s in all")

    # (d) the dry run on the card named twice
    reset_counters()
    t0 = time.monotonic()
    graft.dryrun_multichip(2, devices=(card, card))
    dry_s = time.monotonic() - t0
    dry = read_counters()
    require(dry["occ_lf_pair"] > 0 and dry["trie_level"] > 0,
            f"[mesh] (d) launched {dry}")
    res["d"] = {"launches": dry, "wall_s": dry_s}
    phase(tag, f"(d) graft.dryrun_multichip(2, card twice): every check "
          f"passed in {dry_s:.2f} s; launches {dry}")

    # (e) psikt --devices auto on the card: one card, the single route
    reset_counters()
    hits_auto, _, wall = run_cli(gfa, one, tmp, card.type, chunk, tag="_auto",
                                 extra=("--devices", "auto", "-I", prefix))
    auto = read_counters()
    first = hits_cuda[hits_cuda[:, 2] < chunk]
    expect_auto = ({**ZERO_COUNTS, "trie_level": levels, "trie_schedule": 1}
                   if torch.cuda.device_count() == 1 else None)
    require(hits_auto.tobytes() == first.tobytes(),
            f"[mesh] (e) psikt --devices auto: {len(hits_auto)} hits, "
            f"[cli-cuda]'s chunk 1 {len(first)}")
    require(expect_auto is None or auto == expect_auto,
            f"[mesh] (e) launched {auto}, expected {expect_auto}")
    res["e"] = {"hits": len(hits_auto), "launches": auto, "wall_s": wall}
    phase(tag, f"(e) psikt --devices auto -I: {len(hits_auto)} hits, "
          f"[cli-cuda]'s chunk 1 byte for byte; launches {auto}; wall "
          f"{wall:.1f} s")
    res["phase_s"] = time.monotonic() - t_phase
    phase(tag, f"phase {res['phase_s']:.1f} s")
    return res


#: the worker's counter names for the kernels it counts
WORKER_COUNTERS = {"trie_level": "fm_fused.trie_level",
                   "traverse_step": "traverse.traverse_step",
                   "range_refine4": "traverse.range_refine4",
                   "traverse_step_approx": "traverse.traverse_step_approx",
                   "occ_lf_pair": "fm_pallas.lf_pair"}


def mesh_launches(mesh: dict, kname: str) -> dict:
    """A kernel's launches on each run of [mesh]: (a) and (a) on two
    cards, (b), each process of (c) under both emission modes, (d), (e);
    empty when [mesh] never launched it."""
    out = {run: mesh[run]["launches"][kname]
           for run in ("a", "a_two_cards", "b", "d", "e") if run in mesh}
    wname = WORKER_COUNTERS.get(kname)
    if wname:
        out["c"] = [{mode: pr[f"launches_{mode}"][wname]
                     for mode in ("shard", "full")}
                    for pr in mesh["c"]["processes"]]
    any_launch = any(v for v in out.values() if isinstance(v, int)) or any(
        n for pr in out.get("c", []) for n in pr.values())
    return out if any_launch else {}


# --- phase 18: the chromosome-scale pipeline -------------------------------------

#: the pan-genome of [chr-scale] in Mbp. psi_tpu's is 100 (a 172.5 M-char
#: index), where the phase takes some 740 s on the H100's host and the
#: whole run some 1,200 s, the run's time limit; 60 gives a ~103 M-char
#: index, over 100 M chars, so payloadC stays over twice the 50 MB L2
CHR_MBP = 60.0
CHR_CHUNKS = 8          # chunks of chr_scale.CHUNK reads in [chr-scale] (a)
CHR_CPU_READS = 2_000   # reads of the cuda = cpu checks, (b)
#: psi_tpu's recorded run of this configuration (docs/BENCH_NOTES.md,
#: "Chromosome scale on TPU"), printed beside the port's
PSI_TPU_CHR = {"chars": "172.5 M", "nodes": "2.97 M", "loci": "92,034"}


def trie_level_table_work(nbpad, parents, chars, lo, hi):
    """(bytes, sector bytes, operations) of one trie_level launch for a
    payloadC past L2: trie_level_work's arrays, plus each distinct 8-byte
    payloadC entry that the children's (char, lo block) and (char, hi
    block) name read once, or each distinct 32-byte sector those lie in
    (char_sectors_per_child's count)."""
    import torch

    io_bytes, ops = trie_level_work(parents, chars, lo, hi)
    p = parents.long()
    words = torch.cat([(chars.long() - 1) * nbpad + (x[p].long() >> 5)
                       for x in (lo, hi)])
    return (io_bytes + 8 * n_unique(words),
            io_bytes + 32 * n_unique(words >> 2), ops)


def chr_trie_record(finder, index, tag: str, step: str = "(d)") -> dict:
    """trie_level at a chunk's frontier over the chr-scale index: every
    level against its plain version, the device ms per level (CUDA
    events, a spin kernel first; payloadC, 3.4x L2, cycles through HBM
    from one run to the next), enqueued and plain ms, and three bounds:
    the payload in L2 (the 10 Mchar rows' count), its entries from HBM,
    and its sectors from HBM."""
    import torch

    from psi_tpu_torch.ops import fm_fused

    finder.prepare_onpath(index)
    uniq, prep = index._onpath_prep.uniq, index._onpath_prep.trie
    sarr = finder._get_stream_arrays()
    par, chs = prep.parents, prep.chars
    levels, npad = par.shape
    fronts, err = [(prep.lo0, prep.hi0)], 0
    for j in range(levels):
        out = (torch.empty_like(prep.lo0), torch.empty_like(prep.hi0))
        fm_fused.trie_level(sarr.payloadC, sarr.C, par[j], chs[j],
                            *fronts[j], *out)
        want = fm_fused.trie_level_plain(sarr.payloadC, sarr.C, par[j],
                                         chs[j], *fronts[j])
        err = max(err, max_abs_err(out[0], want[0]),
                  max_abs_err(out[1], want[1]))
        fronts.append(out)
    require(err == 0, f"trie_level differs from its plain version by {err}")

    def fused():
        return fm_fused.trie_fused(sarr, par, chs, prep.lo0, prep.hi0)

    def plain():
        for j in range(levels):
            fm_fused.trie_level_plain(sarr.payloadC, sarr.C, par[j], chs[j],
                                      *fronts[j])

    ms = cuda_ms(fused, KERNEL_REPS) / levels
    enq = enqueue_ms(fused, KERNEL_REPS) / levels
    plain_ms = cuda_ms(plain, PLAIN_REPS) / levels
    nbpad = sarr.payloadC.shape[1]
    work = [trie_level_table_work(nbpad, par[j], chs[j], *fronts[j])
            for j in range(levels)]
    l2_ms, _, l2_bytes, ops = mean_bound(
        [trie_level_work(par[j], chs[j], *fronts[j]) for j in range(levels)])
    bound_ms, bound_by, table_bytes, _ = mean_bound([(b, o)
                                                     for b, _, o in work])
    sector_ms, _, sector_bytes, _ = mean_bound([(sb, o)
                                                for _, sb, o in work])
    sectors = sum(char_sectors_per_child(
        nbpad, chs[j], fronts[j][0][par[j].long()],
        fronts[j][1][par[j].long()]) for j in range(levels)) / levels
    lo, hi = fronts[-1]
    rec = {"max_abs_err": err, "ms": ms, "enqueued_ms": enq,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "hbm_bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": table_bytes, "ops": ops,
           "sector_bound_ms": sector_ms, "sector_bytes": sector_bytes,
           "l2_bound_ms": l2_ms, "l2_bytes": l2_bytes,
           "sectors_per_child": sectors, "levels": levels, "npad": npad,
           "keys": len(uniq), "payloadC_mb": nbytes(sarr.payloadC) / 1e6,
           "nonempty": int((hi > lo)[:len(uniq)].sum()),
           "shape": f"{npad} slots x {levels} levels, {sarr.n}-char index"}
    phase(tag, f"{step} trie_level over {len(uniq)} keys ({npad} slots, "
          f"{levels} levels, payloadC {rec['payloadC_mb']:.1f} MB): "
          f"bit-equal to plain at every level; {1e3 * ms:.3f} us/level on "
          f"the device (enqueued {1e3 * enq:.3f}, plain "
          f"{1e3 * plain_ms:.3f}); bound with payloadC from HBM "
          f"{1e3 * bound_ms:.3f} us by {bound_by} ({table_bytes / 1e6:.2f} "
          f"MB/level), by its sectors {1e3 * sector_ms:.3f} us "
          f"({sector_bytes / 1e6:.2f} MB), payloadC in L2 "
          f"{1e3 * l2_ms:.3f} us; {sectors:.4f} payloadC sectors a child; "
          f"{levels} launches a chunk")
    return rec


def chr_probe_record(idx, graph, tag: str) -> dict:
    """dindex_probe over DINDEX_PAIRS pairs drawn as [dindex] (c) draws
    them, on this graph and index: verify_batch_device (one probe
    launch) equal to the NumPy verify_batch, the kernel bit-equal to
    probe_bisect_plain, its device time in turns with
    torch.searchsorted's (kernel, search, search, kernel), its enqueued
    and plain times and its bounds by bytes and by sectors."""
    import numpy as np
    import torch

    from psi_tpu_torch.ops import dindex_probe as dp
    from psi_tpu_torch.tools import pairs
    from psi_tpu_torch.tools.ggsim import simulate_haplotypes

    dmin, dmax = idx.dmin, idx.dmax
    t0 = time.monotonic()
    haps = [h for _, h in simulate_haplotypes(graph, 2, seed=13)]
    coords = pairs.hap_coords(graph, haps)
    pr = pairs.sample_pairs(coords, DINDEX_PAIRS, 2 * dmax, seed=dmax)
    v, o = pairs.loci(coords, pr["hap_a"], pr["pos_a"])
    u, p = pairs.loci(coords, pr["hap_b"], pr["pos_b"])
    draw_s = time.monotonic() - t0
    t0 = time.monotonic()
    want = idx.verify_batch(graph, v, o, u, p)
    host_s = time.monotonic() - t0
    n0 = dp.probe_bisect.launches
    with recorded(dp, "probe_bisect") as calls:
        t0 = time.monotonic()
        got = idx.verify_batch_device(graph, v, o, u, p)
        route_s = time.monotonic() - t0
    require(len(calls) == 1 and dp.probe_bisect.launches == n0 + 1,
            f"verify_batch_device made {len(calls)} probe_bisect calls")
    require(np.array_equal(got, want),
            "verify_batch_device differs from verify_batch")
    t, *q = calls[0]
    kernel, plain = dp.probe_bisect(t, *q), dp.probe_bisect_plain(t, *q)
    require(torch.equal(kernel, plain),
            "the probe kernel differs from probe_bisect_plain")
    turns = {"kernel": lambda: dp.probe_bisect(t, *q),
             "search": lambda: torch.searchsorted(t.pk, q[0], right=True)}
    timed = {name: [] for name in turns}
    for name in (*turns, *reversed(turns)):
        timed[name].append(cuda_ms(turns[name], KERNEL_REPS))
    ms, lib_ms = (sum(x) / 2 for x in timed.values())
    enq = enqueue_ms(turns["kernel"], KERNEL_REPS)
    plain_ms = cuda_ms(lambda: dp.probe_bisect_plain(t, *q), PLAIN_REPS)
    bytes_moved, sector_bytes, ops, _ = probe_work(t, q)
    bound_ms, bound_by = bound(bytes_moved, ops)
    sector_ms, _ = bound(sector_bytes, ops)
    B, n = q[0].numel(), t.pk.numel()
    rec = {"max_abs_err": max_abs_err(kernel, plain), "ms": ms,
           "enqueued_ms": enq, "plain_ms": plain_ms, "library_ms": lib_ms,
           "turns_ms": timed, "bound_ms": bound_ms, "hbm_bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": bytes_moved, "ops": ops,
           "sector_bound_ms": sector_ms,
           "sector_bytes": sector_bytes,
           "sectors_per_pair": probe_sectors(t, q[0]), "rows": n,
           "queries": B, "accepted": int(want.sum()),
           "pairs_per_s": B / (ms / 1e3), "draw_s": draw_s,
           "host_verify_s": host_s, "route_s": route_s,
           "shape": f"{B} pairs over {n} rows ({dmin}, {dmax})"}
    phase(tag, f"(e) dindex_probe: {B} pairs over {n} rows (drawn in "
          f"{draw_s:.1f} s), {rec['accepted']} accepted; "
          f"verify_batch_device (one launch) = verify_batch, the kernel "
          f"bit-equal to plain; {1e3 * ms:.3f} us on the device "
          f"(torch.searchsorted {1e3 * lib_ms:.3f} in turns, enqueued "
          f"{1e3 * enq:.3f}, plain {1e3 * plain_ms:.3f}); bound "
          f"{1e3 * bound_ms:.3f} us by {bound_by} ({bytes_moved / 1e6:.2f} "
          f"MB), by sectors {1e3 * sector_ms:.3f} us "
          f"({sector_bytes / 1e6:.2f} MB); {rec['sectors_per_pair']:.4f} "
          f"table sectors a pair; verify_batch on the host {host_s:.2f} s, "
          f"verify_batch_device {route_s:.2f} s")
    return rec


def chr_scale_phase(tmp: str, ref_mbp: float):
    """[chr-scale]: psi_tpu's chromosome-scale run (tools/chr_scale.py)
    through the port. (a) psikt over CHR_CHUNKS chunks on the card, the
    index built and saved once; (b) cuda = cpu on the first
    CHR_CPU_READS reads, the index loaded, with the WalkTree and under
    PSI_TRAV_CACHE=0; (c) chr_scale.run's stages on the loaded index; (d)
    trie_level and traverse_step at this scale against their plain
    versions, timed beside their bounds with the tables in HBM; (e) the
    distance index: the native build, the device build identical to it,
    and the probe. Returns (the phase's facts, the records of trie_level,
    traverse_step and dindex_probe at this scale, the launches of every
    kernel in (a))."""
    import numpy as np
    import torch

    from psi_tpu_torch.dindex import DistanceIndex
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.records import Records
    from psi_tpu_torch.tools import chr_scale as cr

    tag = "chr-scale"
    t_phase = time.monotonic()
    facts, records = {}, {}

    # the configuration's graph as GFA and its reads as FASTQ
    t0 = time.monotonic()
    graph = cr.make_graph(ref_mbp)
    graph_s = time.monotonic() - t0
    gfa = os.path.join(tmp, "chr.gfa")
    t0 = time.monotonic()
    cr.write_gfa(graph, gfa)
    gfa_s = time.monotonic() - t0
    n_reads = CHR_CHUNKS * cr.CHUNK
    t0 = time.monotonic()
    text = cr.label_text(graph)
    fastq = os.path.join(tmp, "chr.fastq")
    cr.write_fastq(cr.draw_reads(text, n_reads,
                                 np.random.RandomState(cr.READS_SEED)), fastq)
    reads_s = time.monotonic() - t0
    facts["data"] = {"ref_mbp": ref_mbp, "graph_s": graph_s, "gfa_s": gfa_s,
                     "gfa_bytes": os.path.getsize(gfa), "reads": n_reads,
                     "reads_s": reads_s}
    phase(tag, f"{ref_mbp} Mbp, {cr.N_COMPONENTS} components: "
          f"{graph.node_count} nodes in {graph_s:.1f} s; GFA "
          f"{os.path.getsize(gfa)} bytes in {gfa_s:.1f} s; {n_reads} reads "
          f"of {cr.READ_LEN} bp in {reads_s:.1f} s")
    del graph

    # (a) psikt on the card, the index built and saved once
    prefix = os.path.join(tmp, "chr_pidx")
    flags = (*cr.CLI_FLAGS, "-I", prefix)
    reset_counters()
    hits, rep, wall = run_cli(gfa, fastq, tmp, "cuda", cr.CHUNK, tag="_chr",
                              flags=flags)
    launches = read_counters()
    n = rep["pindexsize"]
    levels = cr.SEED_LEN - min(11, cr.SEED_LEN, (n.bit_length() - 1) // 2)
    route = rep["offpath"]
    chunks = len(rep["chunks"])
    steps = launches["traverse_step"]
    require(chunks == CHR_CHUNKS, f"the chr-scale run made {chunks} chunks")
    require(launches == {**ZERO_COUNTS, "trie_level": chunks * levels,
                         "trie_schedule": chunks, "traverse_step": steps}
            and (steps == 0 if route["route"] == "walktree" else
                 steps >= chunks * cr.SEED_LEN and steps % cr.SEED_LEN == 0),
            f"the chr-scale CLI run launched {launches}, expected "
            f"{chunks * levels} trie_level and, on the {route['route']} "
            f"route, {'no' if route['route'] == 'walktree' else 'k an attempt'}"
            f" traverse_step")
    b = rep["build"]
    phase(tag, f"(a) psikt {' '.join(cr.CLI_FLAGS)} -c {cr.CHUNK} -I: host "
          f"build stages, GFA parse {b['graph_load_s']:.1f} s, path pick "
          f"{b['pick_paths_s']:.1f}, paths and SA {b['index_paths_s']:.1f}, "
          f"loci {b['loci_s']:.1f}, distance index {b['dindex_s']:.1f}, "
          f"save {b['save_s']:.1f}, ftab {b['ftab_s']:.1f}")
    phase(tag, f"(a) index {n} chars (psi_tpu {PSI_TPU_CHR['chars']}), "
          f"{rep['totalnodes']} nodes ({PSI_TPU_CHR['nodes']}), "
          f"{rep['locino']} loci ({PSI_TPU_CHR['loci']}); off-path route "
          f"{route['route']} (WalkTree nodes: {route['walktree_nodes']}); "
          f"launches {launches} ({levels} trie_level a chunk)")
    res = summarize(rep, "chr-scale", wall)
    facts["cli"] = {**{k: v for k, v in res.items()}, "wall_s": wall,
                    "build": b, "offpath": route, "chars": n,
                    "nodes": rep["totalnodes"], "loci": rep["locino"],
                    "hits": len(hits), "launches": launches,
                    "levels": levels}
    require(res["hits_on"] > 0, "the chr-scale run found no on-path hits")

    # (b) cuda = cpu on the first reads, the index loaded
    small = head_fastq(fastq, os.path.join(tmp, "chr_small.fastq"),
                       CHR_CPU_READS)
    want = hits[hits[:, 2] < CHR_CPU_READS]
    facts["cpu"] = {"reads": CHR_CPU_READS, "hits": len(want)}
    for name, knob in (("walktree", "1"), ("traverse_device", "0")):
        with env("PSI_TRAV_CACHE", knob):
            got, rep_c, wall_c = run_cli(gfa, small, tmp, "cpu", cr.CHUNK,
                                         tag=f"_chr_{name}", flags=flags)
        require(got.tobytes() == want.tobytes(),
                f"chr-scale, first {CHR_CPU_READS} reads, {name}: cpu "
                f"{len(got)} vs cuda {len(want)} hits")
        facts["cpu"][name] = {"wall_s": wall_c, "build": rep_c["build"],
                              "offpath": rep_c["offpath"]}
        phase(tag, f"(b) --device cpu on the first {CHR_CPU_READS} reads "
              f"(index loaded in {rep_c['build']['load_s']:.1f} s), "
              f"PSI_TRAV_CACHE={knob} ({rep_c['offpath']['route']}): "
              f"lexsorted hits identical to cuda's ({len(got)}); wall "
              f"{wall_c:.1f} s")

    # (c) psi_tpu's stages, through chr_scale.run on the loaded index
    lg = load_graph(gfa)
    finder = cr.make_finder(lg)
    t0 = time.monotonic()
    require(finder.load_path_index(prefix, cr.CONTEXT, cr.STEP_SIZE,
                                   cr.DMIN, cr.DMAX),
            "the chr-scale path index did not load")
    load_s = time.monotonic() - t0
    run = cr.run(graph=lg, finder=finder,
                 log=lambda msg: phase(tag, f"(c) {msg}"))
    require(run["on_path_cold"]["hits"] > 0 and run["chars"] == n,
            "chr_scale.run found no on-path hits")
    facts["run"] = {**run, "load_s": load_s}

    # (d) the path's kernels at this scale, on chunk 1
    seqs = cr.draw_reads(cr.label_text(lg), cr.CHUNK,
                         np.random.RandomState(cr.READS_SEED))
    index = finder.index_reads(finder.get_seeds(
        Records([f"r{i}" for i in range(len(seqs))], seqs)))
    records["trie_level"] = chr_trie_record(finder, index, tag)
    records["traverse_step"], _ = traversal_record(finder, index,
                                                   cr.SEED_LEN, tag)
    ts = records["traverse_step"]
    phase(tag, f"(d) traverse_step: {cr.SEED_LEN} launches an attempt when "
          f"the device traversal is the route; {steps} in (a) on the "
          f"{route['route']} route")

    # (e) the distance index at (DMIN, DMAX): the native build again, in
    # memory (the artifact that (a) saved narrows its columns to int32)
    del index
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    nat = DistanceIndex.build(lg, cr.DMIN, cr.DMAX)
    native_s = time.monotonic() - t0
    for name in ("src_indptr", "dst", "iv_lo", "iv_hi"):
        require(np.array_equal(getattr(nat, name),
                               getattr(finder.dindex, name)),
                f"the native distance index's {name} differs from the "
                f"one (a) saved")
    facts["dindex"] = {"native": {"intervals": len(nat.dst),
                                  "build_s": native_s,
                                  "cli_build_s": b["dindex_s"]}}
    phase(tag, f"(e) native build ({cr.DMIN}, {cr.DMAX}): {len(nat.dst)} "
          f"intervals in {native_s:.2f} s ({b['dindex_s']:.2f} s in (a)), "
          f"equal to the artifact (a) saved")
    facts["dindex"]["device"] = device_build(lg, cr.DMIN, cr.DMAX, nat, tag)
    records["dindex_probe"] = chr_probe_record(nat, lg, tag)
    facts["phase_s"] = time.monotonic() - t_phase
    phase(tag, f"phase {facts['phase_s']:.1f} s; trie_level "
          f"{1e3 * records['trie_level']['ms']:.3f} us/level, "
          f"traverse_step {1e3 * ts['ms']:.3f} us/step, dindex_probe "
          f"{1e3 * records['dindex_probe']['ms']:.3f} us")
    del finder, nat
    torch.cuda.empty_cache()
    return facts, records, launches


# --- phase 19: the human-pan-genome-scale run ------------------------------

#: [gchar3]'s size in Gchar: 16 components of ~1 Mbp, ~0.5 M uncovered
#: loci at psi_tpu's density (its 3.0 Gchar run has 101.4 M); the full
#: sizes are `python3 -m psi_tpu_torch.tools.gchar3 2.0` and `3.0`
GCHAR3_SMOKE = 0.016
GCHAR3_CPU_READS = 2_000   # reads of the cuda = cpu check
#: the distance index's side-file threshold in [gchar3] (bytes): its
#: columns are ~0.1-1 MB at this size, so they go to side files and load
#: memory-mapped, the path of columns past the 1 GiB default (which even
#: psi_tpu's 3.0 Gchar artifact, 66.7 MB, stays under)
GCHAR3_BIG_COL_BYTES = 1 << 16
#: psi_tpu's recorded 3.0 Gchar run (docs/BENCH_NOTES.md, "3 Gchar
#: measured"), printed beside the port's
PSI_TPU_GCHAR3 = {"nodes": "9.0 M", "fm_chars": "3.00 G",
                  "loci": "101.4 M", "dindex_intervals": "27.1 M",
                  "distinct_keys": "500 K"}


@contextlib.contextmanager
def big_col_bytes(n: int):
    """DistanceIndex.BIG_COL_BYTES set to n around the block only."""
    from psi_tpu_torch.dindex import DistanceIndex

    old = DistanceIndex.BIG_COL_BYTES
    DistanceIndex.BIG_COL_BYTES = n
    try:
        yield
    finally:
        DistanceIndex.BIG_COL_BYTES = old


def gchar3_phase(tmp: str, gchar: float):
    """[gchar3]: psi_tpu's 3 Gchar configuration (tools/gchar3.py) at
    `gchar` Gchar through the port, under PSI_SA_DISK=1 (the disk-spilled
    suffix array) and GCHAR3_BIG_COL_BYTES (the artifact's side files).
    (a) gchar3.run on the card, the launch counters set to 0 just before
    and read just after: the stages and their counts, trie_level once a
    level in on_path, traverse_step once a step and attempt in off_path,
    nothing else; (b) gchar3.run on the cpu over the first
    GCHAR3_CPU_READS reads: the same index and lexsorted hits; (c)
    trie_level and traverse_step at this configuration's frontier and
    loci bit-equal to their plain versions, timed beside their bounds by
    bytes and by 32-byte sectors. Returns (the phase's facts, the records
    of trie_level and traverse_step, the launches of every kernel in
    (a))."""
    import numpy as np
    import torch

    from psi_tpu_torch.tools import gchar3 as g3

    tag = "gchar3"
    t_phase = time.monotonic()
    facts, records = {}, {}
    keep, cpu_keep = {}, {}
    workdir = os.path.join(tmp, "gchar3")
    os.makedirs(workdir)
    with env("PSI_SA_DISK", "1"), big_col_bytes(GCHAR3_BIG_COL_BYTES):
        # (a) the run on the card
        reset_counters()
        res = g3.run(gchar, workdir=workdir, keep=keep,
                     log=lambda msg: phase(tag, f"(a) {msg}"))
        launches = read_counters()
        finder, index = keep["finder"], keep["index"]
        require(isinstance(finder.pindex.fm.sa, np.memmap),
                "the gchar3 index was not built by the disk-spilled SA")
        # (b) the cpu over the first reads, on the same graph
        cpu = g3.run(gchar, GCHAR3_CPU_READS, "cpu", graph=keep["graph"],
                     keep=cpu_keep, log=lambda msg: None)
    require(res["device"].startswith("cuda"),
            f"gchar3.run ran on {res['device']}")
    stages = [k[:-2] for k in res if k.endswith("_s") and k != "total_s"]
    require(stages == ["graph_gen", "path_index", "uncovered_loci",
                       "dindex_artifact", "seeding", "read_index", "on_path",
                       "off_path"], f"gchar3.run's stages: {stages}")
    require(res["fm_chars"] < g3.QUERY_MAX_CHARS and "query_note" not in res,
            f"the gchar3 index has {res['fm_chars']} chars")
    require(min(res[k] for k in ("nodes", "loci", "dindex_intervals",
                                 "distinct_keys", "on_hits", "off_hits")) > 0
            and len(res["dindex_side_files"]) > 0,
            f"gchar3.run: {res}")
    route = res["off_path_route"]
    k = g3.SEED_LEN
    levels = k - finder._ftab_bits()   # one trie level a char past the ftab
    name = {f"{mod}.{attr}": kname
            for kname, ((mod, attr), *_) in KERNELS.items()}
    on, off = ({name.get(n, n): v for n, v in res[f"{s}_launches"].items()
                if v} for s in ("on_path", "off_path"))
    steps = k * route.get("attempts", 0)
    require(route["route"] == "traverse_device" and route["attempts"] >= 1,
            f"the gchar3 off-path route is {route}, not the device "
            f"traversal")
    require(on == {"trie_level": levels} and off == {"traverse_step": steps}
            and launches == {**ZERO_COUNTS, "trie_level": levels,
                             "trie_schedule": 1, "traverse_step": steps},
            f"the gchar3 run launched {launches} (on_path {on}, off_path "
            f"{off}), expected {levels} trie_level, one trie_schedule and "
            f"{steps} traverse_step")
    for key in ("nodes", "fm_chars", "loci", "dindex_intervals"):
        require(cpu[key] == res[key], f"gchar3 {key}: cpu {cpu[key]} vs "
                f"cuda {res[key]}")
    # the CLI's hit stream: gocc of an off-path hit counts the chunk's
    # seeds, so a chunk of other reads gives it other values
    quad = ["node_id", "node_offset", "read_id", "read_offset"]
    both = np.concatenate([keep["on"], keep["off"]])[quad]
    want = seed_rows(both[both["read_id"] < GCHAR3_CPU_READS])
    got = seed_rows(np.concatenate([cpu_keep["on"], cpu_keep["off"]])[quad])
    require(len(want) > 0 and got.tobytes() == want.tobytes(),
            f"gchar3, first {GCHAR3_CPU_READS} reads: cpu {len(got)} vs "
            f"cuda {len(want)} hits")
    facts["run"] = res
    facts["cpu"] = {"reads": GCHAR3_CPU_READS, "hits": len(got),
                    "stages_s": {s: cpu[s + "_s"] for s in stages},
                    "off_path_route": cpu["off_path_route"]}
    phase(tag, f"(a) {gchar} Gchar under PSI_SA_DISK=1: {res['nodes']} "
          f"nodes, {res['fm_chars']} chars, {res['loci']} loci, "
          f"{res['dindex_intervals']} intervals (side files "
          f"{res['dindex_side_files']}), {res['distinct_keys']} distinct "
          f"keys, {res['on_hits']} on-path and {res['off_hits']} off-path "
          f"hits; the device traversal at cap {route.get('cap')} after "
          f"{route.get('attempts')} attempt(s); launches {launches}; psi_tpu's "
          f"3.0 Gchar run: {PSI_TPU_GCHAR3}")
    phase(tag, "(a) stages " + ", ".join(
        f"{s} {res[s + '_s']:.2f} s" + (
            f" ({res[s + '_card_peak_mb']:.1f} MB on the card)"
            if s + "_card_peak_mb" in res else "") for s in stages)
        + f"; host peak {res['peak_gb']:.2f} GB")
    phase(tag, f"(b) --device cpu on the first {GCHAR3_CPU_READS} reads: the "
          f"same index and lexsorted hits ({len(got)}) as the card's; "
          f"{sum(facts['cpu']['stages_s'].values()):.1f} s")

    # (c) the path's kernels at this configuration
    records["trie_level"] = chr_trie_record(finder, index, tag, "(c)")
    records["traverse_step"], _ = traversal_record(finder, index, k, tag)
    facts["phase_s"] = time.monotonic() - t_phase
    phase(tag, f"phase {facts['phase_s']:.1f} s; trie_level "
          f"{1e3 * records['trie_level']['ms']:.3f} us/level, traverse_step "
          f"{1e3 * records['traverse_step']['ms']:.3f} us/step")
    del finder, index, keep, cpu_keep
    torch.cuda.empty_cache()
    return facts, records, launches


def stepwise_record(finder, index, k: int, tag: str) -> dict:
    """traverse_step over the finder's loci at the route's cap, doubled
    until the traversal fits, one step at a time with only the current
    state kept (traversal_record keeps every step's inputs, 30 states of
    20 bytes a slot, past the card's memory at caps of 2^27 and up): the
    kernel against its plain version at each step's input over the whole
    cap, its device time there by CUDA events, and the bounds by bytes
    and by 32-byte sectors with the graph and seeds tables from HBM."""
    import torch

    from psi_tpu_torch.ops import traverse as trav

    n = len(finder.starting_loci)
    g = finder._get_graph_arrays()
    seeds = trav.seeds_to_device(index, finder.device)
    cap = max(1 << 15, 1 << (n - 1).bit_length())
    attempts = 0
    while True:
        attempts += 1
        sn_d, so_d = finder._get_loci_device(cap)
        dev = sn_d.device
        state = trav.TraverseState(
            locus_idx=torch.arange(cap, dtype=torch.int32, device=dev),
            node=sn_d, off=so_d,
            lo=torch.zeros(cap, dtype=torch.int32, device=dev),
            hi=torch.full((cap,), seeds.size, dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            tstats=torch.zeros(3, dtype=torch.int64, device=dev))
        n_used, err, steps, ms, work, tables = n, 0, [], [], [], []
        for t in range(k):
            args = (g, seeds, t, state, n_used, cap)
            got = trav.traverse_step(*args)
            want = trav.traverse_step_plain(*args)
            (gs, *gc), (ws, *wc) = got, want
            err = max(err, *(max_abs_err(a, b)
                             for a, b in zip((*gs, *gc), (*ws, *wc))))
            del got, gs, gc
            ms.append(cuda_ms(lambda: trav.traverse_step(*args), 3))
            new_n, n2 = int(wc[0]), int(wc[1])
            steps.append((int(n_used), new_n, n2))
            work.append(step_work(int(n_used), new_n, n2, cap))
            tables.append(step_table_work(*args))
            state, n_used = ws, n2
            del args, want, wc
        overflow = bool(state.overflow)
        del state
        torch.cuda.empty_cache()
        require(err == 0,
                f"traverse_step differs from its plain version by {err}")
        if not overflow:
            break
        cap *= 2
    bound_ms, bound_by, bytes_moved, ops = mean_bound(
        [(b, o) for b, o, _ in work])
    table_bytes = bytes_moved + sum(b for b, _ in tables) / k
    sector_bytes = bytes_moved + sum(sb for _, sb in tables) / k
    hbm_bound_ms, hbm_bound_by = bound(table_bytes, ops)
    sector_bound_ms, _ = bound(sector_bytes, ops)
    rec = {"max_abs_err": err, "ms": sum(ms) / k, "step_ms": ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": bytes_moved,
           "ops": ops, "hbm_bound_ms": hbm_bound_ms,
           "hbm_bound_by": hbm_bound_by, "hbm_bytes": table_bytes,
           "sector_bound_ms": sector_bound_ms, "sector_bytes": sector_bytes,
           "loci": n, "cap": cap, "attempts": attempts, "steps": steps,
           "survivors": steps[-1][2],
           "shape": f"{cap} slots x {k} steps, {n} loci"}
    phase(tag, f"traverse_step over {n} loci at cap {cap} ({attempts} "
          f"attempt(s), {rec['survivors']} survivors): bit-equal to plain "
          f"at all {k} steps over the whole cap; {1e3 * rec['ms']:.3f} "
          f"us/step on the device (step 0 {1e3 * ms[0]:.3f}, last "
          f"{1e3 * ms[-1]:.3f}); bound {1e3 * bound_ms:.3f} us by {bound_by} "
          f"({bytes_moved / 1e6:.2f} MB/step); with the tables from HBM "
          f"{1e3 * hbm_bound_ms:.3f} us by {hbm_bound_by}, by their sectors "
          f"{1e3 * sector_bound_ms:.3f} us ({sector_bytes / 1e6:.2f} MB/step)")
    return rec


def gchar3_full(gchar: float) -> int:
    """The full-size runs of tools/gchar3 (PERF.md's G runs), alone:
    gchar3.run at `gchar` Gchar on the card with the warm query, its JSON
    written after every stage to chiprun_out/gchar3_<gchar>.json, and
    below 2^31 chars trie_level and traverse_step at that size against
    their plain versions, timed beside their bounds, in
    chiprun_out/gchar3_<gchar>_kernels.json. No other phase and no
    result line."""
    import torch

    from psi_tpu_torch.tools import gchar3 as g3

    tag = "gchar3-full"
    phase(tag, card_line())
    lib, lib_s, host, host_s = build_all()
    phase(tag, f"kernels built in {lib_s:.1f} s, host library {host_s:.1f} s")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    keep = {}
    reset_counters()
    res = g3.run(gchar, keep=keep, warm=True,
                 out_json=os.path.join(out, f"gchar3_{gchar}.json"),
                 log=lambda msg: phase(tag, msg))
    launches = read_counters()
    phase(tag, json.dumps({k: v for k, v in res.items()
                           if not k.endswith("_launches")}))
    phase(tag, f"launches (cold and warm query) {launches}")
    finder, index = keep["finder"], keep["index"]
    del keep
    # the off-path collect reads the loci from their Position objects
    # (ops/traverse.traverse_columnar_from_states), once a query
    loci = finder.get_starting_loci()
    t0 = time.monotonic()
    np_loci = ([p.node_id() for p in loci], [p.offset() for p in loci])
    loci_s = time.monotonic() - t0
    del np_loci
    phase(tag, f"the loci's node ids and offsets read from their {len(loci)} "
          f"Position objects, as the off-path collect reads them: "
          f"{loci_s:.3f} s")
    facts = {"card": card_line(), "launches": launches,
             "loci_read_s": loci_s}
    if "query_note" in res:
        with open(os.path.join(out, f"gchar3_{gchar}_kernels.json"),
                  "w") as fh:
            json.dump(facts, fh, indent=1)
        return 0
    records = {"trie_level": chr_trie_record(finder, index, tag, "")}
    # the on-path tables leave the card before the traversal at full cap
    finder._stream_arrays = finder._sa = finder._map_arrays = None
    torch.cuda.empty_cache()
    records["traverse_step"] = stepwise_record(finder, index, g3.SEED_LEN,
                                               tag)
    with open(os.path.join(out, f"gchar3_{gchar}_kernels.json"), "w") as fh:
        json.dump({**facts, "records": records}, fh, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref-len", type=int, default=REF_LEN,
                    help="reference length of the simulated pan-genome")
    ap.add_argument("--chunk", type=int, default=CHUNK,
                    help=f"reads per chunk ({N_CHUNKS} chunks are made)")
    ap.add_argument("--chr-mbp", type=float, default=CHR_MBP,
                    help="reference length in Mbp of [chr-scale]'s "
                    "4-component pan-genome")
    ap.add_argument("--gchar3", type=float, default=GCHAR3_SMOKE,
                    help="size in Gchar of [gchar3]'s 16-component "
                    "pan-genome")
    ap.add_argument("--gchar3-full", action="store_true",
                    help="run tools/gchar3 alone at --gchar3 Gchar with its "
                    "kernels timed (the full-size runs), no other phase")
    args = ap.parse_args(argv)
    t_start = time.monotonic()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "psi_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    if args.gchar3_full:
        return gchar3_full(args.gchar3)
    card = card_line()
    phase("card", card)
    name = torch.cuda.get_device_name(0)

    lib, lib_s, host, host_s = build_all()
    phase("build", f"CUDA kernels {lib} in {lib_s:.1f} s; native host "
          f"library {host} in {host_s:.1f} s, side by side")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # the graph loader caches parsed graphs under ~/.cache: keep it here
        os.environ["HOME"] = tmp
        t0 = time.monotonic()
        gfa, fastq = make_data(tmp, args.ref_len, N_CHUNKS * args.chunk)
        phase("data", f"{args.ref_len} bp graph + {N_CHUNKS * args.chunk} "
              f"reads in {time.monotonic() - t0:.1f} s")

        from psi_tpu_torch.io import load_graph
        from psi_tpu_torch.seed_finder import SeedFinder

        t0 = time.monotonic()
        finder = SeedFinder(load_graph(gfa), SEED_LEN)
        require(finder.device.type == "cuda",
                f"SeedFinder's default device is {finder.device}")
        finder.create_path_index(N_PATHS, patched=False)
        phase("index", f"{finder.pindex.fm.size} chars, "
              f"{len(finder.get_starting_loci())} loci in "
              f"{time.monotonic() - t0:.1f} s")
        reads, seeds, index = first_chunk_index(finder, fastq, args.chunk)
        t_phase = time.monotonic()
        records, extra = kernel_phase(finder, index)
        phase("kernels", f"phase {time.monotonic() - t_phase:.1f} s")
        t_phase = time.monotonic()
        (launches, route_ms, records["rank_lf_pair"], records["rank"],
         records["rank4 (backward-search positions)"]) = route_phase(
            finder, index)
        phase("routes", f"phase {time.monotonic() - t_phase:.1f} s")
        extra["route_ms_per_chunk"] = {
            r: {"device": d, "enqueued": e} for r, (d, e) in route_ms.items()}
        t_phase = time.monotonic()
        (records["occ_gather"], records["occ_lf_pair"],
         extra["gather"]) = gather_phase(finder, reads, index)
        phase("gather", f"phase {time.monotonic() - t_phase:.1f} s")
        launches["occ_gather"] = extra["gather"]["blocked_launches"]
        (records["range_refine4"], extra["traverse_step_bacterial"],
         extra["offpath"]) = offpath_phase(finder, index)
        extra.update(profile_query(finder, seeds, index))

        reset_counters()
        hits_cuda, rep_cuda, wall = run_cli(gfa, fastq, tmp, "cuda",
                                            args.chunk)
        cli_launches = read_counters()
        cuda_res = summarize(rep_cuda, "cuda", wall)
        n_chunks = len(rep_cuda["chunks"])
        want = {**ZERO_COUNTS, "trie_level": n_chunks * extra["levels"],
                "trie_schedule": n_chunks}
        require(cli_launches == want,
                f"the CLI run launched {cli_launches}, expected {want} "
                f"({n_chunks} chunks x {extra['levels']} levels, one plan "
                f"a chunk)")
        require(cuda_res["hits_on"] > 0 and cuda_res["hits_off"] > 0,
                "the CLI run found no on-path or no off-path hits")
        phase("cli-cuda", f"launches in the CLI run: {cli_launches}")
        launches["trie_level"] = cli_launches["trie_level"]
        launches["trie_schedule"] = cli_launches["trie_schedule"]

        # the MEM API carries occ_lf_pair (the gather phase's own run)
        launches["occ_lf_pair"] = extra["gather"]["mems"]["launches"]

        # the device traversal every chunk: PSI_TRAV_CACHE=0
        with env("PSI_TRAV_CACHE", "0"):
            reset_counters()
            hits_t, rep_t, wall = run_cli(gfa, fastq, tmp, "cuda", args.chunk,
                                          tag="_trav")
            trav_launches = read_counters()
        trav_res = summarize(rep_t, "trav", wall)
        n_trav = len(rep_t["chunks"])
        steps = trav_launches["traverse_step"]
        require(trav_launches == {**ZERO_COUNTS,
                                  "trie_level": n_trav * extra["levels"],
                                  "trie_schedule": n_trav,
                                  "traverse_step": steps}
                and steps >= n_trav * SEED_LEN and steps % SEED_LEN == 0,
                f"the PSI_TRAV_CACHE=0 CLI run launched {trav_launches}, "
                f"expected {n_trav * extra['levels']} trie_level and a "
                f"multiple of {SEED_LEN} traverse_step (at least "
                f"{n_trav * SEED_LEN})")
        require(hits_t.tobytes() == hits_cuda.tobytes(),
                f"device-traversal hit stream differs from the WalkTree "
                f"route's: {len(hits_t)} vs {len(hits_cuda)} hits")
        phase("cli-trav", f"launches {trav_launches}; lexsorted hit stream "
              f"identical to the WalkTree route's ({len(hits_t)} hits); "
              f"off-path {sum(c['offpath_s'] for c in rep_t['chunks']):.4f} "
              f"s over {n_trav} chunks (WalkTree route "
              f"{sum(c['offpath_s'] for c in rep_cuda['chunks']):.4f})")
        extra["cli_trav_traverse_step_launches"] = steps

        hits_cpu, rep_cpu, wall = run_cli(gfa, fastq, tmp, "cpu", args.chunk)
        summarize(rep_cpu, "cpu", wall)
        require(hits_cuda.shape == hits_cpu.shape
                and hits_cuda.tobytes() == hits_cpu.tobytes(),
                f"lexsorted hit streams differ: cuda {len(hits_cuda)} vs "
                f"cpu {len(hits_cpu)} hits")
        phase("cli-cpu", f"lexsorted hit streams identical "
              f"({len(hits_cuda)} hits)")

        # --mismatches 1 on one full chunk, then cuda = cpu on a small one
        t_mm = time.monotonic()
        mm = ("--mismatches", "1")
        one = head_fastq(fastq, os.path.join(tmp, "chunk1.fastq"), args.chunk)
        reset_counters()
        hits_m, rep_m, wall = run_cli(gfa, one, tmp, "cuda", args.chunk,
                                      tag="_mm1", extra=mm)
        mm_launches = read_counters()
        (c1,) = rep_m["chunks"]
        steps4 = mm_launches["range_refine4"]
        require(mm_launches == {**ZERO_COUNTS,
                                "trie_level": extra["levels"],
                                "trie_schedule": 1,
                                "range_refine4": steps4,
                                "traverse_step_approx": steps4}
                and steps4 >= SEED_LEN and steps4 % SEED_LEN == 0
                and c1["counters"].get("approx-step-launches") == steps4,
                f"the --mismatches 1 CLI run launched {mm_launches} "
                f"(counters {c1['counters']})")
        require(c1["hits_off"] > 0 and len(hits_m) > len(
            hits_cuda[hits_cuda[:, 2] < args.chunk]),
                "--mismatches 1 found no more hits than exact matching")
        mm_res = {"reads": c1["reads"], "keys": c1["keys"],
                  "hits_on": c1["hits_on"], "hits_off": c1["hits_off"],
                  "query_s": c1["query_s"], "onpath_s": c1["onpath_s"],
                  "offpath_s": c1["offpath_s"], "prepare_s": c1["prepare_s"],
                  "produce_s": c1["produce_s"], "wall_s": wall,
                  "kmer_queries_per_s": c1["keys"] / c1["query_s"],
                  "hits_per_s": len(hits_m) / c1["query_s"],
                  "launches": mm_launches}
        phase("cli-mismatch", f"{c1['reads']} reads, {c1['keys']} keys: "
              f"{len(hits_m)} hits ({c1['hits_on']} on path, "
              f"{c1['hits_off']} off path); query {c1['query_s']:.3f} s "
              f"(on-path {c1['onpath_s']:.3f}, off-path "
              f"{c1['offpath_s']:.3f}), trie plan {c1['prepare_s']:.3f} s, "
              f"producer {c1['produce_s']:.3f} s, wall {wall:.1f} s: "
              f"{mm_res['kmer_queries_per_s']:.1f} kmer-queries/s, "
              f"{mm_res['hits_per_s']:.1f} hits/s; launches {mm_launches}")
        launches["range_refine4"] = steps4
        launches["traverse_step_approx"] = steps4
        small = head_fastq(fastq, os.path.join(tmp, "small.fastq"),
                           N_MISMATCH_READS)
        mm_small = {device: run_cli(gfa, small, tmp, device, args.chunk,
                                    tag="_mm1_small", extra=mm)
                    for device in ("cuda", "cpu")}
        (hm_cuda, _, w_cuda), (hm_cpu, _, w_cpu) = mm_small.values()
        require(len(hm_cuda) > 0 and hm_cuda.tobytes() == hm_cpu.tobytes(),
                f"--mismatches 1 on {N_MISMATCH_READS} reads: cuda "
                f"{len(hm_cuda)} vs cpu {len(hm_cpu)} hits")
        phase("cli-mismatch", f"first {N_MISMATCH_READS} reads: lexsorted hit "
              f"streams of cuda ({w_cuda:.1f} s) and cpu ({w_cpu:.1f} s) "
              f"identical ({len(hm_cuda)} hits); phase "
              f"{time.monotonic() - t_mm:.1f} s")
        mm_res["small"] = {"reads": N_MISMATCH_READS, "hits": len(hm_cuda),
                           "cuda_wall_s": w_cuda, "cpu_wall_s": w_cpu}

        uniq = index._onpath_prep.uniq
        present = check_sampled_counts(finder, uniq, N_SAMPLED_KEYS)
        phase("counts", f"{min(N_SAMPLED_KEYS, len(uniq))} sampled keys "
              f"({present} present) agree with FMIndex.backward_search")
        t_phase = time.monotonic()
        extra["baseline"] = baseline_phase(finder, index)
        extra["tools"] = tools_phase(finder, tmp, gfa)
        phase("tools", f"[baseline] and [tools] "
              f"{time.monotonic() - t_phase:.1f} s")
        extra["mesh"] = mesh_phase(
            finder, reads, seeds, index, tmp, gfa, fastq,
            os.path.join(tmp, "pidx"), one, args.chunk, hits_cuda,
            extra["levels"], finder.device)
        del finder, reads, seeds, index
        torch.cuda.empty_cache()

        (records["traverse_step"], extra["offpath_scale"],
         launches["traverse_step"]) = offpath_scale_phase(tmp, args.chunk)

        (records["dindex_probe"], extra["dindex"],
         launches["dindex_probe"]) = dindex_phase(tmp, gfa, fastq, args.chunk)

        extra["chr_scale"], chr_records, chr_launches = chr_scale_phase(
            tmp, args.chr_mbp)

        extra["gchar3"], g3_records, g3_launches = gchar3_phase(
            tmp, args.gchar3)

        records["traverse_step_approx"], extra["approx_step"] = (
            approx_step_phase(tmp))

    paths = {"trie_level": f"psikt CLI, {n_chunks} chunks",
             "trie_schedule": f"psikt CLI, {n_chunks} chunks (one plan a "
                              f"chunk)",
             "rank4_pair": "trie_search(fused=False, pair=True), chunk 1",
             "compact": "trie_search(fused=False, pair=False), chunk 1",
             "rank4": "trie_search(fused=False, pair=False), chunk 1",
             "rank": "none: no route of the port runs it; its numbers come "
                     "from a replay of rank_stream over "
                     "backward_search_sorted's lo and hi of every step, "
                     "chunk 1",
             "rank_lf_pair": "backward_search_sorted, chunk 1",
             "occ_gather": "gather_occ_rows_blocked, one call",
             "occ_lf_pair": "find_mems_arrays (the MEM API), chunk 1's "
                            "reads",
             "traverse_step": f"psikt CLI on the dense cell (WalkTree over "
                              f"its cap), one chunk of {args.chunk} reads",
             "range_refine4": "psikt CLI with --mismatches 1, one chunk of "
                              f"{args.chunk} reads",
             "traverse_step_approx": "psikt CLI with --mismatches 1, one "
                                     f"chunk of {args.chunk} reads",
             "dindex_probe": f"alice dstats --device cuda, "
                             f"{DINDEX_GAF_PAIRS} read pairs against the "
                             f"{DINDEX_HORIZONS[0]} index"}
    require(chr_launches["trie_level"] > 0,
            "[chr-scale] (a) never launched trie_level")
    kernels = []
    for kname, (_, source, rows, replaces) in KERNELS.items():
        require(kname in OFF_PATH or launches[kname] > 0,
                f"{kname} was never launched on its path")
        rec = records[kname]
        # a time of 0 or one below the least the card could take was not
        # measured: the clock missed the kernel
        require(rec["ms"] > 0 and rec["ms"] >= rec["bound_ms"],
                f"{kname}: {rec['ms']} ms a launch against its bound "
                f"{rec['bound_ms']} ms")
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces[0], "replaces_all": replaces,
            "tpu_rows": rows, "launches": launches.get(kname, 0),
            "launches_path": paths[kname],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "enqueued_ms": rec["enqueued_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "bound_bytes": rec["bytes"], "bound_ops": rec["ops"],
            "library_ms": rec.get("library_ms"),
            "library": LIBRARY[kname],
            "shape": rec["shape"],
            "mesh_launches": mesh_launches(extra["mesh"], kname),
            "chr_scale_launches": chr_launches[kname],
            "gchar3_launches": g3_launches[kname],
        })
        for cell, recs in (("chr_scale", chr_records), ("gchar3", g3_records)):
            if kname in recs:
                kernels[-1][cell] = {k: recs[kname].get(k) for k in (
                    "ms", "enqueued_ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "hbm_bound_ms", "sector_bound_ms",
                    "l2_bound_ms", "shape")}
        if kname == "rank":
            kernels[-1]["replay_launches"] = rec["replay_launches"]
            kernels[-1]["trie_positions"] = {
                k: records["rank (trie positions)"][k] for k in
                ("ms", "enqueued_ms", "plain_ms", "bound_ms", "shape")}
        if kname == "rank_lf_pair":
            kernels[-1]["records_per_key"] = rec["records_per_key"]
        if kname == "trie_level":
            kernels[-1].update({k: rec[k] for k in (
                "sectors_per_child", "words_loaded_per_child",
                "records_per_child")})
        if kname == "rank4":
            kernels[-1]["records_per_position"] = rec["records_per_position"]
            scattered = records["rank4 (backward-search positions)"]
            kernels[-1]["scattered_positions"] = {
                k: scattered[k] for k in
                ("ms", "enqueued_ms", "plain_ms", "bound_ms",
                 "records_per_position", "shape")}
        if kname == "compact":
            kernels[-1].update({k: rec[k] for k in (
                "warm_ms", "sector_bound_ms", "sector_bytes",
                "r4_sectors_per_child")})
        if kname in ("occ_gather", "occ_lf_pair"):
            kernels[-1]["variants"] = {
                v: {k: r.get(k) for k in ("ms", "enqueued_ms", "plain_ms",
                                          "library_ms", "bound_ms", "bytes",
                                          "sector_bound_ms", "sector_bytes",
                                          "busy_ms", "sectors_per_key",
                                          "sectors_per_position")}
                for v, r in rec["variants"].items()}
        if kname == "occ_gather":
            kernels[-1].update({k: rec[k] for k in (
                "sector_bound_ms", "sector_bytes", "sectors_per_position")})
        if kname == "range_refine4":
            kernels[-1].update({k: rec[k] for k in (
                "plain_ops_per_step", "launches_per_traversal")})
        if kname == "traverse_step_approx":
            kernels[-1].update({k: rec[k] for k in ("cap_bound_ms",
                                                      "caps")})
        if kname == "dindex_probe":
            kernels[-1]["cells"] = {
                cell: {k: r[k] for k in (
                    "rows", "queries", "ms", "enqueued_ms", "plain_ms",
                    "sort_ms", "library_ms", "bound_ms",
                    "bound_by", "sector_bound_ms", "sectors_per_pair",
                    "pairs_per_s")}
                for cell, r in extra["dindex"]["probe"].items()}
            kernels[-1].update({k: rec[k] for k in (
                "sort_ms", "sector_bound_ms", "sector_bytes",
                "pairs_per_s")})
        if kname == "traverse_step":
            scale = extra["offpath_scale"]
            kernels[-1]["live_bound_ms"] = rec["live_bound_ms"]
            kernels[-1]["cells"] = {
                cell: {k: r[k] for k in (
                    "loci", "cap", "attempts", "survivors", "ms",
                    "enqueued_ms", "plain_ms", "bound_ms", "live_bound_ms",
                    "forms")}
                for cell, r in (
                    ("bacterial", extra["traverse_step_bacterial"]),
                    ("dense", rec), ("scale", scale["scale"]["traversal"]))}
            kernels[-1]["cli_trav_launches"] = extra[
                "cli_trav_traverse_step_launches"]
    summary = {
        "kernels": kernels,
        "card": card,
        "route": extra,
        "sustained": {k: v for k, v in cuda_res.items() if k != "chunks"},
        "sustained_trav": {k: v for k, v in trav_res.items()
                           if k != "chunks"},
        "mismatch": mm_res,
        "total_s": time.monotonic() - t_start,
    }
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as fh:
        json.dump({**summary, "chunks_cuda": cuda_res["chunks"],
                   "chunks_trav": trav_res["chunks"]}, fh, indent=2)
    phase("total", f"{summary['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
