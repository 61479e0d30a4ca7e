"""The port's span store (psi_tpu_torch/stats.py): one chunk through
the CLI's stages records every stage and part, tagged with the chunk's
first read id and nested in its parent; NoStats records nothing; the
store is emptied by Timer.reset_all and drops its oldest entries past
its bound; timer periods nest; spans share torch.profiler's clock; and
psikt --report gives each chunk's spans and counters."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from psi_tpu_torch import cli, stats
from psi_tpu_torch import simulate as tsim
from psi_tpu_torch.graphiter import HaplotyperRandomIter
from psi_tpu_torch.pathutil import Path, sequence
from psi_tpu_torch.records import Records
from psi_tpu_torch.seed_finder import SeedFinder
from psi_tpu_torch.stats import NoStats, SeedFinderStats, Timer

K = 12
#: parent of each span name the chunk pipeline records
PARENT = {
    "seeding": None, "index-reads": None, "prepare-onpath": None,
    "plan-keys": "prepare-onpath", "plan-schedule": "prepare-onpath",
    "plan-upload": "prepare-onpath",
    "seeds-on-paths": None, "onpath-keys": "seeds-on-paths",
    "onpath-trie": "seeds-on-paths",
    "onpath-locate": "seeds-on-paths", "onpath-join": "seeds-on-paths",
    "seeds-off-path": None, "offpath-fetch": "seeds-off-path",
    "offpath-columns": "seeds-off-path",
}


def _haplotype_reads(graph, n, length, seed):
    itr = HaplotyperRandomIter(graph, seed=seed)
    hap = Path(graph)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = np.frombuffer(sequence(hap).encode(), dtype=np.uint8)
    rng = np.random.RandomState(seed)
    reads = hs[rng.randint(0, len(hs) - length, n)[:, None]
               + np.arange(length)]
    return [r.tobytes().decode() for r in reads]


@pytest.fixture(scope="module")
def graph_reads():
    """A bubble graph with one path indexed (many uncovered loci) and
    reads of a random haplotype: hits on and off the path."""
    graph = tsim.make_pangenome_graph(6000, 0.03, indel_frac=0.3, seed=21)
    return graph, _haplotype_reads(graph, 60, 48, 5)


#: the counters only the mismatch route records (seed_mismatches > 0)
BALL_COUNTERS = {"approx-slots", "plan-ball-keys"}


def _finder(graph, stats_obj, mismatches=0):
    f = SeedFinder(graph, K, stats=stats_obj, device="cpu",
                   seed_mismatches=mismatches)
    f.create_path_index(1, patched=False)
    return f


def _chunk(finder, seqs, offset):
    """The CLI's stages on one chunk: (on-path, off-path) hits."""
    reads = Records([f"r{i}" for i in range(len(seqs))], seqs,
                    rec_offset=offset)
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)
    finder.prepare_onpath(index)
    return finder.seeds_all_arrays(seeds, index, split=True)


@pytest.mark.parametrize("route", ["walktree", "device"])
def test_one_chunk_records_every_span_in_its_parent(graph_reads, monkeypatch,
                                                    route):
    graph, seqs = graph_reads
    if route == "device":
        monkeypatch.setenv("PSI_TRAV_CACHE", "0")
    Timer.reset_all()
    finder = _finder(graph, SeedFinderStats())
    _chunk(finder, seqs, 0)                 # builds the prefix table
    on, off = _chunk(finder, seqs, 700)
    assert len(on) and len(off)
    mine = [s for s in stats.spans() if s.chunk == 700]
    by_id = {s.id: s for s in stats.spans()}
    assert {s.name for s in mine} == set(PARENT)
    for s in mine:
        assert s.start_ns <= s.end_ns and s.cpu_ns >= 0
        if PARENT[s.name] is None:
            assert s.parent is None, s.name
            continue
        p = by_id[s.parent]
        assert p.name == PARENT[s.name] and p.chunk == 700
        assert p.thread == s.thread
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s.name
    secs, _ = stats.chunk_totals(700)
    assert secs["seeds-on-paths"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in mine
            if s.name == "seeds-on-paths") * 1e-9)
    assert set(secs) == set(PARENT)


@pytest.mark.parametrize("route", ["exact", "mismatch", "mismatch_retry"])
def test_mismatch_route_times_and_counts_its_ball_and_traversal(
        graph_reads, monkeypatch, route):
    """With seed_mismatches=1 each chunk times the Hamming ball in
    plan-keys and onpath-keys and the approximate traversal in
    offpath-fetch, the exact route's spans, and counts approx-slots (k x
    the cap of every attempt, the caps doubling), plan-ball-keys (the
    plan's distinct search keys) but no ball-dedup-rows (a ball of radius
    1 repeats no key of an origin, so nothing is sorted); with exact seeds
    none of them."""
    from psi_tpu_torch.ops.kmers import expand_hamming

    graph, seqs = graph_reads
    if route == "mismatch_retry":
        # a first cap of the loci alone, which the ball's states overflow
        real = SeedFinder._traverse_dispatch

        def small_cap(self, index, g=None, sa=None, cap=None):
            n = len(self.starting_loci)
            return real(self, index, g, sa,
                        cap or 1 << (n - 1).bit_length())
        monkeypatch.setattr(SeedFinder, "_traverse_dispatch", small_cap)
    mm = 0 if route == "exact" else 1
    Timer.reset_all()
    finder = _finder(graph, SeedFinderStats(), mm)
    _chunk(finder, seqs, 0)
    on, off = _chunk(finder, seqs, 700)
    assert len(on) and len(off)
    mine = [s for s in stats.spans() if s.chunk == 700]
    counts = {n: v for (n, c), v in stats.counters().items() if c == 700}
    assert {s.name for s in mine} == set(PARENT)
    if not mm:
        assert not set(counts) & BALL_COUNTERS
        return
    cap, attempts = (finder.last_traversal[n] for n in ("cap", "attempts"))
    assert attempts > 1 if route == "mismatch_retry" else attempts >= 1
    assert counts["approx-slots"] == K * sum(cap >> i
                                             for i in range(attempts))
    reads = Records([f"r{i}" for i in range(len(seqs))], seqs)
    keys = np.unique(finder.index_reads(finder.get_seeds(reads)).sorted_keys)
    assert counts["plan-ball-keys"] == len(np.unique(
        expand_hamming(keys, K, 1)[0]))
    assert "ball-dedup-rows" not in counts


def test_ball_dedup_rows_count_the_rows_sorted_past_radius_one():
    """A ball of radius 2 sorts every row it builds per origin and counts
    them in the chunk of the open span; radius 1 sorts and counts
    nothing."""
    from psi_tpu_torch.ops.kmers import expand_hamming

    keys = np.arange(5, dtype=np.uint64) * np.uint64(977)
    Timer.reset_all()
    with stats.timeit_ts("seeds-on-paths", chunk=40):
        expand_hamming(keys, K, 1)
    with stats.timeit_ts("seeds-on-paths", chunk=80):
        expand_hamming(keys, K, 2)
    counts = stats.counters()
    assert ("ball-dedup-rows", 40) not in counts
    assert counts[("ball-dedup-rows", 80)] == len(keys) * (
        1 + 3 * K + (3 * K) ** 2) > 0
    Timer.reset_all()


def test_traverse_retries_count_each_redispatch(graph_reads):
    graph, seqs = graph_reads
    Timer.reset_all()
    finder = _finder(graph, SeedFinderStats())
    reads = Records([f"r{i}" for i in range(len(seqs))], seqs,
                    rec_offset=60)
    index = finder.index_reads(finder.get_seeds(reads))
    n = len(finder.starting_loci)
    with finder.stats.timeit_ts("seeds-off-path", 60):
        finder._traverse_collect(index, finder._traverse_dispatch(
            index, cap=1 << (n - 1).bit_length()))
    attempts = finder.last_traversal["attempts"]
    assert attempts > 1
    assert stats.counters()[("traverse-retries", 60)] == attempts - 1
    fetch = [s for s in stats.spans() if s.name == "offpath-fetch"]
    assert len(fetch) == 1 and fetch[0].chunk == 60


def test_nostats_records_nothing(graph_reads):
    graph, seqs = graph_reads
    Timer.reset_all()
    finder = _finder(graph, NoStats())
    _chunk(finder, seqs, 0)
    assert stats.spans() == [] and stats.counters() == {}
    assert Timer.get_timers() == {}


def test_reset_all_empties_the_store():
    with stats.timeit_ts("a", chunk=3):
        stats.count("h2d-bytes", 5)
    assert stats.spans() and stats.counters()
    Timer.reset_all()
    assert stats.spans() == [] and stats.counters() == {}
    assert Timer.get_timers() == {}


def test_store_drops_its_oldest_entries_past_its_bound():
    Timer.reset_all()
    extra = 3
    for i in range(stats.SPAN_CAP + extra):
        with stats.timeit_ts("s", chunk=i):
            pass
    kept = stats.spans()
    assert len(kept) == stats.SPAN_CAP
    assert [s.chunk for s in kept[:2]] == [extra, extra + 1]
    assert kept[-1].chunk == stats.SPAN_CAP + extra - 1
    for i in range(stats.COUNTER_CAP + extra):
        with stats.timeit_ts("c", chunk=i):
            stats.count("d2h-bytes", i)
    got = stats.counters()
    assert len(got) == stats.COUNTER_CAP
    assert ("d2h-bytes", extra - 1) not in got
    assert got[("d2h-bytes", stats.COUNTER_CAP + extra - 1)] == (
        stats.COUNTER_CAP + extra - 1)
    Timer.reset_all()


def test_counters_go_to_the_open_span_chunk_and_count_crossings_only():
    Timer.reset_all()
    stats.count("h2d-bytes", 7)             # no open span: not counted
    host = torch.zeros(16, dtype=torch.int32)
    with stats.timeit_ts("outer", chunk=5):
        with stats.timeit_ts("inner"):
            stats.upload(host, "meta")      # leaves the host: 64 bytes
            stats.upload(host, "cpu")       # stays: not counted
            assert stats.download(host) is not None
            stats.count("traverse-retries", 2)
    assert stats.counters() == {("h2d-bytes", 5): 64,
                                ("traverse-retries", 5): 2}
    Timer.reset_all()


def test_timer_periods_nest():
    """An inner period of the same timer folds into the outer one (the
    WalkTree's build runs inside the off-path stage that triggers it)."""
    Timer.reset_all()
    with stats.timeit_ts("t", chunk=1) as outer:
        t0 = outer.timer.lap()
        with stats.timeit_ts("t"):
            pass
        assert outer.timer.lap() >= t0     # still running
        x = sum(range(200_000))            # time after the inner period
    assert x
    timer = outer.timer
    assert timer.count == 1
    (whole,) = [s for s in stats.spans() if s.parent is None]
    assert timer.total == pytest.approx(
        (whole.end_ns - whole.start_ns) * 1e-9)
    secs, _ = stats.chunk_totals(1)
    assert secs == {"t": timer.total}
    Timer.reset_all()


def test_first_chunk_offpath_time_holds_the_walktree_build(graph_reads):
    graph, seqs = graph_reads
    Timer.reset_all()
    finder = _finder(graph, SeedFinderStats())
    _chunk(finder, seqs, 0)
    off = [s for s in stats.spans() if s.name == "seeds-off-path"]
    nested = [s for s in off if s.parent is not None]
    assert len(nested) == 1                 # the WalkTree's build
    outer = [s for s in off if s.parent is None]
    total = sum(s.end_ns - s.start_ns for s in outer) * 1e-9
    assert Timer.get_duration_ts("seeds-off-path") == pytest.approx(total)
    assert stats.chunk_totals(0)[0]["seeds-off-path"] == pytest.approx(total)


def test_duration_reads_while_other_threads_add_timers():
    """get_duration_ts while 16 threads create new timer names."""
    Timer.reset_all()
    errors, stop = [], threading.Event()

    def make(i):
        for j in range(400):
            with stats.timeit_ts(f"n{i}-{j}"):
                pass

    def read():
        try:
            while not stop.is_set():
                Timer.get_duration_ts("n0")
                stats.spans()
        except Exception as exc:            # noqa: BLE001 the failure
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        reader.start()
        makers = [threading.Thread(target=make, args=(i,)) for i in range(16)]
        for t in makers:
            t.start()
        for t in makers:
            t.join(timeout=60)
        stop.set()
        reader.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not reader.is_alive() and not any(t.is_alive() for t in makers)
    assert errors == []
    assert len(stats.spans()) == 16 * 400
    Timer.reset_all()


def test_span_shares_the_profiler_clock(tmp_path):
    """A span and a record_function range around the same work start
    within 1 ms on the exported Chrome trace's clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    Timer.reset_all()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with stats.timeit_ts(f"probe{i}", chunk=i):
                with record_function(f"probe{i}"):
                    sum(range(50_000))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ranges = {e["name"]: e["ts"] + base_us for e in trace["traceEvents"]
              if str(e.get("name", "")).startswith("probe")
              and e.get("ph") == "X"}
    for s in stats.spans():
        assert abs(s.start_ns / 1e3 - ranges[s.name]) < 1000.0, s.name
    Timer.reset_all()


def test_cli_report_gives_each_chunk_its_spans_and_counters(graph_reads,
                                                             tmp_path):
    graph, seqs = graph_reads
    gpath = tmp_path / "graph.npz"
    graph.save(str(gpath))
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i, r in enumerate(seqs):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    rep = tmp_path / "rep.json"
    assert cli.main([str(gpath), "-f", str(fq), "-l", str(K), "-n", "1", "-P",
                     "-c", "25", "-o", str(tmp_path / "hits.bin"),
                     "--report", str(rep), "--device", "cpu", "-q",
                     "-Q"]) == 0
    chunks = json.loads(rep.read_text())["chunks"]
    assert len(chunks) == 3
    for c in chunks:
        assert set(PARENT) <= set(c["spans"])
        assert c["spans"]["seeds-on-paths"] == pytest.approx(c["onpath_s"])
        assert c["spans"]["seeds-off-path"] == pytest.approx(c["offpath_s"])
        assert c["spans"]["prepare-onpath"] <= c["prepare_s"]
        assert isinstance(c["counters"], dict)


def test_cli_report_gives_the_mismatch_route_its_counters(graph_reads,
                                                          tmp_path):
    """psikt --mismatches 1 --report: each chunk's counters hold
    approx-slots and plan-ball-keys beside plan-device-keys, and no
    ball-dedup-rows."""
    graph, seqs = graph_reads
    gpath = tmp_path / "graph.npz"
    graph.save(str(gpath))
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i, r in enumerate(seqs):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    rep = tmp_path / "rep.json"
    assert cli.main([str(gpath), "-f", str(fq), "-l", str(K), "-n", "1", "-P",
                     "-c", "30", "--mismatches", "1", "-o",
                     str(tmp_path / "hits.bin"), "--report", str(rep),
                     "--device", "cpu", "-q", "-Q"]) == 0
    chunks = json.loads(rep.read_text())["chunks"]
    assert len(chunks) == 2
    for c in chunks:
        assert {"plan-keys", "onpath-keys", "offpath-fetch"} <= set(
            c["spans"])
        assert {"plan-device-keys"} | BALL_COUNTERS <= set(c["counters"])
        assert c["counters"]["approx-slots"] % K == 0
        assert c["counters"]["approx-slots"] > 0
        assert c["counters"]["plan-ball-keys"] > 0
        assert "ball-dedup-rows" not in c["counters"]
