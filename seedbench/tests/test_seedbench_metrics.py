"""Metric arithmetic on hand-made records and traces."""

import json
import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from seedbench import harness, roofline, trace
from seedbench.metrics import _common


def _run(chunks, window_s=2.0, **kw):
    return SimpleNamespace(chunks=chunks, window_s=window_s, trace=None,
                           setup_s=12.5, **kw)


def test_rates_percentile_and_means():
    chunks = [{"ref_keys": 100, "ref_hits": 300, "t_take": i,
               "t_done": i + 0.1 * i,
               "produce_s": 0.002 * i} for i in range(1, 21)]
    run = _run(chunks)
    assert harness.reader("kmer_queries_per_s")(run) == 1000.0
    assert harness.reader("hits_per_s")(run) == 3000.0
    # 20 latencies 0.1..2.0: the nearest-rank 90th is the 18th
    assert harness.reader("chunk_p90_s")(run) == pytest.approx(1.8)
    assert harness.reader("produce_ms")(run) == pytest.approx(21.0)
    assert harness.reader("setup_s")(run) == 12.5
    assert _common.percentile([5.0], 90) == 5.0
    assert _common.percentile(range(1, 101), 90) == 90.0


def test_trie_level_work_counts_distinct_prefixes_below_the_table():
    k = 4
    # keys AAAA, AAAC, CAAA: depth-p table p = 1 for a 16-char text
    keys = np.array([0b00000000, 0b00000001, 0b01000000])
    assert roofline.distinct_prefixes(keys, k) == [1, 2, 2, 2, 3]
    assert roofline.prefix_depth(k, 16) == 2
    b, o = roofline.trie_level_work(keys, k, 16)
    # levels 3, 4: children 2 + 3, parents 2 + 2
    assert (b, o) == (16 * 5 + 8 * 4, 20 * 5)
    assert roofline.prefix_depth(20, 10_004_062) == 11


def test_traverse_step_work_and_least_time():
    b, o = roofline.traverse_step_work([10, 6, 2, 0])
    assert b == 20 * (10 + 6 + 6 + 2 + 2 + 0) and o == 60 * 8
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_live_states_follow_seed_prefixes(tmp_path):
    """A chain ACG -> {T, A} -> C: from the locus at A, seeds ACGTC and
    ACGAA keep both branches alive to depth 4 and one to depth 5."""
    from seedbench import reference

    gfa = tmp_path / "g.gfa"
    gfa.write_text("S\t1\tACG\nS\t2\tT\nS\t3\tA\nS\t4\tC\n"
                   "L\t1\t+\t2\t+\t0M\nL\t1\t+\t3\t+\t0M\n"
                   "L\t2\t+\t4\t+\t0M\nL\t3\t+\t4\t+\t0M\n")
    g = reference.GfaGraph(str(gfa))
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    key = lambda s: sum(code[c] << 2 * (len(s) - 1 - i)  # noqa: E731
                        for i, c in enumerate(s))
    live = roofline.live_states(g, np.array([0]),
                                np.array([key("ACGTC"), key("ACGAA")]), 5,
                                "cpu")
    assert live == [1, 1, 1, 1, 2, 1]


def test_trace_reduction_busy_idle_and_kernels(tmp_path):
    ev = [
        {"ph": "X", "name": "seedbench.window", "cat": "user_annotation",
         "ts": 1000, "dur": 1000},
        {"ph": "X", "name": "seedbench.query", "cat": "user_annotation",
         "ts": 1000, "dur": 400},
        {"ph": "X", "name": "seedbench.wait_plan", "cat": "user_annotation",
         "ts": 1400, "dur": 600},
        {"ph": "X", "name": "trie_level_kernel", "cat": "kernel",
         "ts": 1100, "dur": 100},
        {"ph": "X", "name": "trie_level_kernel", "cat": "kernel",
         "ts": 1150, "dur": 100},
        {"ph": "X", "name": "Memcpy DtoH", "cat": "gpu_memcpy",
         "ts": 1900, "dur": 200},
        {"ph": "X", "name": "aten::add", "cat": "cpu_op",
         "ts": 1000, "dur": 900},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    r = trace.reduce(str(path))
    # device busy 1100-1250 and 1900-2000 (clipped to the window)
    assert r["busy_s"] == pytest.approx(250e-6)
    assert r["window_s"] == pytest.approx(1e-3)
    assert trace.kernel_seconds(r, "trie_level") == pytest.approx(200e-6)
    # gaps 1000-1100 during the query, 1250-1900 waiting for the plan
    assert r["idle"]["query"] == pytest.approx(100e-6)
    assert r["idle"]["wait_plan"] == pytest.approx(650e-6)
    run = _run([])
    run.trace = r
    assert harness.reader("device_idle_pct")(run) == pytest.approx(75.0)


def test_roofline_reader_is_silent_without_the_kernel():
    run = _run([])
    run.trace = {"busy_s": 1.0, "window_s": 2.0, "ops": {}, "idle": {}}
    assert harness.reader("trie_level_roofline_pct")(run) is None
    assert harness.reader("traverse_step_roofline_pct")(run) is None


def test_spread_is_the_stdlib_quartile_distance():
    """PERF.md's spreads: (Q3 - Q1) / median by statistics.quantiles."""
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert (q3 - q1) / statistics.median(v) == pytest.approx(3.5 / 12.5)
