"""The span and counter readers on hand-made spans: means over the
window's chunks, spans nested in a span of their name counted once, and
None where a window chunk lacks its spans or the program has no store."""

from collections import namedtuple
from types import SimpleNamespace

import pytest

from seedbench import harness
from seedbench.metrics import _spans

Span = namedtuple("Span", "name chunk id parent thread start_ns end_ns "
                          "cpu_ns")
MS = 1_000_000


def _spans_of(chunk, base_id, plan_ms, keys_cpu_ms):
    """A chunk's plan: prepare-onpath holding plan-keys (with an inner
    plan-keys), plan-schedule and plan-upload."""
    t = 10_000 * MS * (chunk + 1)
    return [
        Span("prepare-onpath", chunk, base_id, None, 1, t,
             t + 10 * plan_ms * MS, 0),
        Span("plan-keys", chunk, base_id + 1, base_id, 1, t,
             t + plan_ms * MS, keys_cpu_ms * MS),
        Span("plan-keys", chunk, base_id + 2, base_id + 1, 1, t,
             t + plan_ms * MS // 2, 0),
        Span("plan-schedule", chunk, base_id + 3, base_id, 1, t,
             t + 5 * plan_ms * MS, 5 * plan_ms * MS),
        Span("plan-upload", chunk, base_id + 4, base_id, 1, t,
             t + 4 * plan_ms * MS, 0),
    ]


def _run(chunk_ids, n=100):
    return SimpleNamespace(cell=SimpleNamespace(traffic={"chunk_reads": n}),
                           chunks=[{"chunk": j} for j in chunk_ids])


def test_means_over_the_window_chunks():
    spans = (_spans_of(200, 0, 10, 4) + _spans_of(300, 10, 20, 4)
             + _spans_of(400, 20, 90, 4))       # chunk 4: not in the window
    chunks = _spans.window_chunks(_run([2, 3]))
    assert chunks == [200, 300]
    assert _spans.mean_ms(chunks, spans, ("plan-keys",)) == 15.0
    assert _spans.mean_ms(chunks, spans, ("plan-schedule",)) == 75.0
    # wall less CPU: plan-keys 10 - 4 and 20 - 4, plan-schedule none
    assert _spans.mean_ms(chunks, spans, ("plan-keys", "plan-schedule"),
                          off_cpu=True) == 11.0
    counters = {("d2h-bytes", 200): 3_000_000, ("d2h-bytes", 400): 9}
    assert _spans.mean_count(chunks, spans, counters, "d2h-bytes",
                             1e-6) == pytest.approx(1.5)
    assert _spans.mean_count(chunks, spans, counters, "traverse-retries") == 0


def test_none_where_a_window_chunk_lacks_its_spans():
    spans = _spans_of(200, 0, 10, 4)
    assert _spans.mean_ms([200, 300], spans, ("plan-keys",)) is None
    assert _spans.mean_ms([200], spans, ("onpath-trie",)) is None
    assert _spans.mean_count([200, 300], spans, {}, "h2d-bytes") is None
    assert _spans.mean_ms([], spans, ("plan-keys",)) is None


def test_readers_without_a_store_return_none(monkeypatch):
    from psi_tpu_torch import stats

    run = _run([0])
    monkeypatch.delattr(stats, "spans")
    for name in ("plan_keys_ms", "plan_offcpu_ms", "h2d_mb",
                 "traverse_retries"):
        assert harness.reader(name)(run) is None


def test_readers_read_the_program_store():
    from psi_tpu_torch import stats
    from psi_tpu_torch.stats import Timer

    Timer.reset_all()
    try:
        for j in (1, 2):
            with stats.timeit_ts("seeds-off-path", chunk=50 * j):
                with stats.timeit_ts("offpath-fetch"):
                    stats.count("traverse-retries", j)
        run = _run([1, 2], n=50)
        assert harness.reader("traverse_retries")(run) == 1.5
        assert harness.reader("offpath_fetch_ms")(run) > 0
        assert harness.reader("onpath_trie_ms")(run) is None
    finally:
        Timer.reset_all()
