"""What the readers of the program's own spans and counters share
(psi_tpu_torch/stats.py: every period of a SeedFinder stage timer is
kept as a span tagged with the chunk it serves, its first read id).

The window's chunks are found by id: the loop gives chunk j the read ids
from j * chunk_reads. A metric is the mean over the window's chunks of
a chunk's summed span milliseconds, or of a counter. A span inside a
span of the same name is already in that span's time. Each reader
returns None where the program keeps no such store, and where a window
chunk lacks the spans read (a store that dropped its oldest spans), so
a partial store never gives a mean over fewer chunks."""

from __future__ import annotations


def store():
    """(spans, counters) of the program's store, or None without one."""
    try:
        from psi_tpu_torch import stats
    except ImportError:
        return None
    spans, counters = (getattr(stats, n, None) for n in ("spans", "counters"))
    if not (callable(spans) and callable(counters)):
        return None
    return spans(), counters()


def window_chunks(run) -> list:
    n = run.cell.traffic["chunk_reads"]
    return [c["chunk"] * n for c in run.chunks]


def _outermost(spans, chunks) -> dict:
    """{chunk: [spans of the chunk not inside a span of their name]}."""
    want = set(chunks)
    by_chunk = {c: {} for c in want}
    for s in spans:
        if s.chunk in want:
            by_chunk[s.chunk][s.id] = s
    out = {}
    for c, by_id in by_chunk.items():
        keep = []
        for s in by_id.values():
            p = by_id.get(s.parent)
            while p is not None and p.name != s.name:
                p = by_id.get(p.parent)
            if p is None:
                keep.append(s)
        out[c] = keep
    return out


def mean_ms(chunks, spans, names, off_cpu: bool = False):
    """Mean over `chunks` of the summed milliseconds of the spans named
    in `names` (with `off_cpu`, each span's wall time less its thread's
    CPU time); None if a chunk has none of them or there is no chunk."""
    if not chunks:
        return None
    per = _outermost(spans, chunks)
    total = 0
    for c in chunks:
        mine = [s for s in per[c] if s.name in names]
        if not mine:
            return None
        total += sum(s.end_ns - s.start_ns - (s.cpu_ns if off_cpu else 0)
                     for s in mine)
    return 1e-6 * total / len(chunks)


def mean_count(chunks, spans, counters, name, scale: float = 1.0):
    """Mean over `chunks` of counter `name` times `scale` (0 where the
    chunk counted none); None if a chunk has no span at all."""
    if not chunks:
        return None
    seen = {s.chunk for s in spans}
    if not all(c in seen for c in chunks):
        return None
    return scale * sum(counters.get((name, c), 0) for c in chunks) / len(
        chunks)


def read_ms(run, *names, off_cpu: bool = False):
    got = store()
    if got is None:
        return None
    return mean_ms(window_chunks(run), got[0], names, off_cpu)


def read_count(run, name, scale: float = 1.0):
    got = store()
    if got is None:
        return None
    return mean_count(window_chunks(run), got[0], got[1], name, scale)
