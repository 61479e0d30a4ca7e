"""Timers, spans, counters, and progress observation.

Mirrors the reference observability surface (ref: include/psi/stats.hpp:
named cumulative process-global timers with laps, :190-375; compile-time
no-op variant :377-447) and the SeedFinder progress/stats machinery
(ref: include/psi/seed_finder.hpp:111-494): per-thread stats, gocc
averages/skips, and a SIGUSR1 live progress dump.

Every period of a thread-scoped timer is also kept as a Span in a
bounded process-global store: its chunk (the first read id of the chunk
it serves), its enclosing span, its thread, its start and end on the
realtime clock and the thread's CPU time. Counters of the same store
add up, per chunk, what a stage moves or retries (`count`, `upload`,
`download`). `Timer.reset_all` empties the store.
"""

from __future__ import annotations

import itertools
import signal
import threading
import time
from collections import OrderedDict, defaultdict, deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple


#: spans the store keeps, oldest dropped first. A chunk of the CLI's
#: pipeline records ~20 (its producer, plan and query stages and their
#: parts), so the store holds ~3,000 chunks: 25 minutes of 100,000-read
#: chunks every half second.
SPAN_CAP = 1 << 16
#: (name, chunk) counters kept, oldest dropped first
COUNTER_CAP = 1 << 14

#: realtime ns at monotonic 0, read once: spans are timed on the
#: monotonic clock and shifted onto the realtime clock, which
#: torch.profiler's Chrome trace uses (its `ts` plus `baseTimeNanoseconds`)
_EPOCH_NS = time.time_ns() - time.monotonic_ns()


class Span(NamedTuple):
    """One period of a thread-scoped timer."""

    name: str
    #: first read id of the chunk the work serves (`Records.rec_offset`),
    #: inherited from the enclosing span; None outside any chunk
    chunk: Optional[int]
    id: int
    #: id of the enclosing span on the same thread, or None
    parent: Optional[int]
    thread: int
    start_ns: int       # realtime ns
    end_ns: int
    cpu_ns: int         # CPU time of the thread over the period


class Timer:
    """Named cumulative timer with a process-global registry. Periods of
    one timer nest: an inner period on the same thread folds into the
    outer one."""

    _timers: Dict[str, "Timer"] = {}
    _lock = threading.Lock()
    _spans: Deque[Span] = deque(maxlen=SPAN_CAP)
    _counters: "OrderedDict[Tuple[str, Optional[int]], int]" = OrderedDict()

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._depth = 0
        self._started: Optional[int] = None    # monotonic ns

    def __enter__(self):
        self._start(time.monotonic_ns())
        return self

    def __exit__(self, *exc):
        self._stop(time.monotonic_ns())
        return False

    def _start(self, now_ns: int):
        if not self._depth:
            self._started = now_ns
        self._depth += 1

    def _stop(self, now_ns: int):
        if not self._depth:
            return
        self._depth -= 1
        if not self._depth:
            self.total += (now_ns - self._started) * 1e-9
            self.count += 1
            self._started = None

    def lap(self) -> float:
        """Duration including an in-flight period (ref lap semantics)."""
        started = self._started
        if started is not None:
            return self.total + (time.monotonic_ns() - started) * 1e-9
        return self.total

    @classmethod
    def get(cls, name: str) -> "Timer":
        with cls._lock:
            if name not in cls._timers:
                cls._timers[name] = Timer(name)
            return cls._timers[name]

    @classmethod
    def get_timers(cls) -> Dict[str, "Timer"]:
        with cls._lock:
            return dict(cls._timers)

    @classmethod
    def get_duration(cls, name: str) -> float:
        t = cls._timers.get(name)
        return t.lap() if t else 0.0

    @classmethod
    def get_duration_ts(cls, name: str) -> float:
        """Summed duration over all thread-scoped instances of a timer
        (timeit_ts suffixes names with the thread id, so an exact-name
        lookup never matches; ref thread-scoped timers:
        seed_finder.hpp:427-456)."""
        prefix = name + "-"
        return sum(
            t.lap() for n, t in cls.get_timers().items()
            if n == name or n.startswith(prefix)
        )

    @classmethod
    def reset_all(cls):
        with cls._lock:
            cls._timers.clear()
            cls._spans.clear()
            cls._counters.clear()


_local = threading.local()
_span_ids = itertools.count()


def _open_spans() -> List["_Period"]:
    """This thread's open periods, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Period:
    """One period of a thread-scoped timer; on exit it is also stored as
    a Span. Its chunk, unless given, is the enclosing period's."""

    __slots__ = ("timer", "name", "chunk", "id", "parent", "t0", "c0")

    def __init__(self, timer: Timer, name: str, chunk: Optional[int]):
        self.timer, self.name, self.chunk = timer, name, chunk

    def __enter__(self):
        stack = _open_spans()
        self.parent = None
        if stack:
            self.parent = stack[-1].id
            if self.chunk is None:
                self.chunk = stack[-1].chunk
        self.id = next(_span_ids)
        stack.append(self)
        self.c0 = time.thread_time_ns()
        self.t0 = time.monotonic_ns()
        self.timer._start(self.t0)
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        c1 = time.thread_time_ns()
        self.timer._stop(t1)
        _open_spans().pop()
        span = Span(self.name, self.chunk, self.id, self.parent,
                    threading.get_ident(), self.t0 + _EPOCH_NS,
                    t1 + _EPOCH_NS, c1 - self.c0)
        with Timer._lock:
            Timer._spans.append(span)
        return False


def timeit_ts(name: str, chunk: Optional[int] = None) -> _Period:
    """A period of the thread-scoped timer `name` (name suffixed with
    thread id, ref: seed_finder.hpp:427-456), stored as a span of
    `chunk` (by default the enclosing span's)."""
    return _Period(Timer.get(f"{name}-{threading.get_ident()}"), name, chunk)


def child_ts(name: str):
    """`timeit_ts(name)` when a span is open on this thread, else a
    no-op: the stages below SeedFinder time their parts only inside a
    timed stage (never under NoStats)."""
    return timeit_ts(name) if _open_spans() else _NOOP_TIMER


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` of the chunk of this thread's innermost
    open span; nothing when no span is open."""
    stack = _open_spans()
    if not stack:
        return
    key = (name, stack[-1].chunk)
    with Timer._lock:
        c = Timer._counters
        c[key] = c.get(key, 0) + int(n)
        if len(c) > COUNTER_CAP:
            c.popitem(last=False)


def upload(t, device):
    """`t.to(device)`, counting the bytes as h2d-bytes when they leave
    the host."""
    out = t.to(device)
    if t.device.type == "cpu" and out.device.type != "cpu":
        count("h2d-bytes", t.nbytes)
    return out


def download(t):
    """`t.cpu()`, counting the bytes as d2h-bytes when `t` is on a
    device."""
    if t.device.type != "cpu":
        count("d2h-bytes", t.nbytes)
    return t.cpu()


def spans() -> List[Span]:
    """The stored spans, oldest first."""
    with Timer._lock:
        return list(Timer._spans)


def counters() -> Dict[Tuple[str, Optional[int]], int]:
    """{(name, chunk): value} of the stored counters."""
    with Timer._lock:
        return dict(Timer._counters)


def chunk_totals(chunk: int) -> Tuple[Dict[str, float], Dict[str, int]]:
    """({span name: seconds}, {counter name: value}) of one chunk. A span
    inside a span of the same name is already in its time."""
    mine = [s for s in spans() if s.chunk == chunk]
    by_id = {s.id: s for s in mine}
    secs: Dict[str, float] = {}
    for s in mine:
        p = by_id.get(s.parent)
        while p is not None and p.name != s.name:
            p = by_id.get(p.parent)
        if p is None:
            secs[s.name] = (secs.get(s.name, 0.0)
                            + (s.end_ns - s.start_ns) * 1e-9)
    return secs, {n: v for (n, c), v in counters().items() if c == chunk}


class ProgressEnum:
    IDLE = "idle"
    SELECT_PATHS = "select-paths"
    CREATE_PINDEX = "create-pindex"
    FIND_UNCOVERED = "find-uncovered"
    CREATE_DINDEX = "create-dindex"
    WRITE_PINDEX = "write-pindex"
    LOAD_PINDEX = "load-pindex"
    WRITE_STARTS = "write-starts"
    LOAD_STARTS = "load-starts"
    WRITE_DINDEX = "write-dindex"
    LOAD_DINDEX = "load-dindex"
    READY = "ready"

    # per-thread sub-states
    SEED_CHUNK = "seed-chunk"
    INDEX_CHUNK = "index-chunk"
    FIND_ON_PATHS = "find-on-paths"
    FIND_OFF_PATHS = "find-off-paths"
    FIND_MEMS = "find-mems"
    QUERY_DINDEX = "query-dindex"


class ThreadStats:
    """Per-thread counters (ref: seed_finder.hpp:122-240)."""

    def __init__(self):
        self.progress = ProgressEnum.IDLE
        self.chunks_done = 0
        self.locus_idx = 0
        self.seed_gocc_sum = 0
        self.seed_gocc_n = 0
        self.gocc_skips = 0
        # traversal counters (ref TraverserStats, traverser_base.hpp:103-268)
        self.godowns = 0
        self.paths_traversed = 0
        self.paths_len_sum = 0

    def set_progress(self, p: str):
        self.progress = p

    def inc_chunks_done(self):
        self.chunks_done += 1

    def set_locus_idx(self, idx: int):
        self.locus_idx = idx

    def add_seed_gocc(self, count: int):
        self.seed_gocc_sum += count
        self.seed_gocc_n += 1

    def add_seed_gocc_bulk(self, total: int, n: int):
        """Accumulate n seeds with summed gocc `total` in O(1) (the hot
        path feeds whole emit batches; per-seed Python calls were
        O(distinct k-mers) per chunk)."""
        self.seed_gocc_sum += total
        self.seed_gocc_n += n

    def inc_gocc_skips(self, n: int = 1):
        self.gocc_skips += n

    def avg_gocc(self) -> float:
        return self.seed_gocc_sum / self.seed_gocc_n if self.seed_gocc_n else 0.0

    def add_traversal(self, godowns: int, n_paths: int, len_sum: int):
        """Per-chunk traversal counters: attempted descents (go-downs),
        ended/complete paths, summed path lengths (for the streaming
        average; ref: traverser_base.hpp:158-231)."""
        self.godowns += godowns
        self.paths_traversed += n_paths
        self.paths_len_sum += len_sum

    def avg_pathlen(self) -> float:
        return (
            self.paths_len_sum / self.paths_traversed
            if self.paths_traversed else 0.0
        )


class SeedFinderStats:
    """Process stats + tracked-singleton SIGUSR1 progress dump
    (ref: seed_finder.hpp:275-338)."""

    _tracked: Optional["SeedFinderStats"] = None

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.progress = ProgressEnum.IDLE
        self._threads: Dict[int, ThreadStats] = defaultdict(ThreadStats)
        self.total_loci = 0

    def set_progress(self, p: str):
        if self.enabled:
            self.progress = p

    def get_this_thread_stats(self) -> ThreadStats:
        return self._threads[threading.get_ident()]

    def timeit_ts(self, name: str, chunk: Optional[int] = None):
        if not self.enabled:
            return _NOOP_TIMER
        return timeit_ts(name, chunk)

    def report(self) -> str:
        lines = [f"progress: {self.progress}"]
        for tid, ts in self._threads.items():
            pct = (
                f" ({100.0 * ts.locus_idx / self.total_loci:.1f}% loci)"
                if self.total_loci
                else ""
            )
            lines.append(
                f"  thread {tid}: {ts.progress} chunks={ts.chunks_done}"
                f" avg_gocc={ts.avg_gocc():.2f} skips={ts.gocc_skips}{pct}"
            )
        for name, t in sorted(Timer.get_timers().items()):
            lines.append(f"  timer {name}: {t.lap():.3f}s x{t.count}")
        return "\n".join(lines)

    @classmethod
    def track(cls, stats: "SeedFinderStats"):
        cls._tracked = stats

    @classmethod
    def install_signal_handler(cls):
        def handler(signum, frame):
            if cls._tracked is not None:
                print(cls._tracked.report(), flush=True)

        try:
            signal.signal(signal.SIGUSR1, handler)
        except ValueError:
            pass  # not in main thread


class _NoopTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def lap(self):
        return 0.0


_NOOP_TIMER = _NoopTimer()


class NoStats(SeedFinderStats):
    """All-no-op stats (ref: seed_finder.hpp:501-726)."""

    def __init__(self):
        super().__init__(enabled=False)
