"""Timers, counters, and progress observation.

Mirrors the reference observability surface (ref: include/psi/stats.hpp:
named cumulative process-global timers with laps, :190-375; compile-time
no-op variant :377-447) and the SeedFinder progress/stats machinery
(ref: include/psi/seed_finder.hpp:111-494): per-thread stats, gocc
averages/skips, and a SIGUSR1 live progress dump.
"""

from __future__ import annotations

import signal
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


class Timer:
    """Named cumulative timer with a process-global registry."""

    _timers: Dict[str, "Timer"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._started: Optional[float] = None

    def __enter__(self):
        self._started = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self._started is not None:
            self.total += time.monotonic() - self._started
            self.count += 1
            self._started = None
        return False

    def lap(self) -> float:
        """Duration including an in-flight period (ref lap semantics)."""
        if self._started is not None:
            return self.total + (time.monotonic() - self._started)
        return self.total

    @classmethod
    def get(cls, name: str) -> "Timer":
        with cls._lock:
            if name not in cls._timers:
                cls._timers[name] = Timer(name)
            return cls._timers[name]

    @classmethod
    def get_timers(cls) -> Dict[str, "Timer"]:
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
            t.lap() for n, t in cls._timers.items()
            if n == name or n.startswith(prefix)
        )

    @classmethod
    def reset_all(cls):
        with cls._lock:
            cls._timers.clear()


def timeit(name: str) -> Timer:
    return Timer.get(name)


def timeit_ts(name: str) -> Timer:
    """Thread-scoped timer (name suffixed with thread id, ref:
    seed_finder.hpp:427-456)."""
    return Timer.get(f"{name}-{threading.get_ident()}")


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

    def timeit_ts(self, name: str) -> Timer:
        if not self.enabled:
            return _NOOP_TIMER
        return timeit_ts(name)

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
