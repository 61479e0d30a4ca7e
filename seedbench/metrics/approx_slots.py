"""Million rows a chunk that range_refine4 runs over: k x the state cap
of every attempt of the approximate traversal (the program's counter
approx-slots). None where no window chunk counted it."""

from seedbench.metrics import _spans


def read(run):
    got = _spans.store()
    if got is None:
        return None
    chunks = set(_spans.window_chunks(run))
    if not any(name == "approx-slots" and c in chunks for name, c in got[1]):
        return None
    return _spans.read_count(run, "approx-slots", 1e-6)
