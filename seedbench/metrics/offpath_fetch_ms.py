"""Milliseconds a chunk of the off-path fetch: the traversal state's
download with its cap retries, or the WalkTree probe (the program's span
offpath-fetch)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "offpath-fetch")
