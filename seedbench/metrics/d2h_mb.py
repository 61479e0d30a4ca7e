"""Megabytes a chunk copied from the card to the host on the chunk's
path (the program's counter d2h-bytes)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_count(run, "d2h-bytes", 1e-6)
