"""Megabytes a chunk copied from the host to the card on the chunk's
path (the program's counter h2d-bytes)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_count(run, "h2d-bytes", 1e-6)
