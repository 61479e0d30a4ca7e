"""Milliseconds a chunk of the producer's seed extraction (the
program's span seeding)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "seeding")
