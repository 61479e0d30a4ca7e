"""Milliseconds a chunk of the producer's reads-side k-mer index (the
program's span index-reads)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "index-reads")
