"""Milliseconds a chunk of the off-path hit columns from the surviving
states (the program's span offpath-columns)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "offpath-columns")
