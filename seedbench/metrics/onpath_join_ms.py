"""Milliseconds a chunk of the on-path seed join and hit rows (the
program's span onpath-join)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "onpath-join")
