"""Milliseconds a chunk of the on-path query's key pipeline on the
main thread: the distinct seed keys and their seed groups (the
program's span onpath-keys)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "onpath-keys")
