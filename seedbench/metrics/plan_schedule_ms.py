"""Milliseconds a chunk of the trie plan's host schedule build (the
program's span plan-schedule)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "plan-schedule")
