"""Milliseconds a chunk the main thread waits for the trie plan (host
clock)."""

from seedbench.metrics import _common


def read(run):
    return _common.mean_ms(run, "prep_wait_s")
