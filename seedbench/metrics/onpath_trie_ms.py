"""Milliseconds a chunk of the on-path trie search and its counts
download (the program's span onpath-trie)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "onpath-trie")
