"""Milliseconds a chunk of the trie plan's padding, stacking and upload
to the card, synchronized (the program's span plan-upload)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "plan-upload")
