"""Milliseconds a chunk of the trie plan's key pipeline: distinct seed
keys and their inverse map (the program's span plan-keys)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "plan-keys")
