"""Milliseconds a chunk of the on-path occurrence expansion, locate and
global-position download (the program's span onpath-locate)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "onpath-locate")
