"""Milliseconds a chunk of the program's own seeds-on-paths timer."""

from seedbench.metrics import _common


def read(run):
    return _common.mean_ms(run, "onpath_s")
