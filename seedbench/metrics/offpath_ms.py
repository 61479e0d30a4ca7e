"""Milliseconds a chunk of the program's own seeds-off-path timer."""

from seedbench.metrics import _common


def read(run):
    return _common.mean_ms(run, "offpath_s")
