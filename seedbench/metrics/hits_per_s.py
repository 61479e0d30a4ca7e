"""Distinct hits of the chunks completed in the window, on path and off
path, over its seconds. The reference counts each chunk's hits, the set
the check holds the program to, so duplicate rows raise nothing."""

from seedbench.metrics import _common


def read(run):
    return _common.rate(run, "ref_hits")
