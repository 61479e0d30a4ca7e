"""Distinct seed k-mers of the chunks completed in the window, over its
seconds. The reference counts each chunk's keys from its reads, so no
change to what the program reports can raise the count."""

from seedbench.metrics import _common


def read(run):
    return _common.rate(run, "ref_keys")
