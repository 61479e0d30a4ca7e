"""Milliseconds a chunk of SeedFinder.prepare_onpath on the prepare
thread (host clock)."""

from seedbench.metrics import _common


def read(run):
    return _common.mean_ms(run, "prepare_s")
