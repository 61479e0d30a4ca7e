"""Producer milliseconds a chunk: parse, seeds and k-mer index (host
clock)."""

from seedbench.metrics import _common


def read(run):
    return _common.mean_ms(run, "produce_s")
