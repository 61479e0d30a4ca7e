"""90th percentile, over the chunks completed in the window, of the
seconds from the producer taking a chunk's reads to its hit columns,
queue waits included."""

from seedbench.metrics import _common


def read(run):
    return _common.percentile(
        [c["t_done"] - c["t_take"] for c in run.chunks], 90)
