"""Cap-overflow re-dispatches a chunk of the off-path device traversal
(the program's counter traverse-retries)."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_count(run, "traverse-retries")
