"""trie_level's share of its roofline over the traced window: the
least time of the window's trie searches over the kernel's device time."""

from seedbench.metrics import _common


def read(run):
    return _common.roofline_pct(run, "trie_level_kernel",
                                _common.trie_level_work)
