"""traverse_step's share of its roofline over the traced window: the
least time of the window's exact traversals over the kernel's device
time."""

from seedbench.metrics import _common


def read(run):
    return _common.roofline_pct(run, "traverse_step_kernel",
                                _common.traverse_step_work)
