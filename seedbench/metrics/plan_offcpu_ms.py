"""Milliseconds a chunk in which the trie plan's host-only parts
(plan-keys, plan-schedule) held no CPU: their wall time less the plan
thread's CPU time, a wait for the interpreter lock or a core."""

from seedbench.metrics import _spans


def read(run):
    return _spans.read_ms(run, "plan-keys", "plan-schedule", off_cpu=True)
