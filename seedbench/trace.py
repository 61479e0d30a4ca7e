"""Reduction of a torch.profiler trace (its Chrome-trace export) to the
numbers a traced run reports: the device's busy seconds inside the
window, each device operation's summed seconds, and the idle gaps by
what the main thread was doing.

The harness marks the window and the main thread's legs with
`torch.profiler.record_function` ranges named `seedbench.<leg>`; device
activity is every kernel, copy and fill the profiler recorded.
"""

from __future__ import annotations

import json

WINDOW = "seedbench.window"
LEG_PREFIX = "seedbench."


def short_name(name: str) -> str:
    """A device operation's name without its namespace noise, template
    arguments and parameter list: `at::native::reduce_kernel`,
    `traverse_step_kernel`, `Memcpy HtoD`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip() or name[:64]


def _is_device(cat: str) -> bool:
    cat = cat.lower()
    return cat == "kernel" or cat.startswith("gpu_mem") or cat in (
        "memcpy", "memset")


def reduce(path: str) -> dict:
    """{"busy_s", "window_s", "ops": {name: seconds}, "idle": {leg:
    seconds}} of the window in the Chrome trace at `path`; None when the
    trace has no window mark."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, ops = [], {}
    for e in spans:
        if not _is_device(str(e.get("cat", ""))):
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        n = short_name(e["name"])
        ops[n] = ops.get(n, 0.0) + (b - a) * 1e-6
    dev.sort()
    busy, gaps, end = 0.0, [], w0
    for a, b in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < w1:
        gaps.append((end, w1))
    legs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"][len(LEG_PREFIX):])
                  for e in spans if str(e.get("name", "")).startswith(
                      LEG_PREFIX) and e["name"] != WINDOW)
    idle = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        leg = next((n for s, f, n in legs if s <= mid <= f), "other")
        idle[leg] = idle.get(leg, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "ops": ops, "idle": idle}


def kernel_seconds(reduced: dict, name: str) -> float:
    """Summed device seconds of the operations whose name holds `name`."""
    return sum(s for n, s in reduced["ops"].items() if name in n)


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
