"""Run one benchmark cell once and print its result line.

    python3 -m seedbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds BENCHMARK.json, seedbench/ and
psi_tpu_torch/. Needs a CUDA card (as many as the cell asks for) and
exits non-zero without one. The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device and, traced,
breakdown; `checks`, last, holds each number compared with its limit,
which also end standard error.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi gives it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else None


def legs_ms(chunks: list) -> dict:
    """Mean milliseconds a chunk of each leg, for the log."""
    names = ("produce_s", "prepare_s", "prep_wait_s", "query_s")
    return {n[:-2]: round(1e3 * sum(c[n] for c in chunks) / len(chunks), 1)
            for n in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="seedbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from seedbench import harness

    spec = harness.load_spec()
    cell = harness.load_cell(args.workload, args.seed, args.seconds, T_START,
                             spec)
    chips = next(w["chips"] for w in spec["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"seedbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import psi_tpu_torch  # noqa: F401  the program under test

    device = torch.device("cuda", 0)
    traced = bool(args.trace)
    with tempfile.TemporaryDirectory(prefix="seedbench-trace-") as tdir:
        run = cell.entry.run(cell, device, tdir if traced else None)
        t_read = time.monotonic()
        bad = harness.forbidden_modules(sys.modules)
        if bad:
            print(f"seedbench: the run loaded {', '.join(bad)}",
                  file=sys.stderr)
            return 3
        if traced:
            from seedbench import trace

            run.trace = trace.reduce(run.trace_path)
    metrics = {}
    for m in harness.metrics_of(spec, args.workload, traced):
        value = harness.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes),
           "power_limit": power_limit()}
    breakdown = None
    if traced:
        from seedbench import trace

        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        breakdown = {"device_ops": trace.top(run.trace["ops"]),
                     "idle_gaps": trace.top(run.trace["idle"])}
    out = harness.result(run, metrics, dev, breakdown)
    parts = {k: round(v, 1) for k, v in run.setup_parts.items()}
    print(f"seedbench: {args.workload} seed {args.seed}: setup "
          f"{run.setup_s:.1f} s, window {run.window_s:.1f} s, "
          f"{len(run.chunks)} chunks, check {run.check_s:.1f} s, "
          f"set-up parts {json.dumps(parts)}, "
          f"readers {time.monotonic() - t_read:.1f} s, total "
          f"{time.monotonic() - T_START:.1f} s; parts of the checks "
          f"{json.dumps(run.check_parts)}; ms a chunk "
          f"{json.dumps(legs_ms(run.chunks))}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
