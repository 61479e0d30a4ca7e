"""What every cell shares: finding a cell's files by name, the run
record the entries return, the metric readers, and the result line.

A cell (a `workloads` entry of BENCHMARK.json) names a configuration,
found as configs/<config>.json, and a traffic mix, found as
traffic/<traffic>.json; the traffic names the entry kind that drives
it, found as entries/<kind>.py. Each metric of BENCHMARK.json is read by
metrics/<name>.py, whose `read(run)` returns a number or None (nothing to
read in this run: the metric is left out of the line).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from dataclasses import dataclass, field

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "psi_tpu")


class CellError(Exception):
    """A cell that cannot be assembled: a missing or malformed file."""


def _json(path: pathlib.Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """One run's cell: its name, configuration and traffic (the JSON
    files), the entry module that drives it, and the run's arguments."""
    name: str
    config: dict
    traffic: dict
    entry: object
    seed: int
    seconds: float
    t_start: float


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json", "benchmark")


def load_cell(name: str, seed: int, seconds: float, t_start: float,
              spec: dict | None = None, base: pathlib.Path = HERE) -> Cell:
    """The cell `name` of the spec, its configuration, traffic and entry
    found by name under `base`; CellError names what is missing."""
    spec = load_spec() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"workload {name!r}: not in BENCHMARK.json")
    w = cells[name]
    config = _json(base / "configs" / f"{w['config']}.json",
                   f"config {w['config']!r}")
    traffic = _json(base / "traffic" / f"{w['traffic']}.json",
                    f"traffic {w['traffic']!r}")
    kind = traffic.get("entry")
    if not kind or not (base / "entries" / f"{kind}.py").is_file():
        raise CellError(f"entry {kind!r} of traffic {w['traffic']!r}: "
                        f"no file entries/{kind}.py")
    entry = importlib.import_module(f"seedbench.entries.{kind}")
    return Cell(name, config, traffic, entry, seed, seconds, t_start)


def metrics_of(spec: dict, cell: str, traced: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end metrics, or
    with a trace its per-layer metrics."""
    ms = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in ms if cell in m.get("workloads", [cell])]


def reader(name: str, base: pathlib.Path = HERE):
    path = base / "metrics" / f"{name}.py"
    if not path.is_file():
        raise CellError(f"metric {name!r}: no file metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"seedbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What an entry hands back: the cell, the device, the set-up and
    window seconds, one record per chunk completed in the window, the
    card's peak, the Chrome trace's path when traced, the checks
    ({name: [value, limit]}) with the number of chunks that failed, and
    the seconds of each part of the set-up, for the log."""
    cell: Cell
    device: object
    setup_s: float
    window_s: float
    chunks: list
    memory_peak_bytes: int
    trace_path: str | None = None
    trace: dict | None = None
    checks: dict = field(default_factory=dict)
    failed: int = 0
    check_parts: dict = field(default_factory=dict)
    check_s: float = 0.0
    inputs: object = None
    ref_graph: object = None
    loci_chars: object = None
    setup_parts: dict = field(default_factory=dict)


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def result(run: Run, metrics: dict, device: dict, breakdown=None) -> dict:
    out = {"correct": run.failed == 0 and all(
               v <= lim for v, lim in run.checks.values()),
           "attempted": len(run.chunks), "failed": run.failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in run.checks.items()}
    return out
