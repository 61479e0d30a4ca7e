"""Arithmetic the metric readers share: rates over the window, the
nearest-rank percentile, per-chunk means, and the per-chunk work counts
of the rooflines (cached per pool chunk: a pass repeats its reads)."""

from __future__ import annotations

import math

import torch

from seedbench import reference, roofline


def rate(run, field: str) -> float:
    """All the work of the chunks completed in the window over its
    seconds."""
    return sum(c[field] for c in run.chunks) / run.window_s


def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile (q in (0, 100])."""
    v = sorted(values)
    return float(v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)])


def mean_ms(run, field: str) -> float:
    return 1e3 * sum(c[field] for c in run.chunks) / len(run.chunks)


def _per_pool(run, name, fn):
    cache = run.__dict__.setdefault("_work", {})
    for c in run.chunks:
        if (name, c["pool"]) not in cache:
            cache[(name, c["pool"])] = fn(run.inputs.chunks[c["pool"]])
    return [cache[(name, c["pool"])] for c in run.chunks]


def trie_level_work(run) -> tuple[float, float]:
    """Summed (bytes, operations) of the window's trie searches."""
    cfg, tr = run.cell.config, run.cell.traffic
    k = cfg["seed_len"]

    def work(reads):
        keys = torch.as_tensor(reference.seed_keys(reads, k)[0])
        search, _ = reference.ball(torch.unique(keys), k, tr["mismatches"])
        return roofline.trie_level_work(search.numpy(), k,
                                        cfg["paths"] * cfg["ref_len"])
    w = _per_pool(run, "trie_level", work)
    return sum(b for b, _ in w), sum(o for _, o in w)


def traverse_step_work(run) -> tuple[float, float]:
    """Summed (bytes, operations) of the window's exact traversals from
    the loci the program's traversal is given."""
    cfg = run.cell.config
    k = cfg["seed_len"]
    g = run.ref_graph
    loci = g.start[run.loci_chars[:, 0]] + run.loci_chars[:, 1]

    def work(reads):
        live = roofline.live_states(g, loci, reference.seed_keys(reads, k)[0],
                                    k, run.device)
        return roofline.traverse_step_work(live)
    w = _per_pool(run, "traverse_step", work)
    return sum(b for b, _ in w), sum(o for _, o in w)


def roofline_pct(run, kernel: str, work) -> float | None:
    """100 x the least time of the window's work over the kernel's summed
    device time in the trace; None where the trace holds no such kernel."""
    if run.trace is None:
        return None
    from seedbench import trace

    busy = trace.kernel_seconds(run.trace, kernel)
    if busy <= 0:
        return None
    b, o = work(run)
    return 100.0 * roofline.least_seconds(b, o) / busy

