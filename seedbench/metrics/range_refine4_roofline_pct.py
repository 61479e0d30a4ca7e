"""range_refine4's share of its roofline over the traced window: the
least time of the rows the window's approximate traversals need
(seedbench/roofline_approx.py) over the kernel's device time."""

from seedbench import reference, roofline_approx
from seedbench.metrics import _common


def work(run) -> tuple[float, float]:
    """Summed (bytes, operations) of the window's range_refine4 rows."""
    cfg, tr = run.cell.config, run.cell.traffic
    k = cfg["seed_len"]
    g = run.ref_graph
    loci = g.start[run.loci_chars[:, 0]] + run.loci_chars[:, 1]

    def per_chunk(reads):
        live = roofline_approx.live_rows(
            g, loci, reference.seed_keys(reads, k)[0], k, tr["mismatches"],
            run.device)
        return roofline_approx.range_refine4_work(live)
    w = _common._per_pool(run, "range_refine4", per_chunk)
    return sum(b for b, _ in w), sum(o for _, o in w)


def read(run):
    return _common.roofline_pct(run, "range_refine4_kernel", work)
