"""Roofline arithmetic of range_refine4, the rank step of the approximate
off-path traversal (seeds matched with up to `mismatches` substitutions).

As in roofline.py, the count is worked out from the benchmark's own
inputs (the graph, the starting loci the traversal is given, the reads'
seed keys, k and the mismatch budget), not from the program's plan, so it
reads the rows the traversal needs whatever cap the program runs the
kernel over. The seeds index the kernel ranks in stays in the 50 MB L2
and is not counted.
"""

from __future__ import annotations

import numpy as np
import torch

#: a live row's (lo, hi) read and its four (lo', hi') written, int32 each
ROW_BYTES = 8.0 + 32.0
#: integer operations a row in csrc/range_refine.cu's range_refine4_kernel:
#: 22 at each end of the range (block and bit index, mask, the four
#: plane masks, four popcounts, four adds), four counts, seven starts and
#: ends, three for the thread's index and bound
ROW_OPS = 58.0


def range_refine4_work(live: list) -> tuple[float, float]:
    """(bytes, operations) of the kernel over the live rows of every
    step."""
    rows = float(sum(live))
    return ROW_BYTES * rows, ROW_OPS * rows


def live_rows(g, loci_chars: np.ndarray, seed_keys: np.ndarray, k: int,
              mismatches: int, device) -> list:
    """Rows the approximate traversal ranks at each step: live[t], for t
    = 0..k-1, is the number of triples (locus, walk of t + 1 characters
    from it, a prefix of t characters of some seed within `mismatches`
    substitutions of the walk's first t characters). `g` is a
    reference.GfaGraph; loci are character indices into it."""
    from seedbench.reference import DeviceGraph

    dg = DeviceGraph(g, device)
    keys = torch.unique(torch.as_tensor(
        np.asarray(seed_keys, dtype=np.int64), device=device))
    chars = torch.arange(4, device=device)
    cur = torch.as_tensor(np.asarray(loci_chars, dtype=np.int64),
                          device=device)
    key = torch.zeros_like(cur)
    cost = torch.zeros_like(cur)
    live = []
    for t in range(k):
        live.append(len(cur))
        if t == k - 1 or not len(cur):
            return live + [0] * (k - 1 - t)
        # the walk's character t against each seed character
        key4 = key[:, None] * 4 + chars
        cost4 = cost[:, None] + (chars != dg.codes[cur][:, None]).long()
        pref = torch.unique(keys >> (2 * (k - t - 1)))
        i = torch.searchsorted(pref, key4).clamp(max=len(pref) - 1)
        row, col = torch.nonzero((pref[i] == key4) & (cost4 <= mismatches),
                                 as_tuple=True)
        cur, key, cost = cur[row], key4[row, col], cost4[row, col]
        rep, cur = dg.advance(cur)
        key, cost = key[rep], cost[rep]
    return live
