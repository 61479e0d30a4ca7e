"""Roofline arithmetic: the card's peaks and the compulsory bytes and
operations of the two kernels whose shares the benchmark reports.

The counts are worked out from the benchmark's own inputs (the reads'
seed keys, the graph, the starting loci the traversal is given), not from
the program's plan, so they read the same work whatever implements it.
Each input byte is counted once and each output byte once. What a launch
reads from tables that stay in the 50 MB L2 (the rank payload, the graph
and seeds tables) is not counted: the share is a lower bound of the
kernel's, and cannot pass 100% by over-counting. Copied from the
compulsory-byte arithmetic of the program's chip_smoke.py
(`trie_level_work`, `step_work`).
"""

from __future__ import annotations

import numpy as np
import torch

#: NVIDIA H100 SXM, dense published peaks at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
#: the prefix table's depth cap: levels below it are one table gather
FTAB_MAX_DEPTH = 11


def least_seconds(bytes_moved: float, ops: float) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the 32-bit rate, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def prefix_depth(k: int, index_chars: int) -> int:
    """Depth of a 4^p-row prefix table for a text of index_chars: the
    levels of the trie search start below it (p <= log4 n, p <= k)."""
    log4 = max((int(index_chars).bit_length() - 1) // 2, 0)
    return max(min(FTAB_MAX_DEPTH, k, log4), 0)


def distinct_prefixes(keys: np.ndarray, k: int) -> list:
    """Distinct prefixes of each length 0..k of the k-mer keys."""
    keys = np.unique(np.asarray(keys, dtype=np.int64))
    return [len(np.unique(keys >> (2 * (k - d)))) for d in range(k + 1)]


def trie_level_work(keys: np.ndarray, k: int, index_chars: int
                    ) -> tuple[float, float]:
    """(bytes, operations) of the trie search of a chunk's distinct
    search keys, one level per depth below the prefix table: a child's
    parent index and char read (8 B) and its (lo, hi) written (8 B), each
    parent's (lo, hi) read once (8 B); 20 integer operations a child."""
    n = distinct_prefixes(keys, k)
    p = prefix_depth(k, index_chars)
    children = sum(n[d] for d in range(p + 1, k + 1))
    parents = sum(n[d - 1] for d in range(p + 1, k + 1))
    return 16.0 * children + 8.0 * parents, 20.0 * children


def traverse_step_work(live: list) -> tuple[float, float]:
    """(bytes, operations) of the exact traversal's steps, from the live
    states before each step (live[0] the loci): a live parent's five
    int32 fields read and a survivor's written, 20 B each; 60 integer
    operations a survivor."""
    steps = range(len(live) - 1)
    return (sum(20.0 * (live[t] + live[t + 1]) for t in steps),
            sum(60.0 * live[t + 1] for t in steps))


def live_states(g, loci_chars: np.ndarray, seed_keys: np.ndarray, k: int,
                device) -> list:
    """States of the exact off-path traversal: live[t] is the number of
    (locus, walk of t characters from it) pairs that spell a prefix of
    some seed, for t = 0..k. `g` is a reference.GfaGraph."""
    from seedbench.reference import DeviceGraph

    dg = DeviceGraph(g, device)
    keys = torch.unique(torch.as_tensor(
        np.asarray(seed_keys, dtype=np.int64), device=device))
    cur = torch.as_tensor(np.asarray(loci_chars, dtype=np.int64),
                          device=device)
    key = torch.zeros_like(cur)
    live = [len(cur)]
    for d in range(1, k + 1):
        key = key * 4 + dg.codes[cur]
        pref = torch.unique(keys >> (2 * (k - d)))
        i = torch.searchsorted(pref, key).clamp(max=len(pref) - 1)
        keep = pref[i] == key
        cur, key = cur[keep], key[keep]
        live.append(len(cur))
        if d == k or not len(cur):
            return live + [0] * (k - d)
        rep, cur = dg.advance(cur)
        key = key[rep]
    return live
