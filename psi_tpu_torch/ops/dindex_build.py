"""Distance-index construction on a torch device: interval-semiring path
doubling over the supernode DAG (counterpart of
psi_tpu/ops/dindex_build.py; the host builders are
csrc/host/psi_dindex.cpp and dindex.py's Python mirror).

The host builders walk the DAG in reverse topological order, sequential
in DAG depth. Here the same capped interval sets are computed with no
topological sweep:

    R_1        = direct supernode edges with gap interval [0, 0]
    R_{2k}     = merge(R_k  U  R_k (x) R_k)
    (i: s->m, [a1,b1]) (x) (j: m->t, [a2,b2])
               = (s->t, [a1 + len(m) + a2,  b1 + len(m) + b2])

capped at dmax - 1 (every extension adds positive length, so values over
the cap never become feasible again and clip-and-drop is exact). A pair
with a feasible gap <= cap is joined by at most cap + 1 hops, so
bit_length(cap + 1) rounds reach every row and one more finds the
fixpoint. A round, in torch operators:

  1. the ragged join by run expansion (fm_trie._expand_slots): left
     entry i (s->m) pairs with every row of m;
  2. one sort by (src, dst, lo): one int64 composite key where it fits,
     else three stable passes;
  3. the segmented interval union: a running max of hi with psi_tpu's
     offset trick (dindex._union_row) marks where a new disjoint interval
     starts; scatter_reduce_ takes each run's max hi.

The loop is Python: each round reads the join's size, the union's row
count and the fixpoint on the host.

Departures from psi_tpu:
  * eager torch has exact shapes, so there are no static capacities, no
    overflow retry and no per-component size buckets, nor the variables
    PSI_DINDEX_SFLOOR, PSI_DINDEX_CBATCH and PSI_DINDEX_VMAP (they work
    around the TPU's remote compiler). Components never join, so one
    build over the whole DAG gives the same rows;
  * everything is int64, so psi_tpu's int32 guard has no counterpart;
  * memory: a round's join runs in pieces of at most `join_cap` pairs
    (by default what half the card's free memory holds), each merged into
    the round's result as it comes, which gives the same rows as one
    join. A single entry whose join alone is over the cap raises: nothing
    falls back to the host DP.

The result is the CSR of native.dindex_super_build, byte for byte:
src_indptr [S+1], then dst, iv_lo, iv_hi sorted by (src, dst, lo).
"""

from __future__ import annotations

import numpy as np
import torch

from psi_tpu_torch.device import resolve
from psi_tpu_torch.ops.fm_trie import _expand_slots

#: device bytes a join pair costs at the peak of a round (its int64
#: columns, the union's sort keys and permutation, the merged copies)
PAIR_BYTES = 192
#: join pairs per piece on the CPU
CPU_JOIN_CAP = 1 << 24


def _join_cap(dev: torch.device) -> int:
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return max(free // 2 // PAIR_BYTES, 1)
    return CPU_JOIN_CAP


def _order(src, dst, lo, S: int, cap: int) -> torch.Tensor:
    """Permutation that sorts the rows by (src, dst, lo)."""
    width = cap + 1
    if S * S * width < 1 << 62:
        return torch.sort((src * S + dst) * width + lo).indices
    perm = torch.sort(lo, stable=True).indices
    perm = perm[torch.sort(dst[perm], stable=True).indices]
    return perm[torch.sort(src[perm], stable=True).indices]


def _union(src, dst, lo, hi, S: int, cap: int):
    """Sort by (src, dst, lo) and coalesce the intervals of each (src, dst)
    with integer-set semantics (touching intervals join): the canonical
    rows, int64 each."""
    n = src.shape[0]
    if n == 0:
        return src, dst, lo, hi
    perm = _order(src, dst, lo, S, cap)
    src, dst, lo, hi = src[perm], dst[perm], lo[perm], hi[perm]
    grp = torch.ones(n, dtype=torch.bool, device=src.device)
    grp[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    gid = torch.cumsum(grp, 0) - 1
    big = cap + 2
    run_hi = torch.cummax(hi + gid * big, 0).values - gid * big
    starts = grp.clone()
    starts[1:] |= lo[1:] > run_hi[:-1] + 1
    run = torch.cumsum(starts, 0) - 1
    sidx = torch.nonzero(starts).squeeze(1)
    out_hi = torch.zeros(sidx.shape[0], dtype=torch.int64,
                         device=src.device).scatter_reduce_(
        0, run, hi, reduce="amax")
    return src[sidx], dst[sidx], lo[sidx], out_hi


def _round(rows, sup, S: int, cap: int, join_cap: int, info: dict):
    """One doubling round: merge(R U R (x) R), the join in pieces of at
    most join_cap pairs."""
    src, dst, lo, hi = rows
    counts = torch.bincount(src, minlength=S)
    row_start = torch.cumsum(counts, 0) - counts
    cnt = counts[dst]                 # join width of each left entry
    csum = torch.cumsum(cnt, 0)
    total = int(csum[-1])
    info["join_pairs"] += total
    out = rows
    e0, base = 0, 0
    while base < total:
        # the longest run of left entries from e0 whose pairs fit the cap
        e1 = int(torch.searchsorted(csum, base + join_cap, right=True))
        if e1 == e0:
            raise RuntimeError(
                f"distance-index device build: entry {e0} joins "
                f"{int(cnt[e0])} rows at once, over the join cap of "
                f"{join_cap} pairs (what half the device's free memory "
                f"holds at {PAIR_BYTES} bytes a pair)"
            )
        end = int(csum[e1 - 1])
        w = cnt[e0:e1]
        slot = _expand_slots(csum[e0:e1] - base, w, end - base) + e0
        within = (torch.arange(base, end, dtype=torch.int64,
                               device=src.device) - (csum[slot] - cnt[slot]))
        m = dst[slot]
        j = row_start[m] + within
        shift = sup[m]
        p_lo = lo[slot] + shift + lo[j]
        keep = p_lo <= cap
        p_hi = torch.clamp(hi[slot] + shift + hi[j], max=cap)
        cat = [torch.cat([a, b[keep]]) for a, b in zip(
            out, (src[slot], dst[j], p_lo, p_hi))]
        out = _union(*cat, S, cap)
        info["pieces"] += 1
        e0, base = e1, end
    return out


def build_super_device(
    sup_len: np.ndarray,
    s_indptr: np.ndarray,
    s_indices: np.ndarray,
    dmax: int,
    device: torch.device | str | None = None,
    join_cap: int | None = None,
    info: dict | None = None,
):
    """Path-doubling build over the supernode DAG on `device` (the card
    when None). Returns (src_indptr, dst, iv_lo, iv_hi) int64 NumPy
    arrays identical to native.dindex_super_build. The caller guarantees
    a DAG (cyclic graphs take the BFS fallback upstream). `join_cap`
    bounds the join pairs held at once; `info`, where given, receives the
    rounds, the join pairs over all rounds and the pieces they ran in."""
    dev = resolve("cuda") if device is None else torch.device(device)
    info = {} if info is None else info
    info.update(rounds=0, join_pairs=0, pieces=0)
    S = int(len(sup_len))
    s_indptr = np.asarray(s_indptr, dtype=np.int64)
    if S == 0 or len(s_indices) == 0:
        return (np.zeros(S + 1, dtype=np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    cap = int(dmax) - 1
    if join_cap is None:
        join_cap = _join_cap(dev)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64)
                               ).to(dev)

    sup = up(sup_len)
    src = up(np.repeat(np.arange(S, dtype=np.int64), np.diff(s_indptr)))
    zero = torch.zeros_like(src)
    rows = _union(src, up(s_indices), zero, zero, S, cap)
    for _ in range(int(cap + 1).bit_length() + 1):
        new = _round(rows, sup, S, cap, join_cap, info)
        info["rounds"] += 1
        same = new[0].shape == rows[0].shape and all(
            torch.equal(a, b) for a, b in zip(new, rows))
        rows = new
        if same:
            break
    src, dst, lo, hi = (t.cpu().numpy() for t in rows)
    indptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=S), out=indptr[1:])
    return indptr, dst, lo, hi
