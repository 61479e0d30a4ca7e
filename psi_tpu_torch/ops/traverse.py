"""Off-path route: the host WalkTree (counterpart of the jax-free parts
of psi_tpu/ops/traverse.py).

The graph walk from the uncovered starting loci (forks, labels, 'N'
kills) is fixed per index, so it is enumerated once into a WalkTree and
each chunk reduces to `np.searchsorted` prefix probes over the chunk's
sorted seed keys. Same survivors, order and TraverserStats as
psi_tpu's pruned device traversal (ref semantics: traverser_bfs.hpp:
72-164 + traverser_base.hpp:103-268).

One deliberate difference from psi_tpu: `walks_match` probes the upper
end of a prefix range as `klo + (width - 1)` with side="right". At k=32
the first level's `klo + width` wraps past 2^64 for prefixes starting
with T, which made psi_tpu's WalkTree drop states its device traversal
keeps; for k < 32 both forms give the same bound.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from psi_tpu_torch.graph import Graph

#: largest WalkTree (total nodes) built before the route gives up
NODE_CAP = 1 << 23


class WalkTree(NamedTuple):
    """Chunk-independent unpruned state tree from the starting loci."""

    k: int
    n_init: int
    ccount0: np.ndarray        # int64 [n_init] child count of each locus state
    parent: tuple              # per depth: int32 [m_t] -> prev structural slot
    okn: tuple                 # per depth: bool [m_t] ('N'-free children)
    klo: tuple                 # per depth: uint64 [m_t] prefix range start
    ccount: tuple              # per depth: int64 [s_t] over structural survivors
    locus: np.ndarray          # int32 [s_{k-1}] locus of each complete walk
    n_nodes: int               # total tree nodes (diagnostics)


def enumerate_walks(
    graph: Graph,
    start_nodes: np.ndarray,
    start_offs: np.ndarray,
    k: int,
    node_cap: int = NODE_CAP,
) -> WalkTree | None:
    """Host enumeration of the unpruned k-step state tree. Returns None
    when the tree exceeds `node_cap` nodes."""
    from psi_tpu_torch.ops.kmers import ACGT_CODE

    codes = ACGT_CODE[graph.labels].astype(np.int64)
    codes[codes < 0] = 4
    loff = graph.label_offsets.astype(np.int64)
    iptr = graph.out_indptr.astype(np.int64)
    oidx = graph.out_indices.astype(np.int64)

    node = start_nodes.astype(np.int64)
    off = start_offs.astype(np.int64)
    n_init = len(node)
    locus = np.arange(n_init, dtype=np.int32)
    key = np.zeros(n_init, dtype=np.uint64)

    parents, okns, klos, ccounts = [], [], [], []
    ccount0 = None
    total = 0
    for t in range(k):
        nlen = loff[node] - loff[node - 1]
        at_end = off >= nlen
        outdeg = iptr[node] - iptr[node - 1]
        counts = np.where(at_end, outdeg, 1)
        if t == 0:
            ccount0 = counts.astype(np.int64)
        else:
            ccounts.append(counts.astype(np.int64))
        base = np.cumsum(counts) - counts
        m = int(counts.sum())
        total += m
        if total > node_cap:
            return None
        parent = np.repeat(
            np.arange(len(node), dtype=np.int64), counts
        )
        j = np.arange(m, dtype=np.int64) - base[parent]
        p_end = at_end[parent]
        nb = oidx[
            np.clip(iptr[node[parent] - 1] + j, 0, max(len(oidx) - 1, 0))
        ] if len(oidx) else np.zeros(m, dtype=np.int64)
        cnode = np.where(p_end, nb, node[parent])
        coff = np.where(p_end, 0, off[parent])
        c = codes[loff[np.maximum(cnode, 1) - 1] + coff]
        ok = c < 4
        ckey = (key[parent] << np.uint64(2)) | np.where(
            ok, c, 0
        ).astype(np.uint64)
        parents.append(parent.astype(np.int32))
        okns.append(ok)
        klos.append(ckey << np.uint64(2 * (k - t - 1)))
        # structural survivors advance
        node = cnode[ok]
        off = coff[ok] + 1
        locus = locus[parent[ok]]
        key = ckey[ok]
    return WalkTree(
        k=k, n_init=n_init, ccount0=ccount0,
        parent=tuple(parents), okn=tuple(okns), klo=tuple(klos),
        ccount=tuple(ccounts), locus=locus, n_nodes=total,
    )


def walks_match(tree: WalkTree, sorted_keys: np.ndarray):
    """Per-chunk evaluation of a WalkTree against the chunk's sorted
    uint64 seed keys: returns (locus_idx, lo, hi, gd, ended, ended_len),
    the surviving states and TraverserStats of the pruned traversal."""
    k = tree.k
    alive = np.ones(tree.n_init, dtype=bool)
    gd = ended = ended_len = 0
    lo_t = hi_t = None
    for t in range(k):
        ccount_prev = tree.ccount0 if t == 0 else tree.ccount[t - 1]
        attempted = int(ccount_prev[alive].sum())
        klo = tree.klo[t]
        last = (np.uint64(1) << np.uint64(2 * (k - t - 1))) - np.uint64(1)
        lo_t = np.searchsorted(sorted_keys, klo, side="left")
        hi_t = np.searchsorted(sorted_keys, klo + last, side="right")
        alive_child = (
            tree.okn[t] & alive[tree.parent[t]] & (lo_t < hi_t)
        )
        survivors = int(alive_child.sum())
        gd += attempted
        ended += attempted - survivors
        ended_len += (attempted - survivors) * (t + 1)
        alive = alive_child[tree.okn[t]]
    sel = tree.okn[k - 1]
    return (
        tree.locus[alive],
        lo_t[sel][alive].astype(np.int64),
        hi_t[sel][alive].astype(np.int64),
        gd, ended, ended_len,
    )


def traverse_columnar_from_states(index, loci, locus_idx, lo, hi, k):
    """Vectorized hit expansion: (node, off, seed_id, gocc, len) columns."""
    widths = (hi - lo).astype(np.int64)
    total = int(widths.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z
    loci_nodes = np.array([l.node_id() for l in loci], dtype=np.int64)
    loci_offs = np.array([l.offset() for l in loci], dtype=np.int64)
    rep = np.repeat(np.arange(len(lo)), widths)
    within = np.arange(total) - np.repeat(np.cumsum(widths) - widths, widths)
    seed_sel = index.seed_ids[lo.astype(np.int64)[rep] + within]
    nodes = loci_nodes[locus_idx[rep]]
    offs = loci_offs[locus_idx[rep]]
    goccs = widths[rep]
    lens = np.full(total, k, dtype=np.int64)
    return nodes, offs, seed_sel, goccs, lens
