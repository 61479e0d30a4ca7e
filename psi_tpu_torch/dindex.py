"""Distance index: base-pair-resolution reachability within [dmin, dmax]
(counterpart of psi_tpu/dindex.py; the host half is psi_tpu's, copied).

Re-design of the DiVerG distance index (usage per ref:
include/psi/seed_finder.hpp:1193-1317; dindexctl tool semantics): the
reference materialises a boolean CSR matrix over *char-order* coordinates
(range-compressed rows) by boolean matrix powering.

Two-level compressed form used here (round 2: scales to insert-size
horizons dmax ~ 10^3..10^4, the reference's heaviest build step):

1. **Supernode contraction.** Maximal unary chains (interior nodes with
   outdeg == 1 into indeg == 1) collapse into supernodes; within a
   supernode reachability is pure arithmetic over bp offsets, so the
   index never stores chain-internal pairs — the count of stored pairs
   scales with the number of BRANCH regions in the horizon, not with
   horizon / node length.

2. **Reverse-topological interval DP.** Over the supernode DAG,
   reach(s, t) = the set of feasible *between-supernode* gap lengths
   L = sum(LEN(w) for supernodes w strictly between s and t on a walk),
   kept as sorted disjoint intervals capped at dmax - 1 and computed in
   one reverse-topological pass:

       reach(s) = U over edges s->t of ({(t, [0,0])}
                                        U shift(reach(t), LEN(t)))

   — each supernode's row is built once from its children's final rows
   (no frontier re-expansion, the cost that capped the round-1 builder
   at dmax ~ 400).

A locus pair (v, o) -> (u, p) then verifies as (ref probe semantics
seed_finder.hpp:1300-1317):

  * same supernode: d = (head(u) + p) - (head(v) + o); dmin <= d <= dmax
    (covers the reference's same-node arithmetic as the special case
    head(u) == head(v));
  * else: exists L in reach(sup(v), sup(u)):
        dmin <= a + 1 + tail(v) + head(u) + L <= dmax,
    with a = (len(v) - 1 - o) + p — which reproduces the reference's
    boolean probe distance_mat(charorder(v)+o, charorder(u)+p) exactly.

Queries are batched (one searchsorted over sorted super-pair keys +
masked interval probes). Cyclic inputs (the reference requires
topologically-ordered graphs, psikt.cpp:252-255) fall back to the
round-1 per-source interval BFS over NODE pairs (mode == "node").

The device half is this package's (ops/dindex_probe.py, the probe, and
ops/dindex_build.py, the opt-in build):

  * `verify_batch_device` probes on a torch device, the card unless the
    caller names another. The probe tables are uploaded once per index
    and device; the composite keys stay whole int64 (torch has int64 on
    the card, where psi_tpu splits them into 31-bit halves). On the card
    the default variant (`bisect`) is the hand-written kernel
    csrc/dindex_probe.cu; PSI_DINDEX_PROBE=sort picks the sort-merge
    form. psi_tpu's default is `sort`, chosen because gathers serialize
    on a TPU; the answers are identical.
  * PSI_DINDEX_BUILD=device builds the super-mode rows by path doubling
    on the device given to `build` (the card by default). It raises
    where it cannot build; it never falls back to the native DP. Cyclic
    inputs take the node-mode BFS on the host, as in psi_tpu, whatever
    the variable says: neither package has a device build for them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from psi_tpu_torch.device import resolve
from psi_tpu_torch.graph import Graph


def _merge_intervals(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    if not ivs:
        return []
    ivs = sorted(ivs)
    out = [ivs[0]]
    for a, b in ivs[1:]:
        if a <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _union_row(d: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Per-destination interval union of one row, vectorized: lexsort by
    (dst, lo), then a segmented running-max of hi (offset trick) finds
    where a new disjoint output interval starts. Touching intervals
    (lo == prev hi + 1) merge, matching _merge_intervals."""
    if len(d) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    order = np.lexsort((a, d))
    d, a, b = d[order], a[order], b[order]
    grp = np.empty(len(d), dtype=bool)
    grp[0] = True
    grp[1:] = d[1:] != d[:-1]
    gid = np.cumsum(grp) - 1
    big = np.int64(max(int(b.max()), 0) + 2)
    run_hi = np.maximum.accumulate(b + gid * big) - gid * big
    starts = grp.copy()
    starts[1:] |= a[1:] > run_hi[:-1] + 1
    sidx = np.nonzero(starts)[0]
    ends = np.concatenate([sidx[1:] - 1, [len(d) - 1]])
    return d[sidx], a[sidx], run_hi[ends]


def contract_chains(node_len, out_indptr, out_indices):
    """Collapse maximal unary chains into supernodes.

    Returns (sup [n+1] 1-based supernode id per node, head [n+1] bp
    before the node inside its supernode, tail [n+1] bp after,
    sup_len [S] total bp, sup_indptr/sup_indices CSR of the supernode
    graph (deduplicated, 0-based supernode ids)).

    Fully vectorized (pointer doubling over the chain-predecessor map:
    O(n log n) NumPy, no per-node Python) — at pan-genome node counts
    the contraction otherwise dominates the native DP it feeds. Nodes
    on pure chain CYCLES (no head to anchor them) get sup == 0, which
    the caller detects and routes to the BFS fallback.
    """
    n = len(node_len)
    node_len = np.asarray(node_len, dtype=np.int64)
    outdeg = np.diff(out_indptr)
    indeg = np.bincount(out_indices, minlength=n + 1)[1:] if len(
        out_indices
    ) else np.zeros(n, dtype=np.int64)
    # chain successor: v -> w iff outdeg(v) == 1 and indeg(w) == 1
    nxt = np.zeros(n + 1, dtype=np.int64)
    single = np.nonzero(outdeg == 1)[0]  # 0-based node ranks
    if len(single):
        tgt = out_indices[out_indptr[single]]
        keep = indeg[tgt - 1] == 1
        nxt[single[keep] + 1] = tgt[keep]
    is_head = np.ones(n + 1, dtype=bool)
    is_head[nxt[nxt > 0]] = False
    is_head[0] = False

    # chain predecessor: par[w] = v iff nxt[v] == w (unique by indeg==1)
    vs = np.nonzero(nxt)[0]
    par = np.zeros(n + 1, dtype=np.int64)
    par[nxt[vs]] = vs
    # pointer doubling: g -> chain head (fixpoint), d -> bp before node
    g = np.where(par > 0, par, np.arange(n + 1, dtype=np.int64))
    d = np.where(par > 0, node_len[par - 1], 0)
    for _ in range(max(int(n).bit_length(), 1) + 1):
        gg = g[g]
        if (gg == g).all():
            break
        d = d + d[g]
        g = gg
    sup = np.zeros(n + 1, dtype=np.int64)
    heads = np.nonzero(is_head)[0]
    head_rank = np.zeros(n + 1, dtype=np.int64)
    head_rank[heads] = np.arange(1, len(heads) + 1)
    anchored = is_head[g]
    anchored[0] = False
    sup[anchored] = head_rank[g[anchored]]
    head = np.where(anchored, d, 0)
    S = len(heads)
    sup_len = np.zeros(S, dtype=np.int64)
    mem = np.nonzero(sup)[0]
    np.add.at(sup_len, sup[mem] - 1, node_len[mem - 1])
    tail = np.zeros(n + 1, dtype=np.int64)
    tail[mem] = sup_len[sup[mem] - 1] - head[mem] - node_len[mem - 1]

    # supernode graph: the non-chain out-edges of each chain's tail node
    src_node = np.repeat(np.arange(1, n + 1, dtype=np.int64), outdeg)
    em = nxt[src_node] == 0  # interior chain edges are contracted away
    sup_indptr = np.zeros(S + 1, dtype=np.int64)
    if em.any():
        earr = np.unique(
            np.stack(
                [sup[src_node[em]] - 1, sup[out_indices[em]] - 1], axis=1
            ),
            axis=0,
        )
        np.add.at(sup_indptr, earr[:, 0] + 1, 1)
        np.cumsum(sup_indptr, out=sup_indptr)
        sup_indices = earr[:, 1].copy()
    else:
        sup_indices = np.zeros(0, dtype=np.int64)
    return sup, head, tail, sup_len, sup_indptr, sup_indices


def _topo_order(S, indptr, indices):
    """Kahn topological order of the supernode DAG; None when cyclic."""
    indeg = np.bincount(indices, minlength=S) if len(indices) else np.zeros(
        S, dtype=np.int64
    )
    indeg = indeg.astype(np.int64)
    stack = list(np.nonzero(indeg == 0)[0])
    order = []
    while stack:
        s = stack.pop()
        order.append(s)
        for e in range(indptr[s], indptr[s + 1]):
            t = indices[e]
            indeg[t] -= 1
            if indeg[t] == 0:
                stack.append(int(t))
    if len(order) != S:
        return None
    return order


class DistanceIndex:
    """Interval-compressed pairwise distance sets with batched probes."""

    def __init__(self, dmin: int, dmax: int):
        self.dmin = dmin
        self.dmax = dmax
        self.mode = "super"  # or "node" (cyclic-graph fallback)
        # super mode: node -> supernode maps + super-pair interval CSR
        self.sup = np.zeros(1, dtype=np.int64)
        self.head = np.zeros(1, dtype=np.int64)
        self.tail = np.zeros(1, dtype=np.int64)
        # CSR rows (per supernode in super mode; per node in node mode)
        self.src_indptr: np.ndarray = np.zeros(1, dtype=np.int64)
        self.dst: np.ndarray = np.zeros(0, dtype=np.int64)
        self.iv_lo: np.ndarray = np.zeros(0, dtype=np.int64)
        self.iv_hi: np.ndarray = np.zeros(0, dtype=np.int64)
        self.n_nodes = 0

    @property
    def empty(self) -> bool:
        return self.n_nodes == 0

    # --- construction -------------------------------------------------------
    @staticmethod
    def build(
        graph: Graph, dmin: int, dmax: int, per_component: bool = True,
        device: torch.device | str | None = None,
    ) -> "DistanceIndex":
        """Supernode-DAG reverse-topological DP (native builder when
        available); falls back to the per-source interval BFS over node
        pairs for cyclic inputs (the reference requires topological
        order, ref: psikt.cpp:252-255). Under PSI_DINDEX_BUILD=device the
        super-mode rows are built on `device` (the card when None)."""
        idx = DistanceIndex(dmin, dmax)
        if dmin == 0 or (dmax != 0 and dmax < dmin):
            return idx  # not constructible (ref: seed_finder.hpp:1198)
        if dmax == 0:
            dmax = dmin
        idx.dmax = dmax
        n = graph.node_count
        idx.n_nodes = n
        node_len = np.diff(graph.label_offsets)

        sup, head, tail, sup_len, s_indptr, s_indices = contract_chains(
            node_len, graph.out_indptr, graph.out_indices
        )
        S = len(sup_len)
        order = _topo_order(S, s_indptr, s_indices)
        if order is None or (n and (sup[1:] == 0).any()):
            # cyclic supernode DAG, or a pure chain cycle (no head node
            # to anchor contraction): round-1 BFS fallback
            return DistanceIndex._build_bfs(idx, graph, dmax, per_component)
        idx.sup, idx.head, idx.tail = sup, head, tail

        if os.environ.get("PSI_DINDEX_BUILD", "") == "device":
            # path-doubling build on the device (ops/dindex_build.py):
            # identical rows to the native reverse-topo DP, no
            # sequential sweep; it raises where it cannot build
            from psi_tpu_torch.ops import dindex_build

            idx.src_indptr, idx.dst, idx.iv_lo, idx.iv_hi = (
                dindex_build.build_super_device(
                    sup_len, s_indptr, s_indices, dmax, device=device
                )
            )
            return idx

        from psi_tpu_torch import native

        res = native.dindex_super_build(
            sup_len, s_indptr, s_indices, dmax
        )
        if res is not None:
            idx.src_indptr, idx.dst, idx.iv_lo, idx.iv_hi = res
            return idx

        # Python mirror of the reverse-topological DP. Rows are kept as
        # COMPACT NumPy triples from the moment they are built (24 B per
        # interval instead of ~100 B of tuple objects — the former
        # all-tuples form held every supernode's row as Python objects
        # simultaneously and was unusable at pan-genome scale), and each
        # row's union/merge is one vectorized lexsort pass. Peak memory
        # = the final CSR (which is the output, irreducible) + one row's
        # transient concat buffers; rows are the output, so no separate
        # retirement copy exists.
        cap = dmax - 1  # D0 = 1 + tail + L + head >= 1 + L
        rows: List[Tuple[np.ndarray, np.ndarray, np.ndarray] | None]
        rows = [None] * S
        for s in reversed(order):
            e0, e1 = int(s_indptr[s]), int(s_indptr[s + 1])
            if e0 == e1:
                continue
            kids = s_indices[e0:e1].astype(np.int64)
            parts_d = [kids]
            parts_a = [np.zeros(len(kids), dtype=np.int64)]
            parts_b = [np.zeros(len(kids), dtype=np.int64)]
            for t in kids:
                rt = rows[int(t)]
                if rt is None or len(rt[0]) == 0:
                    continue
                shift = int(sup_len[int(t)])
                na = rt[1] + shift
                keep = na <= cap
                parts_d.append(rt[0][keep])
                parts_a.append(na[keep])
                parts_b.append(np.minimum(rt[2][keep] + shift, cap))
            rows[s] = _union_row(
                np.concatenate(parts_d),
                np.concatenate(parts_a),
                np.concatenate(parts_b),
            )
        counts = np.asarray(
            [0 if r is None else len(r[0]) for r in rows], dtype=np.int64
        )
        idx.src_indptr = np.concatenate(
            [[0], np.cumsum(counts)]
        ).astype(np.int64)
        live = [r for r in rows if r is not None and len(r[0])]
        if live:
            idx.dst = np.concatenate([r[0] for r in live])
            idx.iv_lo = np.concatenate([r[1] for r in live])
            idx.iv_hi = np.concatenate([r[2] for r in live])
        return idx

    @staticmethod
    def _build_bfs(
        idx: "DistanceIndex", graph: Graph, dmax: int, per_component: bool
    ) -> "DistanceIndex":
        """Round-1 fallback: per-source interval BFS over NODE pairs
        (handles cyclic inputs; native OpenMP builder when available).

        Cost model (this is the CYCLIC-input path; the reference outright
        rejects non-topologically-ordered graphs, ref: psikt.cpp:252-255,
        so any cyclic support is beyond-parity): per source the frontier
        re-expands until the per-target interval sets reach fixpoint —
        intervals are monotone and capped at dmax, so each (source,
        target) pair grows at most O(dmax / mean_node_len) times, giving
        O(n_nodes * reachable_within_dmax * rounds) total. Usable for
        small graphs / moderate dmax only; measured numbers in
        docs/BENCH_NOTES.md ("dindex cyclic fallback")."""
        idx.mode = "node"

        from psi_tpu_torch import native

        node_len_arr = np.diff(graph.label_offsets)
        res = native.dindex_build(
            node_len_arr, graph.out_indptr, graph.out_indices, dmax
        )
        if res is not None:
            idx.src_indptr, idx.dst, idx.iv_lo, idx.iv_hi = res
            return idx
        return DistanceIndex._build_py(idx, graph, dmax, per_component)

    @staticmethod
    def _build_py(
        idx: "DistanceIndex", graph: Graph, dmax: int, per_component: bool
    ) -> "DistanceIndex":
        n = graph.node_count
        ranges = (
            graph.component_ranges() if per_component and graph.get_path_count()
            else [(1, n + 1)]
        )
        node_len = np.diff(graph.label_offsets)

        rows: Dict[int, Dict[int, List[Tuple[int, int]]]] = {}
        for lo_r, hi_r in ranges:
            for v in range(lo_r, hi_r):
                # BFS from v accumulating feasible-D0 intervals per target
                dist: Dict[int, List[Tuple[int, int]]] = {}
                # frontier: (node u, interval of D0 values reaching u's start)
                frontier: List[Tuple[int, Tuple[int, int]]] = [
                    (int(u), (1, 1)) for u in graph.out_neighbors(v)
                ]
                while frontier:
                    nxt: Dict[int, List[Tuple[int, int]]] = {}
                    for u, (a, b) in frontier:
                        if a > dmax:
                            continue
                        b = min(b, dmax)
                        cur = dist.setdefault(u, [])
                        merged = _merge_intervals(cur + [(a, b)])
                        if merged == cur:
                            continue  # no growth -> don't re-expand
                        dist[u] = merged
                        ulen = int(node_len[u - 1])
                        for w in graph.out_neighbors(u):
                            na, nb = a + ulen, b + ulen
                            if na <= dmax:
                                nxt.setdefault(int(w), []).append((na, nb))
                    frontier = [
                        (u, iv) for u, ivs in nxt.items()
                        for iv in _merge_intervals(ivs)
                    ]
                if dist:
                    rows[v] = dist

        # finalize to CSR arrays
        indptr = [0]
        dst, lo_l, hi_l = [], [], []
        for v in range(1, n + 1):
            for u in sorted(rows.get(v, {})):
                for a, b in rows[v][u]:
                    dst.append(u)
                    lo_l.append(a)
                    hi_l.append(b)
            indptr.append(len(dst))
        idx.src_indptr = np.asarray(indptr, dtype=np.int64)
        idx.dst = np.asarray(dst, dtype=np.int64)
        idx.iv_lo = np.asarray(lo_l, dtype=np.int64)
        idx.iv_hi = np.asarray(hi_l, dtype=np.int64)
        return idx

    # --- queries ------------------------------------------------------------
    def verify(self, graph: Graph, v: int, o: int, u: int, p: int) -> bool:
        """Single-pair verification (ref: seed_finder.hpp:1300-1317)."""
        if self.mode == "node" or (self.empty and v == u):
            return self._verify_node(graph, v, o, u, p)
        if self.empty:
            return False
        if self.sup[v] == self.sup[u]:
            d = (self.head[u] + p) - (self.head[v] + o)
            return self.dmin <= d <= self.dmax
        a = (graph.node_length(v) - 1 - o) + p
        base = 1 + int(self.tail[v]) + int(self.head[u])
        l_lo, l_hi = self.dmin - a - base, self.dmax - a - base
        if l_hi < 0:
            return False
        sv, su = int(self.sup[v]) - 1, int(self.sup[u]) - 1
        return bool(self._probe_pairs(
            np.asarray([sv]), np.asarray([su]),
            np.asarray([l_lo]), np.asarray([l_hi]),
            np.asarray([True]),
        )[0])

    def _verify_node(self, graph: Graph, v, o, u, p) -> bool:
        """node-pair (cyclic fallback) probe — round-1 semantics."""
        if v == u:  # intra-node arithmetic
            if o > p:
                return False
            return self.dmin <= (p - o) <= self.dmax
        if self.empty:
            return False
        a = (graph.node_length(v) - 1 - o) + p
        s_lo, s_hi = self.dmin - a, self.dmax - a
        if s_hi < 1:
            return False
        return bool(self._probe_pairs(
            np.asarray([v - 1]), np.asarray([u]),
            np.asarray([s_lo]), np.asarray([s_hi]),
            np.asarray([True]),
        )[0])

    def _pair_keys(self) -> np.ndarray:
        """Globally sorted composite (source, dst, iv_lo) row keys:
        sources are grouped ascending by construction, dst is sorted
        within each source segment and intervals are sorted disjoint
        within each (src, dst) pair, so
        (src*(R+2) + dst)*(dmax+2) + iv_lo is globally sorted — one
        searchsorted localizes any probe EXACTLY (see verify_batch)."""
        if getattr(self, "_pk", None) is None or len(self._pk) != len(self.dst):
            nrows = len(self.src_indptr) - 1
            src = np.repeat(
                np.arange(nrows, dtype=np.int64),
                np.diff(self.src_indptr),
            )
            self._pk_ivbase = np.int64(self.dmax + 2)
            self._pk_base = np.int64(nrows + 2) * self._pk_ivbase
            self._pk = (
                (src * np.int64(nrows + 2) + self.dst) * self._pk_ivbase
                + self.iv_lo
            )
        return self._pk

    def _probe_pairs(self, q_src, q_dst, s_lo, s_hi, ok_q) -> np.ndarray:
        """Exact one-searchsorted interval probe. Within a (src, dst)
        pair the intervals are sorted and DISJOINT, so both iv_lo and
        iv_hi ascend; an interval intersecting [s_lo, s_hi] exists iff
        the LAST interval with iv_lo <= s_hi has iv_hi >= s_lo. That
        row is located by one searchsorted over the composite keys —
        O(1) probes per query regardless of interval multiplicity
        (replaces the old _pk_maxmult masked-pass loop, which was O(N)
        per batch element on pathological rows)."""
        pk = self._pair_keys()
        if len(pk) == 0:
            return np.zeros(len(q_src), dtype=bool)
        nrows = len(self.src_indptr) - 1
        pair = q_src * np.int64(nrows + 2) + q_dst
        s_hi_c = np.minimum(s_hi, np.int64(self._pk_ivbase - 1))
        qkey = pair * self._pk_ivbase + np.maximum(s_hi_c, 0)
        r = np.searchsorted(pk, qkey, side="right") - 1
        rc = np.maximum(r, 0)
        # row must exist, belong to the queried pair, and intersect
        pair_of_r = pk[rc] // self._pk_ivbase
        return (
            ok_q & (r >= 0) & (pair_of_r == pair)
            & (self.iv_hi[rc] >= s_lo) & (self.iv_lo[rc] <= s_hi)
        )

    # --- device probe (SURVEY §2.2: DiVerG's accelerator offload) ---------
    def _device_tables(self, device: torch.device):
        """Probe tables on `device`, uploaded once per index and device
        (and again only if the rows change): the composite sorted keys
        whole as int64, the per-row (src, dst, iv_lo, iv_hi) as one int32
        record a row for the pair and intersect checks, and the key
        directory built from the keys on the device
        (ops/dindex_probe.make_tables)."""
        from psi_tpu_torch.ops.dindex_probe import make_tables

        cache = getattr(self, "_dev", None)
        if cache is None or cache[0] != len(self.dst):
            cache = self._dev = (len(self.dst), {})
        key = (device.type, device.index)
        if key not in cache[1]:
            pk = self._pair_keys()
            nrows = len(self.src_indptr) - 1
            src = np.repeat(
                np.arange(nrows, dtype=np.int64),
                np.diff(self.src_indptr),
            )
            cols = {"src": src, "dst": self.dst, "iv_lo": self.iv_lo,
                    "iv_hi": self.iv_hi}
            i32 = np.iinfo(np.int32)
            for name, a in cols.items():
                if len(a) and (a.min() < i32.min or a.max() > i32.max):
                    raise ValueError(
                        f"distance index column {name} does not fit int32 "
                        f"(range [{a.min()}, {a.max()}]): the device probe "
                        f"cannot hold it"
                    )
            cache[1][key] = make_tables(
                torch.as_tensor(np.ascontiguousarray(pk, dtype=np.int64)
                                ).to(device),
                *(torch.as_tensor(np.asarray(a, dtype=np.int32))
                  for a in cols.values()),
            )
        return cache[1][key]

    def _probe_pairs_device(self, q_src, q_dst, s_lo, s_hi, ok_q,
                            device: torch.device,
                            variant: str | None = None) -> np.ndarray:
        """Exact interval probe on `device` (the query side of DiVerG's
        accelerator offload, ref: seed_finder.hpp:783-790 Kokkos exec
        space; SURVEY §2.2). The composite query keys are formed on the
        host in int64, as `_probe_pairs` forms them, then:

          * "bisect" (default): ops/dindex_probe.probe_bisect, on the
            card the kernel csrc/dindex_probe.cu, one thread per query
            through the key directory;
          * "sort": ops/dindex_probe.probe_sort, one stable sort of rows
            ++ queries, a cumsum and a scatter-max (psi_tpu's default).

        PSI_DINDEX_PROBE picks when `variant` is None. s_lo and s_hi
        travel as int32, clipped as psi_tpu clips them.
        """
        from psi_tpu_torch.ops import dindex_probe

        if variant is None:
            variant = os.environ.get("PSI_DINDEX_PROBE", "bisect")
        if variant not in ("bisect", "sort"):
            raise ValueError(
                f"PSI_DINDEX_PROBE={variant!r}: expected bisect or sort"
            )
        pk = self._pair_keys()
        if len(pk) == 0:
            return np.zeros(len(q_src), dtype=bool)
        tabs = self._device_tables(device)
        # nrows+2 must match _pair_keys' composite base exactly
        nrows = len(self.src_indptr) - 1
        s_hi_c = np.minimum(s_hi, np.int64(self._pk_ivbase - 1))
        qkey = (
            (q_src * np.int64(nrows + 2) + q_dst) * self._pk_ivbase
            + np.maximum(s_hi_c, 0)
        )
        i32 = np.iinfo(np.int32)
        cols = [np.asarray(qkey, dtype=np.int64)] + [
            np.clip(a, i32.min, i32.max).astype(np.int32)
            for a in (q_src, q_dst, s_lo, s_hi)
        ]
        fn = (dindex_probe.probe_sort if variant == "sort"
              else dindex_probe.probe_bisect)
        hit = fn(tabs, *(torch.as_tensor(c).to(device) for c in cols))
        return hit.cpu().numpy() & ok_q

    def verify_batch_device(
        self, graph: Graph, v: np.ndarray, o: np.ndarray,
        u: np.ndarray, p: np.ndarray,
        device: torch.device | str | None = None,
    ) -> np.ndarray:
        """verify_batch with the probe on a torch device, the card unless
        `device` names another (same semantics, same truth tables; alice
        dstats routes through this)."""
        dev = resolve("cuda") if device is None else torch.device(device)
        return self._verify_batch_impl(graph, v, o, u, p, device=dev)

    def verify_batch(
        self, graph: Graph, v: np.ndarray, o: np.ndarray,
        u: np.ndarray, p: np.ndarray,
    ) -> np.ndarray:
        """Vectorized pair verification for large batches (alice-dstats
        style pair checking, ref: tools/src/alice.cpp:599-737): one
        searchsorted over composite sorted keys — no per-row Python and
        no dependence on interval multiplicity."""
        return self._verify_batch_impl(graph, v, o, u, p, device=None)

    def _verify_batch_impl(
        self, graph: Graph, v, o, u, p, device: torch.device | None,
    ) -> np.ndarray:
        v = np.asarray(v, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        u = np.asarray(u, dtype=np.int64)
        p = np.asarray(p, dtype=np.int64)
        out = np.zeros(len(v), dtype=bool)
        node_len = np.diff(graph.label_offsets)

        if self.mode == "node" or self.empty:
            same = v == u
            d = p - o
            out[same] = (
                (o[same] <= p[same])
                & (self.dmin <= d[same]) & (d[same] <= self.dmax)
            )
            if self.empty:
                return out
            rest = np.nonzero(~same)[0]
            a = (node_len[v[rest] - 1] - 1 - o[rest]) + p[rest]
            s_lo = self.dmin - a
            s_hi = self.dmax - a
            q_src = v[rest] - 1
            q_dst = u[rest]
            ok_q = s_hi >= 1
        else:
            same = self.sup[v] == self.sup[u]
            d = (self.head[u[same]] + p[same]) - (self.head[v[same]] + o[same])
            out[same] = (self.dmin <= d) & (d <= self.dmax)
            rest = np.nonzero(~same)[0]
            if len(rest) == 0:
                return out
            a = (node_len[v[rest] - 1] - 1 - o[rest]) + p[rest]
            base = 1 + self.tail[v[rest]] + self.head[u[rest]]
            s_lo = self.dmin - a - base
            s_hi = self.dmax - a - base
            q_src = self.sup[v[rest]] - 1
            q_dst = self.sup[u[rest]] - 1
            ok_q = s_hi >= 0

        if len(rest) == 0:
            return out
        if device is None:
            out[rest] = self._probe_pairs(q_src, q_dst, s_lo, s_hi, ok_q)
        else:
            out[rest] = self._probe_pairs_device(
                q_src, q_dst, s_lo, s_hi, ok_q, device
            )
        return out

    # --- serialization ------------------------------------------------------
    @staticmethod
    def _narrow(a: np.ndarray) -> np.ndarray:
        """int32 on-disk form when the values fit (halves the artifact
        and the loaded index at pan-genome scale; arithmetic in the
        probes promotes back to int64)."""
        if a.size and a.dtype == np.int64 and (
            a.min() >= np.iinfo(np.int32).min
            and a.max() <= np.iinfo(np.int32).max
        ):
            return a.astype(np.int32)
        return a

    #: columns spilled to raw .npy side files above this size (bytes):
    #: savez_compressed cannot stream multi-GB columns and the loaded
    #: index must memmap at pan-genome scale (3 Gbp feasibility,
    #: docs/BENCH_NOTES.md)
    BIG_COL_BYTES = int(os.environ.get("PSI_DINDEX_MMAP_BYTES", 1 << 30))

    def save(self, path: str) -> None:
        """Artifact: one .npz of narrowed columns; columns larger than
        BIG_COL_BYTES go to raw `<path>.<col>.npy` side files (int32
        where values fit) that `load` memory-maps instead of reading."""
        cols = {
            "sup": self._narrow(self.sup),
            "head": self._narrow(self.head),
            "tail": self._narrow(self.tail),
            "src_indptr": self.src_indptr,
            "dst": self._narrow(self.dst),
            "iv_lo": self._narrow(self.iv_lo),
            "iv_hi": self._narrow(self.iv_hi),
        }
        base = path[:-4] if path.endswith(".npz") else path
        inline = {}
        big = []
        for name, a in cols.items():
            if a.nbytes > self.BIG_COL_BYTES:
                np.save(f"{base}.{name}.npy", a)
                big.append(name)
            else:
                inline[name] = a
        np.savez_compressed(
            path,
            dmin=np.int64(self.dmin),
            dmax=np.int64(self.dmax),
            n_nodes=np.int64(self.n_nodes),
            mode=np.str_(self.mode),
            big_cols=np.asarray(big, dtype=np.str_),
            **inline,
        )

    @staticmethod
    def load(path: str, mmap: bool = True) -> "DistanceIndex":
        z = np.load(path)
        idx = DistanceIndex(int(z["dmin"]), int(z["dmax"]))
        idx.n_nodes = int(z["n_nodes"])
        idx.mode = str(z["mode"]) if "mode" in z else "node"
        big = set(
            str(s) for s in z["big_cols"]
        ) if "big_cols" in z else set()
        base = path[:-4] if path.endswith(".npz") else path

        def col(name):
            if name in big:
                return np.load(
                    f"{base}.{name}.npy", mmap_mode="r" if mmap else None
                )
            return z[name]

        if "sup" in z or "sup" in big:
            idx.sup = col("sup")
            idx.head = col("head")
            idx.tail = col("tail")
        idx.src_indptr = col("src_indptr")
        idx.dst = col("dst")
        idx.iv_lo = col("iv_lo")
        idx.iv_hi = col("iv_hi")
        return idx

    # --- stats (dindexctl parity) ------------------------------------------
    def stats(self) -> dict:
        return {
            "dmin": self.dmin,
            "dmax": self.dmax,
            "n_nodes": self.n_nodes,
            "mode": self.mode,
            "n_rows": int(len(self.src_indptr) - 1),
            "n_intervals": int(len(self.dst)),
        }

    def merge(self, other: "DistanceIndex") -> "DistanceIndex":
        """Merge two indexes over different (dmin, dmax) ranges built
        from the SAME graph (dindexctl merge parity,
        ref: tools/src/dindexctl.cpp:115-216). Valid when the union of
        [dmin, dmax] ranges is contiguous. Fully vectorized: one lexsort
        over the concatenated rows + a segmented interval union (no
        per-row Python dicts)."""
        if self.mode != other.mode:
            raise ValueError(
                f"cannot merge distance indexes of different modes "
                f"({self.mode!r} vs {other.mode!r}): rebuild the older "
                f"index in the newer mode first (dindexctl build)"
            )
        lo = min(self.dmin, other.dmin)
        hi = max(self.dmax, other.dmax)
        a_lo, a_hi = sorted(
            [(self.dmin, self.dmax), (other.dmin, other.dmax)]
        )
        if a_lo[1] + 1 < a_hi[0]:
            raise ValueError(
                f"cannot merge non-contiguous distance ranges "
                f"[{a_lo[0]}, {a_lo[1]}] and [{a_hi[0]}, {a_hi[1]}]: "
                f"the gap ({a_lo[1] + 1}..{a_hi[0] - 1}) would be "
                f"silently rejected by the merged index"
            )
        merged = DistanceIndex(lo, hi)
        merged.mode = self.mode
        merged.n_nodes = max(self.n_nodes, other.n_nodes)
        merged.sup, merged.head, merged.tail = self.sup, self.head, self.tail
        if len(other.sup) > len(merged.sup):
            merged.sup, merged.head, merged.tail = (
                other.sup, other.head, other.tail
            )
        nrows = max(len(self.src_indptr), len(other.src_indptr)) - 1

        def row_ids(src):
            return np.repeat(
                np.arange(len(src.src_indptr) - 1, dtype=np.int64),
                np.diff(src.src_indptr),
            )

        r = np.concatenate([row_ids(self), row_ids(other)])
        d = np.concatenate([self.dst, other.dst])
        a = np.concatenate([self.iv_lo, other.iv_lo])
        b = np.concatenate([self.iv_hi, other.iv_hi])
        if len(r) == 0:
            merged.src_indptr = np.zeros(nrows + 1, dtype=np.int64)
            merged.dst = merged.iv_lo = merged.iv_hi = np.zeros(
                0, dtype=np.int64
            )
            return merged
        order = np.lexsort((a, d, r))
        r, d, a, b = r[order], d[order], a[order], b[order]
        # segmented running max of iv_hi within each (row, dst) group
        # (offset trick: BIG > any iv_hi makes the cummax reset at
        # group boundaries)
        grp = np.empty(len(r), dtype=bool)
        grp[0] = True
        grp[1:] = (r[1:] != r[:-1]) | (d[1:] != d[:-1])
        gid = np.cumsum(grp) - 1
        BIG = np.int64(max(int(b.max()), 0) + 2)
        run_hi = np.maximum.accumulate(b + gid * BIG) - gid * BIG
        # a new output interval starts where the group changes or the
        # next lo does not touch/overlap the running hi
        starts = grp.copy()
        starts[1:] |= a[1:] > run_hi[:-1] + 1
        sidx = np.nonzero(starts)[0]
        ends = np.concatenate([sidx[1:] - 1, [len(r) - 1]])
        merged.dst = d[sidx]
        merged.iv_lo = a[sidx]
        merged.iv_hi = run_hi[ends]
        counts = np.zeros(nrows, dtype=np.int64)
        np.add.at(counts, r[sidx], 1)
        merged.src_indptr = np.concatenate(
            [[0], np.cumsum(counts)]
        ).astype(np.int64)
        return merged
