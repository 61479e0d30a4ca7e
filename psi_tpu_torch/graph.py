"""Sequence-graph substrate as dense arrays.

TPU-native replacement for the reference's GUM ``SeqGraph`` + PSI shims
(ref: include/psi/graph.hpp, gum usage at include/psi/seed_finder.hpp:1156-1166):
the graph is held as CSR adjacency + concatenated node labels + per-node
char-order prefix sums, all NumPy arrays ready to be placed in HBM.

Node identity model
-------------------
* ``rank``            : 1-based dense rank, nodes sorted by coordinate id
                        (test graphs are topologically sorted by id, mirroring
                        psikt's ``ids_in_topological_order`` requirement,
                        ref: src/psikt.cpp:252-255).
* ``id`` (internal)   : equals rank here (dense 1..n).
* ``coordinate id``   : the original id from the vg/GFA file;
                        ``id_by_coordinate``/``coordinate_id`` map between them
                        (ref: gum coordinate maps used in
                        include/psi/seed_finder.hpp:1650-1676).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class Position:
    """A graph locus (node id, offset) (ref: include/psi/graph.hpp:33-82)."""

    __slots__ = ("m_id", "m_offset")

    def __init__(self, node_id: int = 0, offset: int = 0):
        self.m_id = int(node_id)
        self.m_offset = int(offset)

    def node_id(self) -> int:
        return self.m_id

    def offset(self) -> int:
        return self.m_offset

    def __iter__(self):
        return iter((self.m_id, self.m_offset))

    def __eq__(self, other) -> bool:
        return tuple(self) == tuple(other)

    def __repr__(self) -> str:
        return f"Position({self.m_id}, {self.m_offset})"


class Graph:
    """Immutable sequence graph over dense arrays.

    Construction goes through :meth:`from_parts`; loaders live in
    ``psi_tpu_torch.io`` (GFA, vg protobuf).
    """

    def __init__(
        self,
        coord_ids: np.ndarray,
        labels: np.ndarray,
        label_offsets: np.ndarray,
        out_indptr: np.ndarray,
        out_indices: np.ndarray,
        in_indptr: np.ndarray,
        in_indices: np.ndarray,
        paths: List[Tuple[str, np.ndarray]],
        rc_base: int = 0,
    ):
        #: bidirected inputs are normalized by reverse-complement node
        #: doubling at ingest (io/bidir.py): coordinate ids >= rc_base
        #: are reverse-strand twins of (id - rc_base). 0 = forward-only.
        self.rc_base = rc_base
        self.coord_ids = coord_ids          # rank-1 -> coordinate id
        self.labels = labels                # concatenated node labels, uint8 ASCII
        self.label_offsets = label_offsets  # [n+1] char-order prefix sums
        self.out_indptr = out_indptr        # CSR over ranks (0-based), file order
        self.out_indices = out_indices      # neighbor internal ids (1-based)
        self.in_indptr = in_indptr
        self.in_indices = in_indices
        self.paths = paths                  # [(name, node internal ids array)]
        self._coord_to_id: Dict[int, int] = {
            int(c): r + 1 for r, c in enumerate(coord_ids)
        }
        # plain-list mirrors for hot scalar lookups (Python-int access is
        # several times faster than numpy scalar extraction)
        self._node_len_list = np.diff(label_offsets).tolist()
        self._out_indptr_list = out_indptr.tolist()
        self._out_indices_list = out_indices.tolist()

    # --- identity maps ------------------------------------------------------
    @property
    def node_count(self) -> int:
        return len(self.coord_ids)

    def get_node_count(self) -> int:
        return self.node_count

    @property
    def edge_count(self) -> int:
        return len(self.out_indices)

    def get_edge_count(self) -> int:
        return self.edge_count

    def rank_to_id(self, rank: int) -> int:
        """1-based rank -> internal id (identity here, both dense)."""
        if not 1 <= rank <= self.node_count:
            raise IndexError(f"rank {rank} out of range")
        return rank

    def id_to_rank(self, node_id: int) -> int:
        if not 1 <= node_id <= self.node_count:
            raise IndexError(f"node id {node_id} out of range")
        return node_id

    def id_by_coordinate(self, coord_id: int) -> int:
        return self._coord_to_id[int(coord_id)]

    def coordinate_id(self, node_id: int) -> int:
        return int(self.coord_ids[node_id - 1])

    def has_node(self, node_id: int) -> bool:
        return 1 <= node_id <= self.node_count

    # --- strand helpers (node-doubled bidirected inputs) ---------------------
    def strand_of(self, node_id: int) -> str:
        """'+' or '-' for a node of a doubled bidirected graph."""
        if self.rc_base and self.coordinate_id(node_id) >= self.rc_base:
            return "-"
        return "+"

    def forward_coordinate(self, node_id: int) -> int:
        """Original (pre-doubling) coordinate id of a node."""
        c = self.coordinate_id(node_id)
        if self.rc_base and c >= self.rc_base:
            return c - self.rc_base
        return c

    def forward_strand(self, node_ids):
        """Vectorized (forward coordinate, is_reverse) for hit emission
        (vg Position semantics, ref: vg/vg.proto:29-34): hits on
        reverse-complement twins map back to the original node id with
        is_reverse = True; offsets on a twin already count from the
        forward node's END, which IS the vg is_reverse offset
        convention, so they pass through unchanged."""
        ids = np.asarray(node_ids, dtype=np.int64)
        coords = self.coord_ids[ids - 1] if len(ids) else ids
        if not self.rc_base:
            return coords, np.zeros(len(ids), dtype=bool)
        rev = coords >= self.rc_base
        return np.where(rev, coords - self.rc_base, coords), rev

    # --- labels -------------------------------------------------------------
    def node_length(self, node_id: int) -> int:
        return self._node_len_list[node_id - 1]

    def node_sequence(self, node_id: int) -> str:
        r = node_id - 1
        lo, hi = self.label_offsets[r], self.label_offsets[r + 1]
        return self.labels[lo:hi].tobytes().decode("ascii")

    def node_label_bytes(self, node_id: int) -> np.ndarray:
        r = node_id - 1
        return self.labels[self.label_offsets[r]: self.label_offsets[r + 1]]

    def id_to_charorder(self, node_id: int) -> int:
        """Char-order coordinate: bp offset of the node's first locus
        (ref: gum::util::id_to_charorder usage, include/psi/seed_finder.hpp:1314-1316)."""
        return int(self.label_offsets[node_id - 1])

    def total_nof_loci(self) -> int:
        return int(self.label_offsets[-1])

    def max_node_len(self) -> int:
        if self.node_count == 0:
            return 0
        return int(np.max(np.diff(self.label_offsets)))

    # --- adjacency ----------------------------------------------------------
    def out_neighbors(self, node_id: int):
        r = node_id - 1
        return self._out_indices_list[
            self._out_indptr_list[r]: self._out_indptr_list[r + 1]
        ]

    def first_out_neighbor(self, node_id: int) -> int:
        return self._out_indices_list[self._out_indptr_list[node_id - 1]]

    def in_neighbors(self, node_id: int) -> np.ndarray:
        r = node_id - 1
        return self.in_indices[self.in_indptr[r]: self.in_indptr[r + 1]]

    def outdegree(self, node_id: int) -> int:
        r = node_id - 1
        return self._out_indptr_list[r + 1] - self._out_indptr_list[r]

    def indegree(self, node_id: int) -> int:
        r = node_id - 1
        return int(self.in_indptr[r + 1] - self.in_indptr[r])

    def has_edges_out(self, node_id: int) -> bool:
        return self.outdegree(node_id) > 0

    def has_edges_in(self, node_id: int) -> bool:
        return self.indegree(node_id) > 0

    # --- paths --------------------------------------------------------------
    def get_path_count(self) -> int:
        return len(self.paths)

    def path_name(self, path_rank: int) -> str:
        return self.paths[path_rank][0]

    def path_nodes(self, path_rank: int) -> np.ndarray:
        return self.paths[path_rank][1]

    def for_each_path(self):
        """Yield (path_rank, first node rank) pairs, mirroring gum iteration."""
        for rank in range(len(self.paths)):
            yield rank, self.paths[rank]

    # --- components ---------------------------------------------------------
    def components_ranks(self) -> List[int]:
        """Smallest node rank of each embedded path's start node, sorted.

        Assumes one reference path per component and disjoint rank ranges per
        component (ref: include/psi/graph.hpp:301-314).
        """
        result = [self.id_to_rank(int(nodes[0])) for _, nodes in self.paths]
        result.sort()
        return result

    def component_ranges(self) -> List[Tuple[int, int]]:
        """Half-open 1-based rank ranges per component, derived from
        components_ranks with an end sentinel (ref: include/psi/seed_finder.hpp:1204-1226)."""
        ranks = self.components_ranks()
        bounds = ranks + [self.node_count + 1]
        return [(bounds[i], bounds[i + 1]) for i in range(len(ranks))]

    # --- serialization ------------------------------------------------------
    def save(self, path: str) -> None:
        """Binary graph cache (arrays as-is; avoids re-parsing chr-scale
        GFA/vg inputs on every run)."""
        np.savez_compressed(
            path,
            coord_ids=self.coord_ids,
            labels=self.labels,
            label_offsets=self.label_offsets,
            out_indptr=self.out_indptr,
            out_indices=self.out_indices,
            in_indptr=self.in_indptr,
            in_indices=self.in_indices,
            path_names=np.array([n for n, _ in self.paths], dtype=object),
            path_indptr=np.cumsum(
                [0] + [len(nodes) for _, nodes in self.paths]
            ).astype(np.int64),
            path_nodes=(
                np.concatenate([nodes for _, nodes in self.paths])
                if self.paths
                else np.zeros(0, dtype=np.int64)
            ),
            rc_base=np.int64(self.rc_base),
        )

    @staticmethod
    def load(path: str) -> "Graph":
        z = np.load(path, allow_pickle=True)
        indptr = z["path_indptr"]
        paths = [
            (str(name), z["path_nodes"][indptr[i]: indptr[i + 1]])
            for i, name in enumerate(z["path_names"])
        ]
        return Graph(
            z["coord_ids"], z["labels"], z["label_offsets"],
            z["out_indptr"], z["out_indices"],
            z["in_indptr"], z["in_indices"], paths,
            rc_base=int(z["rc_base"]) if "rc_base" in z else 0,
        )

    # --- construction -------------------------------------------------------
    @staticmethod
    def from_parts(
        nodes: Dict[int, str],
        edges: Iterable[Tuple[int, int]],
        paths: Sequence[Tuple[str, Sequence[int]]] = (),
        rc_base: int = 0,
    ) -> "Graph":
        """Build from {coord_id: sequence}, [(from_coord, to_coord)] in file
        order, and [(name, [coord ids])]."""
        coord_sorted = sorted(nodes.keys())
        coord_ids = np.asarray(coord_sorted, dtype=np.int64)
        coord_to_rank0 = {c: i for i, c in enumerate(coord_sorted)}

        seqs = [nodes[c].encode("ascii").upper() for c in coord_sorted]
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        label_offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(lens, out=label_offsets[1:])
        labels = (
            np.frombuffer(b"".join(seqs), dtype=np.uint8)
            if seqs
            else np.zeros(0, dtype=np.uint8)
        )

        edges = list(edges)
        n = len(coord_sorted)
        if edges:
            earr = np.asarray(edges, dtype=np.int64)
            if coord_sorted == list(range(1, n + 1)):
                fr = earr[:, 0] - 1
                tr = earr[:, 1] - 1
            else:
                lut = np.zeros(int(coord_ids.max()) + 1, dtype=np.int64)
                lut[coord_ids] = np.arange(n)
                fr = lut[earr[:, 0]]
                tr = lut[earr[:, 1]]
        else:
            fr = tr = np.zeros(0, dtype=np.int64)

        def to_csr(keys, vals):
            # stable sort groups by source, preserving file order per key
            order = np.argsort(keys, kind="stable")
            indptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(keys, minlength=n), out=indptr[1:])
            return indptr, (vals[order] + 1).astype(np.int64)

        out_indptr, out_indices = to_csr(fr, tr)
        in_indptr, in_indices = to_csr(tr, fr)

        gpaths = [
            (
                name,
                np.array([coord_to_rank0[c] + 1 for c in nid_list], dtype=np.int64),
            )
            for name, nid_list in paths
        ]
        return Graph(
            coord_ids,
            labels,
            label_offsets,
            out_indptr,
            out_indices,
            in_indptr,
            in_indices,
            gpaths,
            rc_base=rc_base,
        )


# --- free helpers mirroring psi::util (ref: include/psi/graph.hpp:162-287) --

def random_adjacent(graph: Graph, node_id: int, rng=None) -> int:
    """Uniformly random out-neighbor; 0 if none (ref: graph.hpp:162-202)."""
    neigh = graph.out_neighbors(node_id)
    if len(neigh) == 0:
        return 0
    if rng is None:
        rng = np.random
    return int(neigh[rng.randint(0, len(neigh))])


def least_covered_adjacent(graph: Graph, tail, paths_set) -> int:
    """Out-neighbor (of tail's last node) minimising coverage of tail+[n].

    Returns 0 when all neighbors are *equally* covered or the tail is empty,
    matching the reference's tie convention (ref: graph.hpp:250-287).
    `tail` is a mutable sequence of node ids; `paths_set` a container with
    `path_coverage` semantics (see psi_tpu_torch.pathutil).
    """
    from psi_tpu_torch.pathutil import path_coverage

    if len(tail) == 0:
        return 0
    lc_id = 0
    lc_value = None
    equally_covered = True
    for to in graph.out_neighbors(int(tail[-1])):
        to = int(to)
        cand = list(tail) + [to]
        value = path_coverage(cand, paths_set)
        if equally_covered and lc_value is not None and lc_value != value:
            equally_covered = False
        if lc_value is None or value < lc_value:
            lc_id = to
            lc_value = value
    return 0 if equally_covered else lc_id
