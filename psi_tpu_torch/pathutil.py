"""Path layer: graph paths with partial head/tail offsets, trims, coverage.

Re-implements the semantics of the reference path layer
(ref: include/psi/path_base.hpp:90-711 for the core class,
include/psi/path_interface.hpp for the free functions). A single Python
class stands in for the Default/Dynamic/Compact specs (they differ only in
storage); node-break rank/select is realised with a NumPy prefix-sum
instead of a bit vector.

Offset conventions (ref: path_base.hpp:129-135):
  ``left``  : length of the *suffix* of the first node included (0 = whole)
  ``right`` : length of the *prefix* of the last node included (0 = whole)
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


class Path:
    """A walk in the graph with optional partial first/last nodes."""

    __slots__ = ("graph", "nodes", "left", "right", "seqlen", "_starts")

    def __init__(self, graph, nodes: Iterable[int] = (), left: int = 0, right: int = 0):
        self.graph = graph
        self.nodes: List[int] = []
        self.left = 0
        self.right = 0
        self.seqlen = 0
        self._starts = None
        nodes = list(nodes)
        if nodes:
            self.set_nodes(nodes, left, right)

    # --- accessors ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self):
        return iter(self.nodes)

    def __getitem__(self, idx: int) -> int:
        return self.nodes[idx]

    def empty(self) -> bool:
        return not self.nodes

    def size(self) -> int:
        return len(self.nodes)

    def front(self) -> int:
        return self.nodes[0]

    def back(self) -> int:
        return self.nodes[-1]

    def get_nodes(self) -> List[int]:
        return self.nodes

    def get_sequence_len(self) -> int:
        return self.seqlen

    def get_head_offset(self) -> int:
        """Node offset of the first included locus of the head node."""
        if self.left == 0:
            return 0
        return self.graph.node_length(self.front()) - self.left

    def get_left_len(self) -> int:
        return self.left if self.left else self.graph.node_length(self.front())

    def get_right_len(self) -> int:
        return self.right if self.right else self.graph.node_length(self.back())

    def get_seqlen_head(self) -> int:
        if self.empty():
            return 0
        if len(self.nodes) == 1:
            return self.seqlen
        return self.get_left_len()

    def get_seqlen_tail(self) -> int:
        if self.empty():
            return 0
        if len(self.nodes) == 1:
            return self.seqlen
        return self.get_right_len()

    # --- mutators -----------------------------------------------------------
    def _dirty(self):
        self._starts = None

    def set_nodes(self, nodes: Sequence[int], left: int = 0, right: int = 0):
        self.clear()
        nodes = [int(n) for n in nodes]
        if not nodes:
            return
        self.nodes = nodes
        self.seqlen = sum(self.graph.node_length(n) for n in nodes)
        self.set_left_by_len(left)
        self.set_right_by_len(right)

    def set_left_by_len(self, value: int):
        """Set included suffix length of the first node
        (ref: path_base.hpp:381-409)."""
        if self.empty():
            raise RuntimeError("cannot set offset for an empty path")
        front_len = self.graph.node_length(self.front())
        if value > front_len or value == 0:
            value = front_len
        if len(self.nodes) == 1 and front_len - value >= self.get_right_len():
            raise RuntimeError("left exceeds right on the one-node path")
        diff = value - self.get_left_len()
        if diff == 0:
            return
        self.seqlen += diff
        self.left = 0 if value == front_len else value
        self._dirty()

    def set_right_by_len(self, value: int):
        """Set included prefix length of the last node
        (ref: path_base.hpp:411-438)."""
        if self.empty():
            raise RuntimeError("cannot set offset for an empty path")
        back_len = self.graph.node_length(self.back())
        if value > back_len or value == 0:
            value = back_len
        if len(self.nodes) == 1 and value <= self.get_head_offset():
            raise RuntimeError("right exceeds left on the one-node path")
        diff = value - self.get_right_len()
        if diff == 0:
            return
        self.seqlen += diff
        self.right = 0 if value == back_len else value
        self._dirty()

    def push_back(self, nid: int, noff: int = None):
        """Append a node; `noff` semantics per ref path_base.hpp:485-523
        (first node: start-locus offset; later nodes: prefix length)."""
        nid = int(nid)
        if noff is None:
            if self.right != 0:
                self.set_right_by_len(0)
            self.nodes.append(nid)
            self.seqlen += self.graph.node_length(nid)
            self._dirty()
            return
        first = self.empty()
        nlen = self.graph.node_length(nid)
        noff = max(0, int(noff))
        self._dirty()
        if first:
            if noff >= nlen:
                noff = nlen - 1
            self.nodes.append(nid)
            self.seqlen += nlen - noff
            self.left = self.seqlen if noff else 0
        else:
            if self.right != 0:
                self.set_right_by_len(0)
            if noff > nlen or noff == 0:
                noff = nlen
            self.nodes.append(nid)
            self.seqlen += noff
            self.right = 0 if noff == nlen else noff

    def pop_back(self):
        if self.empty():
            return
        self.seqlen -= self.get_seqlen_tail()
        self.nodes.pop()
        self.right = 0
        if self.empty():
            self.left = 0
        self._dirty()

    def pop_front(self):
        if self.empty():
            return
        self.seqlen -= self.get_seqlen_head()
        self.nodes.pop(0)
        self.left = 0
        if self.empty():
            self.right = 0
        self._dirty()

    def clear(self):
        self.nodes = []
        self.left = 0
        self.right = 0
        self.seqlen = 0
        self._dirty()

    # --- rank/select --------------------------------------------------------
    def _node_starts(self) -> np.ndarray:
        """Start position of each node in the path sequence."""
        if self._starts is None:
            lens = [self.graph.node_length(n) for n in self.nodes]
            if lens:
                lens[0] = self.get_seqlen_head()
                if len(lens) > 1:
                    lens[-1] = self.get_seqlen_tail()
            starts = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=starts[1:])
            self._starts = starts
        return self._starts

    def rank(self, pos: int) -> int:
        """0-based node rank containing sequence position `pos`
        (ref: path_base.hpp:598-606)."""
        if pos < 0 or pos >= self.seqlen:
            raise IndexError("position out of range")
        starts = self._node_starts()
        return int(np.searchsorted(starts, pos, side="right") - 1)

    def select(self, rank: int) -> int:
        """Sequence position at which node with given rank starts
        (ref: path_base.hpp:619-628)."""
        if rank < 0 or rank >= len(self.nodes):
            raise IndexError("rank out of range")
        return int(self._node_starts()[rank])

    def contains(self, nid: int) -> bool:
        return nid in self.nodes

    def sequence(self, reversed_: bool = False) -> str:
        return sequence(self, reversed_)


# --- interface functions ----------------------------------------------------


def add_node(path: Path, node_id: int, node_offset: int = None):
    if node_offset is None:
        path.push_back(node_id)
    else:
        path.push_back(node_id, node_offset)


def extend(path: Path, other: Path):
    """Append `other` to `path`, preserving other's partial head/tail offsets
    (ref: path_interface.hpp:94-113)."""
    if other.empty():
        return
    if path.empty():
        add_node(path, other.front(), other.get_head_offset())
    else:
        add_node(path, other.front())
    if other.size() > 1:
        for nid in other.nodes[1:-1]:
            add_node(path, nid)
        add_node(path, other.back(), other.get_seqlen_tail())


def sequence(path: Path, reversed_: bool = False) -> str:
    """Path sequence honouring partial head/tail
    (ref: path_interface.hpp:207-251)."""
    g = path.graph
    if path.empty():
        return ""
    off = path.get_head_offset()
    repr_ = g.node_sequence(path.front())[off: off + path.get_sequence_len()]
    if path.size() > 1:
        for nid in path.nodes[1:-1]:
            repr_ += g.node_sequence(nid)
        repr_ += g.node_sequence(path.back())[: path.get_seqlen_tail()]
    if reversed_:
        return repr_[::-1]
    return repr_


def position_to_id(path: Path, pos: int) -> int:
    return path.nodes[path.rank(pos)]


def position_to_offset(path: Path, pos: int) -> int:
    rnk = path.rank(pos)
    sel = path.select(rnk)
    return pos - sel + (path.get_head_offset() if rnk == 0 else 0)


# --- trims (ref: path_interface.hpp:338-482) --------------------------------


def trim_back(path: Path, node_id: int = 0, exclusive: bool = False):
    found = False
    while not found and not path.empty():
        if node_id == 0 or path.back() == node_id:
            found = True
        if exclusive and found:
            break
        path.pop_back()


def trim_front(path: Path, node_id: int = 0, exclusive: bool = False):
    found = False
    while not found and not path.empty():
        if node_id == 0 or path.front() == node_id:
            found = True
        if exclusive and found:
            break
        path.pop_front()


def ltrim_back_by_len(path: Path, k: int, hard: bool = False):
    """Drop tail nodes while the leftmost k-mer stays included."""
    while not path.empty() and path.get_sequence_len() - path.get_seqlen_tail() >= k:
        path.pop_back()
    if not path.empty() and hard:
        path.set_right_by_len(k + path.get_seqlen_tail() - path.get_sequence_len())


def rtrim_back_by_len(path: Path, k: int, hard: bool = False):
    """Drop tail nodes while the rightmost k-mer of the *first node* stays."""
    if path.size() < 2:
        return
    while (
        not path.empty()
        and path.get_sequence_len() - path.get_seqlen_head() - path.get_seqlen_tail()
        >= k - 1
    ):
        path.pop_back()
    if not path.empty() and hard:
        path.set_right_by_len(
            k - 1 + path.get_seqlen_tail() + path.get_seqlen_head()
            - path.get_sequence_len()
        )


def ltrim_front_by_len(path: Path, k: int, hard: bool = False):
    """Drop head nodes while the leftmost k-mer of the *last node* stays."""
    if path.size() < 2:
        return
    while (
        not path.empty()
        and path.get_sequence_len() - path.get_seqlen_head() - path.get_seqlen_tail()
        >= k - 1
    ):
        path.pop_front()
    if not path.empty() and hard:
        path.set_left_by_len(
            k - 1 + path.get_seqlen_tail() + path.get_seqlen_head()
            - path.get_sequence_len()
        )


def rtrim_front_by_len(path: Path, k: int, hard: bool = False):
    """Drop head nodes while the rightmost k-mer stays included."""
    while not path.empty() and path.get_sequence_len() - path.get_seqlen_head() >= k:
        path.pop_front()
    if not path.empty() and hard:
        path.set_left_by_len(k + path.get_seqlen_head() - path.get_sequence_len())


def leftmost_kmer_pos(path: Path, k: int) -> Tuple[int, int]:
    """(node, offset) of the last base of the leftmost k-mer
    (ref: path_interface.hpp:484-501)."""
    g = path.graph
    length = 0
    for nid in path.nodes:
        length += g.node_length(nid)
        if length >= k:
            return nid, k + g.node_length(nid) - length - 1
    return 0, 0


def rightmost_kmer_pos(path: Path, k: int) -> Tuple[int, int]:
    """(node, offset) of the first base of the rightmost k-mer
    (ref: path_interface.hpp:503-520)."""
    g = path.graph
    length = 0
    for nid in reversed(path.nodes):
        length += g.node_length(nid)
        if length >= k:
            return nid, length - k
    return 0, 0


# --- containment / coverage (ref: path_interface.hpp:535-828) ---------------


def _contains(big: Sequence[int], small: Sequence[int]) -> bool:
    """Contiguous-ordered containment anchored at the FIRST occurrence of
    small[0] in big — exact mirror of the reference quirk
    (ref: path_interface.hpp:601-612)."""
    nb, ns = len(big), len(small)
    if ns == 0 or nb == 0 or nb < ns:
        return False
    first = small[0]
    try:
        idx = next(i for i, v in enumerate(big) if v == first)
    except StopIteration:
        return False
    if nb - idx < ns:
        return False
    for i in range(ns):
        if big[idx + i] != small[i]:
            return False
    return True


def contains(path, nodes: Sequence[int]) -> bool:
    """Whether `path` contains `nodes` as a contiguous ordered run."""
    return _contains(list(path.get_nodes()), list(nodes))


def rcontains(path, rnodes: Sequence[int]) -> bool:
    """Reverse-direction containment (ref: path_interface.hpp:634-655)."""
    return _contains(list(path.get_nodes())[::-1], list(rnodes))


def covered_by(nodes: Sequence[int], paths_set) -> bool:
    """Whether `nodes` occurs as a contiguous run in any path of the set
    (ref: path_interface.hpp:718-744). Empty queries are NOT covered."""
    nodes = list(nodes)
    # PathSet instances provide an indexed check
    found = getattr(paths_set, "covered_by", None)
    if found is not None and not isinstance(paths_set, (list, tuple)):
        return paths_set.covered_by(nodes)
    for p in paths_set:
        if contains(p, nodes):
            return True
    return False


def node_covered_by(node_id: int, paths_set) -> bool:
    for p in paths_set:
        if p.contains(node_id):
            return True
    return False


def path_coverage(nodes: Sequence[int], paths_set) -> int:
    """Number of paths containing `nodes` as contiguous run
    (ref: path_interface.hpp:817-828)."""
    nodes = list(nodes)
    cov = 0
    if len(nodes) == 1:
        for p in paths_set:
            if p.contains(nodes[0]):
                cov += 1
        return cov
    for p in paths_set:
        if contains(p, nodes):
            cov += 1
    return cov


class MicroPath:
    """Membership-only path: node-ID set, no order or sequence — the
    reference's Path<Micro> spec (ref: path_base.hpp:834-954), used
    where only `contains(node)` queries matter (e.g. visit sets).
    """

    __slots__ = ("nodes_set",)

    def __init__(self, nodes: Iterable[int] = ()):
        self.nodes_set = set(int(v) for v in nodes)

    def add_node(self, node_id: int):
        self.nodes_set.add(int(node_id))

    def extend(self, other):
        self.nodes_set.update(
            other.nodes_set if isinstance(other, MicroPath) else other
        )

    def contains(self, node_id: int) -> bool:
        return int(node_id) in self.nodes_set

    def size(self) -> int:
        return len(self.nodes_set)

    def empty(self) -> bool:
        return not self.nodes_set

    def clear(self):
        self.nodes_set.clear()


# --- psi::Path -> vg::Path conversion (ref: path_interface.hpp:842-942) -----


def convert_path(graph, path, loci=None):
    """Convert a Path to vg::Path mappings, optionally splitting each
    node's match edit at the starting loci with 1-bp "S" edits (exact
    mirror of ref: include/psi/path_interface.hpp:842-942, used by
    pindexctl's GAM export, tools/src/pindexctl.cpp:100-131).

    Returns [(coord_node_id, offset, rank, [(from_len, to_len, seq)])].
    `loci` must be sorted by (node rank, offset) — the order
    SeedFinder.get_starting_loci() produces. Quirks preserved: with
    loci, the FIRST node's edit run spans to the full node length (no
    head-trim of label_len), a SINGLE-node path ignores the tail trim,
    and on the LAST node only loci at offsets <= the start offset are
    marked (ref's asymmetric lower/upper bounds).
    """
    from bisect import bisect_left, bisect_right

    nodes = path.get_nodes()
    mappings = []
    if loci is None:
        for i, nid in enumerate(nodes):
            noff = 0
            if i == 0:
                label_len = path.get_seqlen_head()
                noff = path.get_head_offset()
            elif i == len(nodes) - 1:
                label_len = path.get_seqlen_tail()
            else:
                label_len = graph.node_length(nid)
            mappings.append(
                _strand_row(graph, nid, noff, i + 1,
                            [(label_len, label_len, "")])
            )
        return mappings

    keys = [
        (graph.id_to_rank(l.node_id()), l.offset()) for l in loci
    ]
    for i, nid in enumerate(nodes):
        label_len = graph.node_length(nid)
        coffset = 0
        if i == 0:
            coffset = path.get_head_offset()
        elif i == len(nodes) - 1:
            label_len = path.get_seqlen_tail()
        rank = graph.id_to_rank(nid)
        if i == len(nodes) - 1:
            nextedit = bisect_left(keys, (rank, -1))
            lastedit = bisect_right(keys, (rank, coffset))
        else:
            nextedit = bisect_left(keys, (rank, coffset))
            lastedit = bisect_right(keys, (rank, float("inf")))
        toffset = keys[nextedit][1] if nextedit != lastedit else label_len
        edits = []
        while True:
            if coffset > toffset:
                nextedit += 1
                toffset = (
                    keys[nextedit][1] if nextedit != lastedit else label_len
                )
            if coffset == toffset:
                edits.append((1, 1, "S"))
                coffset += 1
            else:
                edits.append((toffset - coffset, toffset - coffset, ""))
                coffset = toffset
            if coffset >= label_len:
                break
        start_off = path.get_head_offset() if i == 0 else 0
        mappings.append(_strand_row(graph, nid, start_off, i + 1, edits))
    return mappings


def _strand_row(graph, nid, off, rank, edits):
    """One convert_path mapping row, strand-aware: reverse-twin nodes of
    a doubled bidirected graph export their FORWARD coordinate with
    is_reverse = True (vg Position semantics, ref: vg/vg.proto:29-34);
    forward-only graphs keep the 4-tuple shape unchanged."""
    coord = graph.coordinate_id(nid)
    if graph.rc_base and coord >= graph.rc_base:
        return (coord - graph.rc_base, off, rank, edits, True)
    return (coord, off, rank, edits)
