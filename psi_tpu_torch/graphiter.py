"""Graph iterators: BFS, Backtracker (DFS with backlog), and Haplotypers.

Host-side traversal machinery used at index-build time (path picking and
uncovered-locus detection). Mirrors the traversal orders of the reference
iterator family (ref: include/psi/graph_iter.hpp:139-1005); the generated
haplotypes/loci define output parity, so edge iteration order (file order)
and fallback rules are preserved exactly.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from psi_tpu_torch.graph import Graph
from psi_tpu_torch.pathutil import Path, rtrim_front_by_len


class EndOfIteration(Exception):
    pass


class HaplotypePath:
    """A haplotype as an ordered node list with O(1) window containment.

    Stands in for the reference's rank-bitvector Haplotype path
    (ref: include/psi/path_base.hpp:965-1315): since haplotype walks visit
    strictly increasing ranks, window containment equals contiguous-run
    (slice) equality at the unique position of the query's first node.
    """

    __slots__ = ("nodes", "_pos")

    def __init__(self, nodes: Sequence[int] = ()):
        self.nodes: List[int] = [int(n) for n in nodes]
        self._pos = {n: i for i, n in enumerate(self.nodes)}

    def push_back(self, nid: int):
        nid = int(nid)
        self.nodes.append(nid)
        self._pos[nid] = len(self.nodes) - 1

    def clear(self):
        self.nodes = []
        self._pos = {}

    def __len__(self):
        return len(self.nodes)

    def __iter__(self):
        return iter(self.nodes)

    def contains(self, query) -> bool:
        """Contiguous ordered containment (ref: path_base.hpp:1257-1281).

        `query` must be a list of Python ints (hot path)."""
        if isinstance(query, int):
            return query in self._pos
        if not query:
            return False
        idx = self._pos.get(query[0])
        if idx is None or idx + len(query) > len(self.nodes):
            return False
        return self.nodes[idx: idx + len(query)] == query


def hap_covered_by(nodes, visited: Sequence[HaplotypePath]) -> bool:
    """covered_by over generated haplotypes (ref: graph_iter.hpp:692-700).

    `nodes` must be a list of Python ints (hot path)."""
    if not nodes:
        return False
    for hp in visited:
        if hp.contains(nodes):
            return True
    return False


def hap_path_coverage(nodes, visited: Sequence[HaplotypePath]) -> int:
    nodes = list(nodes)
    cov = 0
    if len(nodes) == 1:
        for hp in visited:
            if hp.contains(nodes[0]):
                cov += 1
        return cov
    for hp in visited:
        if hp.contains(nodes):
            cov += 1
    return cov


def _least_covered_adjacent_tail(graph: Graph, tail: List[int], visited) -> int:
    """Least-covered continuation of `tail` (ref: include/psi/graph.hpp:250-287).

    Returns 0 if tail is empty, no forward edge exists, or all continuations
    are equally covered."""
    if not tail:
        return 0
    lc_id = 0
    lc_value = None
    equally = True
    for to in graph.out_neighbors(tail[-1]):
        to = int(to)
        value = hap_path_coverage(tail + [to], visited)
        if equally and lc_value is not None and lc_value != value:
            equally = False
        if lc_value is None or value < lc_value:
            lc_id, lc_value = to, value
    return 0 if equally else lc_id


class BFSIter:
    """Component-restarting BFS over all nodes (ref: graph_iter.hpp:272-432)."""

    def __init__(self, graph: Graph, start: int = 0):
        self.graph = graph
        self.reset(start)

    def reset(self, start: int = 0):
        g = self.graph
        if start == 0:
            start = g.rank_to_id(1)
        self.lb_rank = 1
        if g.id_to_rank(start) == 1:
            self.lb_rank += 1
        self.value: Optional[int] = start
        self.visiting = deque([(start, 0)])
        self.visited = {start}

    def at_end(self) -> bool:
        return self.value is None

    def level(self) -> int:
        if self.visiting:
            return self.visiting[0][1]
        raise RuntimeError("level query at end of iterator")

    def next(self):
        if not self.visiting:
            return
        plevel = self.level()
        for to in self.graph.out_neighbors(self.value):
            to = int(to)
            if to not in self.visited:
                self.visiting.append((to, plevel + 1))
                self.visited.add(to)
        self.visiting.popleft()
        if self.visiting:
            self.value = self.visiting[0][0]
        else:
            self.value = self._next_unvisited()
            if self.value is not None:
                self.visiting.append((self.value, 0))
                self.visited.add(self.value)
        if self.value is not None and self.lb_rank == self.graph.id_to_rank(self.value):
            self.lb_rank += 1

    def _next_unvisited(self) -> Optional[int]:
        for rank in range(self.lb_rank, self.graph.node_count + 1):
            nid = self.graph.rank_to_id(rank)
            if nid not in self.visited:
                self.lb_rank = rank
                return nid
        return None


class BacktrackerIter:
    """DFS with a branch backlog enabling backtracking
    (ref: graph_iter.hpp:434-535). `next()` follows the first out-edge and
    buffers siblings; `backtrack()` (the reference's `--itr`) rewinds to the
    latest buffered branch."""

    def __init__(self, graph: Graph, start: int = 0):
        self.graph = graph
        if start == 0:
            start = graph.rank_to_id(1)
        self.start = start
        self.value: Optional[int] = start
        self.buffer: Optional[int] = None
        self.visiting: List[tuple] = []

    def at_end(self) -> bool:
        return self.value is None

    def next(self):
        if self.buffer is not None:
            self.value = self.buffer
            self.buffer = None
            return
        cnode = self.value
        self.value = None
        for i, to in enumerate(self.graph.out_neighbors(cnode)):
            to = int(to)
            if self.value is None and i == 0:
                self.value = to
            else:
                self.visiting.append((cnode, to))

    def backtrack(self):
        if self.buffer is not None:
            while self.visiting and self.visiting[-1][0] == self.value:
                self.visiting.pop()
            self.buffer = None
        self.value = None
        if self.visiting:
            self.value, self.buffer = self.visiting[-1]
            self.visiting.pop()

    def reset(self, start: int = 0):
        if start == 0:
            start = self.start
        self.value = start
        self.buffer = None
        self.visiting = []


class HaplotyperIter:
    """Diversity-seeking haplotype generator, 'Global' flavour
    (ref: graph_iter.hpp:537-731).

    The setback window is measured in *nodes*: its length is bounded so the
    product of out-degrees (entropy) stays <= setback = number of previously
    generated haplotypes."""

    def __init__(self, graph: Graph, start: int = 0, rng: Optional[np.random.RandomState] = None):
        self.graph = graph
        self.rng = rng or np.random.RandomState(0)
        if start == 0:
            start = graph.rank_to_id(1)
        self.start = start
        self.raise_on_end = False
        # walk-length guard: cyclic graphs are out of contract (psikt
        # requires topological order) but must terminate, not hang
        self.max_steps = 4 * graph.node_count + 1024
        self._steps = 0
        self._init_state(start)
        self.visited: List[HaplotypePath] = []
        self.setback = 0

    def _init_state(self, start: int):
        self.value: Optional[int] = start
        self.visiting: List[int] = []  # setback window node ids
        self.entropy = 1
        self.current_path = HaplotypePath([start])

    # -- protocol ------------------------------------------------------------
    def at_end(self) -> bool:
        return self.value is None

    def level(self) -> int:
        return len(self.visited)

    def is_visited(self, nodes) -> bool:
        return hap_covered_by(nodes, self.visited)

    def next(self):
        g = self.graph
        self._steps += 1
        if not g.has_edges_out(self.value) or self._steps > self.max_steps:
            self.value = None
            if self.raise_on_end:
                raise EndOfIteration
            return

        if self.setback > 1:
            while self.visiting and self.entropy > self.setback:
                self.entropy //= max(1, g.outdegree(self.visiting[0]))
                self.visiting.pop(0)

        candidate = None
        if self.setback == 0 or g.outdegree(self.value) == 1:
            candidate = int(g.out_neighbors(self.value)[0])
        else:
            # search for an out-node whose setback path is unvisited
            while True:
                for to in g.out_neighbors(self.value):
                    to = int(to)
                    if not self.is_visited(self.visiting + [to]):
                        candidate = to
                        break
                # setback==1 retry: widen the window by the current node once
                if (
                    self.setback == 1
                    and candidate is None
                    and not self.visiting
                ):
                    self.visiting.append(self.value)
                    continue
                break
            if self.setback == 1 and self.visiting:
                self.visiting.pop()

        if candidate is None:
            candidate = _least_covered_adjacent_tail(g, self.visiting, self.visited)
            if candidate == 0:
                candidate = None
        if candidate is None:
            neigh = g.out_neighbors(self.value)
            candidate = int(neigh[self.rng.randint(0, len(neigh))])

        self.value = candidate
        if self.setback > 1:
            self.visiting.append(self.value)
            self.entropy *= max(1, g.outdegree(self.value))
        self.current_path.push_back(self.value)

    def restart(self):
        """Discard the current walk and restart (ref `(*this)--`)."""
        self.value = self.start
        self._steps = 0
        self.visiting = []
        self.entropy = 1
        if self.setback > 1:
            self.visiting.append(self.value)
            self.entropy *= max(1, self.graph.outdegree(self.value))
        self.current_path = HaplotypePath([self.value])

    def finish(self):
        """Record the current walk as a generated haplotype and restart
        (ref `--(*this)`)."""
        self.visited.append(self.current_path)
        self.setback = len(self.visited)
        self.restart()

    def reset(self, start: int = 0):
        if start == 0:
            start = self.start
        self.start = start
        self._init_state(start)
        self.visited = []
        self.setback = 0


class HaplotyperLocalIter(HaplotyperIter):
    """'Local' flavour: setback window measured in basepairs with
    2*ceil(log2(n+1))-1 growth (ref: graph_iter.hpp:733-924)."""

    def __init__(self, graph: Graph, start: int = 0, param: int = 0,
                 rng: Optional[np.random.RandomState] = None):
        if param == 0:
            raise ValueError("parameter of Local Haplotyper cannot be zero")
        self.param = param
        super().__init__(graph, start, rng)
        self.visiting_path = Path(graph)

    def next(self):
        g = self.graph
        if not g.has_edges_out(self.value):
            self.value = None
            if self.raise_on_end:
                raise EndOfIteration
            return

        if self.setback != 0:
            rtrim_front_by_len(self.visiting_path, self.param - 1)

        candidate = None
        if self.setback == 0 or g.outdegree(self.value) == 1:
            candidate = int(g.out_neighbors(self.value)[0])
        else:
            for to in g.out_neighbors(self.value):
                to = int(to)
                if not self.is_visited(self.visiting_path.get_nodes() + [to]):
                    candidate = to
                    break

        if candidate is None:
            candidate = _least_covered_adjacent_tail(
                g, list(self.visiting_path.get_nodes()), self.visited
            )
            if candidate == 0:
                candidate = None
        if candidate is None:
            neigh = g.out_neighbors(self.value)
            candidate = int(neigh[self.rng.randint(0, len(neigh))])

        self.value = candidate
        if self.setback != 0:
            self.visiting_path.push_back(self.value)
        self.current_path.push_back(self.value)

    def restart(self):
        self.value = self.start
        self.visiting_path = Path(self.graph)
        if self.setback != 0:
            self.visiting_path.push_back(self.value)
        self.current_path = HaplotypePath([self.value])

    def finish(self):
        self.visited.append(self.current_path)
        n = len(self.visited)
        self.setback = 0 if n == 0 else 2 * math.ceil(math.log2(n + 1)) - 1
        self.restart()

    def reset(self, start: int = 0, param: int = 0):
        if start == 0:
            start = self.start
        if param == 0:
            param = self.param
        self.start = start
        self.param = param
        self._init_state(start)
        self.visiting_path = Path(self.graph)
        self.visited = []
        self.setback = 0


class HaplotyperRandomIter:
    """Uniform random walk (ref: graph_iter.hpp:926-1005)."""

    def __init__(self, graph: Graph, start: int = 0, seed: int = 0):
        self.graph = graph
        if start == 0:
            start = graph.rank_to_id(1)
        self.start = start
        self.value: Optional[int] = start
        self._level = 1
        self.rng = np.random.RandomState(seed if seed else None)
        self.raise_on_end = False

    def at_end(self) -> bool:
        return self.value is None

    def level(self) -> int:
        return self._level

    def next(self):
        g = self.graph
        if not g.has_edges_out(self.value):
            self.value = None
            if self.raise_on_end:
                raise EndOfIteration
            return
        neigh = g.out_neighbors(self.value)
        self.value = int(neigh[self.rng.randint(0, len(neigh))])
        self._level += 1

    def finish(self):
        self.reset()

    def reset(self, start: int = 0):
        if start == 0:
            start = self.start
        self.value = start
        self.start = start
        self._level = 1


def extend_to_k(path: Path, itr, k: int):
    """Add nodes from the iterator until sequence length >= k
    (ref: graph_iter.hpp:1017-1028)."""
    while not itr.at_end() and path.get_sequence_len() < k:
        path.push_back(itr.value)
        itr.next()


def count_kmers(graph: Graph, k: int) -> int:
    """Exhaustively count distinct k-mers in the graph via Backtracker
    enumeration (ref: graph_iter.hpp:1043-1086)."""
    kmers = set()
    bt = BacktrackerIter(graph)
    for rank in range(1, graph.node_count + 1):
        nid = graph.rank_to_id(rank)
        label_len = graph.node_length(nid)
        bt.reset(nid)
        path = Path(graph)
        while not bt.at_end():
            extend_to_k(path, bt, label_len - 1 + k)
            seq = path.sequence()
            for f in range(min(label_len, max(0, len(seq) - k + 1))):
                kmers.add(seq[f: f + k])
            bt.backtrack()
            if bt.at_end():
                break
            from psi_tpu_torch.pathutil import trim_back

            trim_back(path, bt.value)
        del path
    return len(kmers)
