"""Path sets and the path index (host-side structure).

``PathSet`` mirrors the reference container of initialized paths with an
occurrence index giving substring-run coverage checks (the reference
realises this with an FM index over comma-encoded node-ID strings,
ref: include/psi/pathset.hpp:43-350; here a node->positions hash gives the
same all-occurrence semantics).

``PathIndex`` composes a PathSet with the FM index over (reversed) path
sequences (ref: include/psi/pathindex.hpp:40-333). The FM machinery lives
in psi_tpu_torch.fmindex; this module owns path bookkeeping, haplotype pickers
and the patch generator.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from psi_tpu_torch.graph import Graph
from psi_tpu_torch.graphiter import EndOfIteration, extend_to_k
from psi_tpu_torch.pathutil import (
    Path,
    extend,
    ltrim_front_by_len,
    rcontains,
    rtrim_front_by_len,
    sequence,
    trim_front,
)


class PathSet:
    """Container of initialized paths with indexed coverage queries."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.paths: List[Path] = []
        # occurrence index: node id -> [(path_idx, position)]
        self._occ = {}

    def __len__(self) -> int:
        return len(self.paths)

    def size(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Path:
        return self.paths[idx]

    def __iter__(self):
        return iter(self.paths)

    def push_back(self, path: Path):
        idx = len(self.paths)
        self.paths.append(path)
        for pos, nid in enumerate(path.get_nodes()):
            self._occ.setdefault(int(nid), []).append((idx, pos))

    def clear(self):
        self.paths = []
        self._occ = {}

    def covered_by(self, nodes: Sequence[int]) -> bool:
        """True when `nodes` occurs as a contiguous run in any stored path —
        all-occurrence substring semantics (ref: pathset.hpp:204-218)."""
        nodes = [int(n) for n in nodes]
        if not nodes:
            return False
        for pidx, pos in self._occ.get(nodes[0], ()):
            pnodes = self.paths[pidx].get_nodes()
            if pos + len(nodes) <= len(pnodes) and pnodes[pos: pos + len(nodes)] == nodes:
                return True
        return False

    def sequences(self, reversed_: bool = False) -> List[str]:
        return [sequence(p, reversed_) for p in self.paths]


class PathIndex:
    """PathSet + FM index over reversed path sequences, lazy build
    (ref: pathindex.hpp:40-333; reversed-text convention per
    seed_finder.hpp:779)."""

    def __init__(self, graph: Graph, lazy: bool = True, context: int = 0):
        self.graph = graph
        self.paths_set = PathSet(graph)
        self.context = context
        self.fm = None  # psi_tpu_torch.fmindex.FMIndex over reversed path sequences

    def reserve(self, n: int):
        pass

    def set_context(self, context: int):
        self.context = context

    def get_context(self) -> int:
        return self.context

    def get_paths_set(self) -> PathSet:
        return self.paths_set

    def __len__(self) -> int:
        return len(self.paths_set)

    def push_back(self, path: Path):
        self.paths_set.push_back(path)

    def covered_by(self, nodes: Sequence[int]) -> bool:
        return self.paths_set.covered_by(nodes)

    def create_index(self):
        """Materialize reversed path sequences and build the FM index
        (ref: pathindex.hpp:235-268)."""
        from psi_tpu_torch.fmindex import FMIndex

        seqs = self.paths_set.sequences(reversed_=True)
        self.fm = FMIndex.build_from_strings(seqs)

    # --- SA position -> graph position mapping ------------------------------
    def position_to_graph(self, path_idx: int, rev_end_offset: int):
        """Map an occurrence end-position in the reversed text to
        (node_id, node_offset) of the occurrence start in forward orientation
        (ref: pathindex.hpp:378-416 with the end-position convention of
        index_iter.hpp:686-723)."""
        path = self.paths_set[path_idx]
        fwd_pos = path.get_sequence_len() - rev_end_offset - 1
        rnk = path.rank(fwd_pos)
        sel = path.select(rnk)
        node_id = path.get_nodes()[rnk]
        node_off = fwd_pos - sel + (path.get_head_offset() if rnk == 0 else 0)
        return node_id, node_off

    # --- serialization ------------------------------------------------------
    def save(self, prefix: str):
        """Serialize paths + FM arrays as one .npz per artifact
        (same prefix/_paths layout as the reference,
        ref: pathindex.hpp:100-143)."""
        import pickle

        meta = {
            "context": self.context,
            "paths": [
                (
                    [self.graph.coordinate_id(n) for n in p.get_nodes()],
                    p.left,
                    p.right,
                )
                for p in self.paths_set
            ],
        }
        with open(prefix + "_paths", "wb") as fh:
            pickle.dump(meta, fh)
        if self.fm is not None:
            self.fm.save(prefix)

    def load(self, prefix: str) -> bool:
        import os
        import pickle

        from psi_tpu_torch.fmindex import FMIndex

        if not os.path.exists(prefix + "_paths"):
            return False
        with open(prefix + "_paths", "rb") as fh:
            meta = pickle.load(fh)
        if self.context != 0 and meta["context"] != 0 and self.context > meta["context"]:
            return False  # stored context too small for requested one
        if meta["context"] != 0:
            self.context = meta["context"]
        self.paths_set.clear()
        for nodes, left, right in meta["paths"]:
            internal = [self.graph.id_by_coordinate(c) for c in nodes]
            self.paths_set.push_back(Path(self.graph, internal, left, right))
        try:
            self.fm = FMIndex.load(prefix)
        except FileNotFoundError:
            self.create_index()
        return True


# --- haplotype pickers (ref: pathindex.hpp:450-605) -------------------------


def get_uniq_full_haplotype(paths, hp_itr, tries: int = 0) -> None:
    """Walk one full haplotype; optionally retry while duplicated
    (ref: pathindex.hpp:450-471)."""
    while True:
        haplotype = Path(hp_itr.graph)
        while not hp_itr.at_end():
            haplotype.push_back(hp_itr.value)
            hp_itr.next()
        if tries > 0 and hp_itr.is_visited(haplotype.get_nodes()):
            tries -= 1
            hp_itr.restart()
            continue
        hp_itr.finish()
        if len(haplotype) != 0:
            paths.push_back(haplotype)
        return


def get_uniq_patches(paths, hp_itr, k: int) -> None:
    """Emit only *patch* paths covering previously-uncovered k-contexts,
    merging patches closer than k and gluing k-1 context on each side
    (exact mirror of ref: pathindex.hpp:496-560)."""
    hp_itr.raise_on_end = True
    g = hp_itr.graph
    patch = Path(g)
    frontier = Path(g)
    marked = 0
    try:
        while True:
            marked = 0
            if not frontier.empty():
                marked = frontier.get_nodes()[-1]
            # Bootstrap.
            if not marked:
                extend_to_k(frontier, hp_itr, k)
            else:
                extend_to_k(
                    frontier,
                    hp_itr,
                    2 * k + frontier.get_sequence_len() - frontier.get_seqlen_tail(),
                )
            # Merge with the previous patch if the next one is closer than k.
            if not patch.empty() and hp_itr.is_visited(frontier.get_nodes()):
                patch.set_right_by_len(k - 1)
                paths.push_back(patch)
                patch = Path(g)
                rtrim_front_by_len(frontier, k, True)
            elif not patch.empty():
                trim_front(frontier, marked)
                marked = 0
                extend_to_k(frontier, hp_itr, k)
            if patch.empty():
                # search for an uncovered k-length window
                while hp_itr.is_visited(frontier.get_nodes()):
                    frontier.push_back(hp_itr.value)
                    ltrim_front_by_len(frontier, k, True)
                    hp_itr.next()
            # extend the patch
            extend(patch, frontier)
            rtrim_front_by_len(frontier, k)
            while not hp_itr.is_visited(frontier.get_nodes()):
                frontier.push_back(hp_itr.value)
                patch.push_back(hp_itr.value)
                rtrim_front_by_len(frontier, k)
                hp_itr.next()
    except EndOfIteration:
        if len(patch) > 0:
            if not hp_itr.is_visited(frontier.get_nodes()) and not rcontains(
                patch, list(frontier.get_nodes())[::-1]
            ):
                if marked != 0:
                    trim_front(frontier, marked)
                extend(patch, frontier)
            paths.push_back(patch)
        hp_itr.finish()
    hp_itr.raise_on_end = False


def get_uniq_patched_haplotype(paths, hp_itr, context_len: int) -> bool:
    """(ref: pathindex.hpp:562-578)"""
    assert context_len != 0
    if hp_itr.level() == 0:
        get_uniq_full_haplotype(paths, hp_itr)
        return True
    paths_no = len(paths)
    get_uniq_patches(paths, hp_itr, context_len)
    return paths_no != len(paths)


def get_uniq_haplotype(paths, hp_itr, context_len: int, patched: bool) -> bool:
    """(ref: pathindex.hpp:580-592)"""
    if patched:
        return get_uniq_patched_haplotype(paths, hp_itr, context_len)
    get_uniq_full_haplotype(paths, hp_itr)
    return True
