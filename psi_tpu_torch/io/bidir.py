"""Bidirected-graph support: node doubling at ingest.

The reference loads graphs through GUM, whose vg/GFA loaders accept
`from_start` / `to_end` edge orientations (ref: vg/vg.proto:36-47,
loaded at src/psikt.cpp:239-255). The engine's matching machinery is
forward-only (as is the reference's — psi never reverse-complements),
so reverse-orientation inputs are normalized here: every node gains a
reverse-complement twin, and each oriented edge (a, oa) -> (b, ob) maps
to a directed edge between the corresponding strand copies PLUS its
reverse-complement mirror — any oriented walk of the bidirected graph
is then a plain directed walk of the doubled graph, with identical
spelled sequence, so the seed-hit semantics carry over unchanged.

Twin coordinate ids are original + rc_base (rc_base = smallest power
of 10 above the largest input id, for readable ids); `Graph.rc_base`,
`strand_of` and `forward_coordinate` map hits back to (node, strand).
Forward-only inputs are passed through untouched (rc_base == 0).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def double_bidirected(
    nodes: Dict[int, str],
    oedges: Sequence[Tuple[int, str, int, str]],
    opaths: Sequence[Tuple[str, Sequence[Tuple[int, str]]]],
):
    """Normalize oriented edges/paths by reverse-complement doubling.

    Returns (nodes, edges, paths, rc_base); when every orientation is
    forward the input is passed through with rc_base == 0.
    """
    any_rev = any(
        fo == "-" or to == "-" for _, fo, _, to in oedges
    ) or any(o == "-" for _, segs in opaths for _, o in segs)
    if not any_rev:
        return (
            nodes,
            [(f, t) for f, fo, t, to in oedges],
            [(name, [v for v, _ in segs]) for name, segs in opaths],
            0,
        )

    max_id = max(nodes) if nodes else 0
    rc_base = 10
    while rc_base <= max_id:
        rc_base *= 10

    out_nodes: Dict[int, str] = {}
    for v, seq in nodes.items():
        out_nodes[v] = seq
        out_nodes[v + rc_base] = revcomp(seq)

    def strand(v: int, o: str) -> int:
        return v if o == "+" else v + rc_base

    def flip(v: int, o: str) -> int:
        return v + rc_base if o == "+" else v

    eset = set()
    edges: List[Tuple[int, int]] = []
    for f, fo, t, to in oedges:
        for e in (
            (strand(f, fo), strand(t, to)),
            (flip(t, to), flip(f, fo)),  # reverse-complement mirror
        ):
            if e not in eset:
                eset.add(e)
                edges.append(e)

    paths = [
        (name, [strand(v, o) for v, o in segs]) for name, segs in opaths
    ]
    return out_nodes, edges, paths, rc_base
