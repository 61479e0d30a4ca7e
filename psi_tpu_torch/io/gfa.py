"""GFA 1 / GFA 2 graph loader.

Supports the subsets used by vg-exported pan-genome graphs (the formats of
the reference's bundled test data, e.g. test/data/tiny/tiny.gfa):

GFA 1:  ``S <id> <seq>``, ``L <from> <fo> <to> <to_o> <overlap>``,
        ``P <name> <seg list> <overlaps>``
GFA 2:  ``S <id> <len> <seq>``, ``E <eid> <from±> <to±> ...``,
        ``O <name> <ref list>``

Reverse orientations (inversions) are normalized at ingest by
reverse-complement node doubling (io/bidir.py): the engine itself is
forward-only, like the reference's matchers (GUM accepts the
orientations, psi never reverse-complements; ref: vg/vg.proto:36-47,
src/psikt.cpp:239-255).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from psi_tpu_torch.graph import Graph
from psi_tpu_torch.io.bidir import double_bidirected


def _parse_oriented(ref: str) -> Tuple[int, str]:
    orient = ref[-1]
    if orient in "+-":
        return int(ref[:-1]), orient
    return int(ref), "+"


def load_gfa(path: str) -> Graph:
    nodes: Dict[int, str] = {}
    oedges: List[Tuple[int, str, int, str]] = []
    opaths: List[Tuple[str, List[Tuple[int, str]]]] = []

    with open(path, "r") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            fields = line.split("\t")
            tag = fields[0]
            if tag == "S":
                # GFA2: S id len seq ; GFA1: S id seq [tags]
                if len(fields) >= 4 and fields[2].isdigit() and not set(
                    fields[2]
                ) <= set("ACGTNacgtn"):
                    nodes[int(fields[1])] = fields[3]
                else:
                    nodes[int(fields[1])] = fields[2]
            elif tag == "L":
                f, fo = _parse_oriented(fields[1] + fields[2])
                t, to = _parse_oriented(fields[3] + fields[4])
                oedges.append((f, fo, t, to))
            elif tag == "E":
                f, fo = _parse_oriented(fields[2])
                t, to = _parse_oriented(fields[3])
                oedges.append((f, fo, t, to))
            elif tag == "P":
                segs = [_parse_oriented(s) for s in fields[2].split(",")]
                opaths.append((fields[1], segs))
            elif tag == "O":
                segs = [_parse_oriented(s) for s in fields[2].split(" ")]
                opaths.append((fields[1], segs))

    nodes, edges, paths, rc_base = double_bidirected(nodes, oedges, opaths)
    return Graph.from_parts(nodes, edges, paths, rc_base=rc_base)
