"""Synthetic pan-genome graph construction (benchmark / test substrate).

Builds a variation graph the way vg does from a VCF: a linear reference
segmented at variant sites, with biallelic SNP/insertion bubbles, one
embedded reference path per component — the structural shape of the
reference's benchmark graphs (prepare_vg.sh 1000G pipeline) without
needing data downloads in a zero-egress image.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from psi_tpu_torch.graph import Graph

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_pangenome_graph(
    ref_len: int,
    variant_rate: float = 0.01,
    indel_frac: float = 0.2,
    seed: int = 0,
    n_components: int = 1,
) -> Graph:
    """Random reference + biallelic bubbles every ~1/variant_rate bp."""
    rng = np.random.RandomState(seed)
    nodes: Dict[int, str] = {}
    edges: List[Tuple[int, int]] = []
    paths = []
    next_id = 1

    comp_len = ref_len // n_components
    for comp in range(n_components):
        ref = rng.choice(BASES, size=comp_len).tobytes().decode("ascii")
        n_var = int(rng.poisson(comp_len * variant_rate))
        n_var = min(n_var, comp_len // 4)
        if n_var > 0:
            var_pos = np.sort(
                rng.choice(
                    np.arange(1, comp_len - 1), size=n_var, replace=False
                )
            )
            keep: List[int] = []
            for p in var_pos:
                if not keep or p > keep[-1] + 1:
                    keep.append(int(p))
        else:
            keep = []

        # alternate reference segments and bubbles
        pieces = []  # ("seg", text) | ("bub", ref_allele, alt_allele)
        cursor = 0
        for p in keep:
            pieces.append(("seg", ref[cursor: p]))
            ref_allele = ref[p]
            if rng.random_sample() < indel_frac:
                alt = ref_allele + "ACGT"[rng.randint(4)]  # insertion
            else:
                alt = "ACGT"[("ACGT".index(ref_allele) + 1 + rng.randint(3)) % 4]
            pieces.append(("bub", ref_allele, alt))
            cursor = p + 1
        pieces.append(("seg", ref[cursor:]))

        path_nodes: List[int] = []
        prev_tails: List[int] = []
        for piece in pieces:
            if piece[0] == "seg":
                if not piece[1]:
                    continue
                nid = next_id
                next_id += 1
                nodes[nid] = piece[1]
                for t in prev_tails:
                    edges.append((t, nid))
                prev_tails = [nid]
                path_nodes.append(nid)
            else:
                r_id, a_id = next_id, next_id + 1
                next_id += 2
                nodes[r_id] = piece[1]
                nodes[a_id] = piece[2]
                for t in prev_tails:
                    edges.append((t, r_id))
                    edges.append((t, a_id))
                prev_tails = [r_id, a_id]
                path_nodes.append(r_id)
        paths.append((f"ref{comp}", path_nodes))

    return Graph.from_parts(nodes, edges, paths)
