"""Locus pairs and a GAF of read pairs for the distance index, made from a
seed: the pair workload of `alice dstats` (ref: tools/src/alice.cpp:
599-737), which chip_smoke.py's [dindex] phase and the tests run.

A pair is two positions on simulated haplotypes (tools/ggsim's
`simulate_haplotypes`, walks through the graph). 7/8 of the pairs lie on
one haplotype, the second position a gap drawn uniformly from [0,
gap_max] after the first: the end of a read and the start of its mate.
1/8 are two positions drawn anywhere, on any haplotypes. Positions leave
room for a READ_LEN read ending at the first and one starting at the
second, so `write_gaf` can write each pair as two GAF records whose
dstats loci are the pair's.

  hap_coords    per haplotype, its node ids and their start offsets
  sample_pairs  (hap_a, pos_a, hap_b, pos_b) of n pairs
  loci          (node, offset) of haplotype positions
  write_gaf     the pairs as GAF records `p<i>/1` and `p<i>/2`
"""

from __future__ import annotations

import numpy as np

READ_LEN = 100


def hap_coords(graph, haps) -> list[tuple[np.ndarray, np.ndarray]]:
    """(node ids int64 [m], start offsets int64 [m + 1]) of each
    haplotype Path."""
    node_len = np.diff(graph.label_offsets).astype(np.int64)
    out = []
    for hap in haps:
        nodes = np.asarray(list(hap.get_nodes()), dtype=np.int64)
        starts = np.zeros(len(nodes) + 1, dtype=np.int64)
        np.cumsum(node_len[nodes - 1], out=starts[1:])
        out.append((nodes, starts))
    return out


def sample_pairs(coords, n: int, gap_max: int, seed: int,
                 read_len: int = READ_LEN) -> dict:
    """n pairs of haplotype positions: int64 arrays hap_a, pos_a, hap_b,
    pos_b. The first n - n // 8 lie on one haplotype with pos_b - pos_a
    uniform in [0, gap_max]; the last n // 8 are drawn independently."""
    rng = np.random.RandomState(seed)
    lens = np.asarray([s[-1] for _, s in coords], dtype=np.int64)
    # a read ends at pos_a and its mate starts at pos_b
    span = lens - gap_max - 2 * read_len + 1
    if (span <= 0).any():
        raise ValueError(f"a haplotype is shorter than the gap {gap_max} "
                         f"and two reads of {read_len}")
    n_rand = n // 8
    n_same = n - n_rand
    hap_a = rng.choice(len(coords), size=n, p=lens / lens.sum())
    pos_a = np.empty(n, dtype=np.int64)
    pos_a[:n_same] = (read_len - 1 + (rng.random_sample(n_same)
                      * span[hap_a[:n_same]]).astype(np.int64))
    hap_b = hap_a.copy()
    pos_b = pos_a.copy()
    pos_b[:n_same] += rng.randint(0, gap_max + 1, size=n_same)
    hap_b[n_same:] = rng.choice(len(coords), size=n_rand, p=lens / lens.sum())
    room = lens - 2 * read_len + 1
    pos_a[n_same:] = read_len - 1 + (rng.random_sample(n_rand)
                                     * room[hap_a[n_same:]]).astype(np.int64)
    pos_b[n_same:] = read_len - 1 + (rng.random_sample(n_rand)
                                     * room[hap_b[n_same:]]).astype(np.int64)
    return {"hap_a": hap_a.astype(np.int64), "pos_a": pos_a,
            "hap_b": hap_b.astype(np.int64), "pos_b": pos_b}


def _index(coords, hap, pos):
    """Index of the haplotype node holding each position, and that
    node's start offset."""
    idx = np.empty(len(pos), dtype=np.int64)
    base = np.empty(len(pos), dtype=np.int64)
    for h, (_, starts) in enumerate(coords):
        sel = np.nonzero(hap == h)[0]
        idx[sel] = np.searchsorted(starts, pos[sel], side="right") - 1
        base[sel] = starts[idx[sel]]
    return idx, base


def loci(coords, hap, pos) -> tuple[np.ndarray, np.ndarray]:
    """(node id, offset in the node) of each haplotype position."""
    idx, base = _index(coords, hap, pos)
    node = np.empty(len(pos), dtype=np.int64)
    for h, (nodes, _) in enumerate(coords):
        sel = hap == h
        node[sel] = nodes[idx[sel]]
    return node, pos - base


def write_gaf(graph, coords, pairs: dict, path: str, n: int,
              read_len: int = READ_LEN) -> None:
    """The first n pairs as GAF: `p<i>/1` a read of read_len ending at
    pos_a, `p<i>/2` one starting at pos_b, each along its haplotype's
    nodes (forward, by coordinate id), all bases matching."""
    coord_ids = np.asarray(graph.coord_ids, dtype=np.int64)
    segs = [[f">{c}" for c in coord_ids[nodes - 1]] for nodes, _ in coords]
    with open(path, "w") as fh:
        for mate, hap, start in (
                ("1", pairs["hap_a"][:n], pairs["pos_a"][:n] - read_len + 1),
                ("2", pairs["hap_b"][:n], pairs["pos_b"][:n])):
            first, base = _index(coords, hap, start)
            last, _ = _index(coords, hap, start + read_len - 1)
            lines = []
            for i in range(n):
                h, a, b = int(hap[i]), int(first[i]), int(last[i])
                starts = coords[h][1]
                plen = int(starts[b + 1] - starts[a])
                ps = int(start[i] - base[i])
                lines.append(
                    f"p{i}/{mate}\t{read_len}\t0\t{read_len}\t+\t"
                    f"{''.join(segs[h][a:b + 1])}\t{plen}\t{ps}\t"
                    f"{ps + read_len}\t{read_len}\t{read_len}\t60\n")
            fh.writelines(lines)
