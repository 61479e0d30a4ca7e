"""Frozen input generators: the pan-genome graph, its haplotypes, the GFA
and the reads, made from seeds.

Copies of the generators that psi_tpu_torch's tools use today
(`simulate.make_pangenome_graph`, `tools/ggsim.simulate_haplotypes`,
`tools/bacterial.write_gfa` and `write_reads`), kept here so that a later
change to the program's copies cannot change the benchmark's inputs. At
the same seeds they write the same bytes (tests/test_seedbench_gen.py).
Plain NumPy; nothing of the program is imported.

The graph is a linear reference cut at variant sites into segments,
with a biallelic bubble at each site (a SNP, or an insertion of one base
with probability `indel_frac`) and one reference path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class PanGraph:
    """Nodes 1..N in id order, edges in the order they were made, and
    the reference path; `bubbles` lists, per variant site, the ids of its
    reference and alternative allele nodes, in path order."""
    labels: list          # [N] str, node i + 1's label
    edges: np.ndarray     # [E, 2] int64 (from id, to id)
    path: list            # node ids of the reference path
    bubbles: np.ndarray   # [B, 2] int64 (ref id, alt id)
    segments: list        # [(id or 0, label)] in path order, 0 = bubble

    @property
    def node_count(self) -> int:
        return len(self.labels)


def make_pangenome_graph(ref_len: int, variant_rate: float,
                         indel_frac: float = 0.2, seed: int = 0) -> PanGraph:
    """One component: a random reference of ref_len bases with a bubble
    about every 1 / variant_rate bases (the draws of the program's
    simulate.make_pangenome_graph with n_components = 1)."""
    rng = np.random.RandomState(seed)
    ref = rng.choice(BASES, size=ref_len).tobytes().decode("ascii")
    n_var = min(int(rng.poisson(ref_len * variant_rate)), ref_len // 4)
    keep = []
    if n_var > 0:
        var_pos = np.sort(rng.choice(np.arange(1, ref_len - 1), size=n_var,
                                     replace=False))
        for p in var_pos:
            if not keep or p > keep[-1] + 1:
                keep.append(int(p))
    labels, edges, path, bubbles, order = [], [], [], [], []
    tails = []

    def node(label):
        labels.append(label)
        return len(labels)

    cursor = 0
    for p in keep + [None]:
        seg = ref[cursor:p] if p is not None else ref[cursor:]
        if seg:
            nid = node(seg)
            edges.extend((t, nid) for t in tails)
            tails = [nid]
            path.append(nid)
            order.append((nid, seg))
        if p is None:
            break
        ref_allele = ref[p]
        if rng.random_sample() < indel_frac:
            alt = ref_allele + "ACGT"[rng.randint(4)]
        else:
            alt = "ACGT"[("ACGT".index(ref_allele) + 1 + rng.randint(3)) % 4]
        r_id = node(ref_allele)
        a_id = node(alt)
        for t in tails:
            edges.append((t, r_id))
            edges.append((t, a_id))
        tails = [r_id, a_id]
        path.append(r_id)
        bubbles.append((r_id, a_id))
        order.append((0, ""))
        cursor = p + 1
    return PanGraph(labels, np.asarray(edges, dtype=np.int64).reshape(-1, 2),
                    path, np.asarray(bubbles, dtype=np.int64).reshape(-1, 2),
                    order)


def write_gfa(g: PanGraph, path: str) -> None:
    """GFA 1: S lines in id order, L lines grouped by source id in the
    order the edges were made, the P line."""
    order = np.argsort(g.edges[:, 0], kind="stable")
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        fh.writelines(f"S\t{i + 1}\t{lab}\n" for i, lab in enumerate(g.labels))
        fh.writelines(f"L\t{a}\t+\t{b}\t+\t0M\n"
                      for a, b in g.edges[order].tolist())
        segs = ",".join(f"{v}+" for v in g.path)
        fh.write(f"P\tref0\t{segs}\t*\n")


def simulate_haplotypes(g: PanGraph, ploidy: int, seed: int) -> list:
    """`ploidy` uniform random walks from the path's first node, drawn
    from one RandomState(seed): at every bubble the walk takes the
    reference allele on 0 and the alternative on 1 (a node's out-edges
    list the reference allele first). Returns the haplotypes' sequences."""
    rng = np.random.RandomState(seed)
    haps = []
    for _ in range(ploidy):
        pick = rng.randint(0, 2, size=len(g.bubbles)) if len(g.bubbles) else []
        parts, b = [], 0
        for nid, seg in g.segments:
            if nid:
                parts.append(seg)
            else:
                parts.append(g.labels[g.bubbles[b, pick[b]] - 1])
                b += 1
        haps.append("".join(parts))
    return haps


def draw_reads(haps: list, n: int, read_len: int, error_rate: float,
               seed: int) -> np.ndarray:
    """n reads [n, read_len] uint8 (ASCII) drawn uniformly over the
    haplotypes' positions, each base substituted with probability
    error_rate by one of the three others."""
    rng = np.random.RandomState(seed)
    code = np.zeros(256, dtype=np.int64)
    code[BASES] = np.arange(4)
    seqs = [np.frombuffer(h.encode("ascii"), dtype=np.uint8) for h in haps]
    spans = np.array([len(s) - read_len + 1 for s in seqs], dtype=np.int64)
    which = rng.choice(len(seqs), size=n, p=spans / spans.sum())
    reads = np.empty((n, read_len), dtype=np.uint8)
    for i, s in enumerate(seqs):
        sel = np.nonzero(which == i)[0]
        starts = rng.randint(0, spans[i], size=len(sel))
        reads[sel] = s[starts[:, None] + np.arange(read_len)]
    mutate = rng.random_sample(reads.shape) < error_rate
    shifted = BASES[(code[reads] + rng.randint(1, 4, size=reads.shape)) % 4]
    return np.where(mutate, shifted, reads)


def write_fastq(reads: np.ndarray, path: str) -> None:
    """FASTQ records @r<i> with quality 'I' throughout."""
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as fh:
        fh.writelines(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), qual)
                      for i, r in enumerate(reads))


def derive_seeds(seed: int, n: int = 3) -> list:
    """n independent 32-bit seeds from a run's --seed (any whole number)."""
    return [int(s) for s in
            np.random.SeedSequence(abs(int(seed))).generate_state(n)]
