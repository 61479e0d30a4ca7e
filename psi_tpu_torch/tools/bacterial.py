"""The bacterial pan-genome cell that chip_smoke.py runs on, made from
fixed seeds.

A graph from `simulate.make_pangenome_graph(REF_LEN, VARIANT_RATE,
seed=GRAPH_SEED)` (an E. coli-sized reference with a SNP or insertion
bubble about every 250 bp) written as GFA 1, and N_CHUNKS x CHUNK reads
of READ_LEN bp from random haplotypes with ERROR_RATE substitutions as
FASTQ. `first_chunk_index` indexes the first chunk and plans its trie;
`lf_steps` replays the gather route's LF steps over the dense occ table.
"""

from __future__ import annotations

import os
import time

REF_LEN = 5_000_000
VARIANT_RATE = 0.004
GRAPH_SEED = 1
READ_LEN = 100
ERROR_RATE = 0.01
N_CHUNKS = 3
CHUNK = 100_000
SEED_LEN = 20
N_PATHS = 2


def write_gfa(graph, path: str) -> None:
    """GFA 1 (S, L, P lines) of a forward-only Graph."""
    coords = graph.coord_ids
    loff = graph.label_offsets
    labels = graph.labels.tobytes().decode("ascii")
    indptr = graph.out_indptr
    with open(path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for r in range(graph.node_count):
            fh.write(f"S\t{coords[r]}\t{labels[loff[r]:loff[r + 1]]}\n")
        for r in range(graph.node_count):
            for v in graph.out_indices[indptr[r]:indptr[r + 1]]:
                fh.write(f"L\t{coords[r]}\t+\t{coords[v - 1]}\t+\t0M\n")
        for name, nodes in graph.paths:
            segs = ",".join(f"{coords[v - 1]}+" for v in nodes)
            fh.write(f"P\t{name}\t{segs}\t*\n")


def write_reads(haps, path: str, n: int, seed: int) -> None:
    """n reads of READ_LEN from the haplotypes (uniform over positions),
    each base substituted with probability ERROR_RATE, as FASTQ."""
    import numpy as np

    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    code = np.zeros(256, dtype=np.int64)
    code[bases] = np.arange(4)
    seqs = [np.frombuffer(h.encode("ascii"), dtype=np.uint8) for h in haps]
    spans = np.array([len(s) - READ_LEN + 1 for s in seqs], dtype=np.int64)
    which = rng.choice(len(seqs), size=n, p=spans / spans.sum())
    reads = np.empty((n, READ_LEN), dtype=np.uint8)
    for i, s in enumerate(seqs):
        sel = np.nonzero(which == i)[0]
        starts = rng.randint(0, spans[i], size=len(sel))
        reads[sel] = s[starts[:, None] + np.arange(READ_LEN)]
    mutate = rng.random_sample(reads.shape) < ERROR_RATE
    shifted = bases[(code[reads] + rng.randint(1, 4, size=reads.shape)) % 4]
    reads = np.where(mutate, shifted, reads)
    qual = b"I" * READ_LEN
    with open(path, "wb") as fh:
        for i in range(n):
            fh.write(b"@r%d\n%s\n+\n%s\n" % (i, reads[i].tobytes(), qual))


def make_data(tmp: str, ref_len: int, n_reads: int,
              variant_rate: float = VARIANT_RATE,
              prefix: str = "") -> tuple[str, str]:
    """Write the cell's graph and reads into `tmp`, their file names
    starting with `prefix`: (GFA path, FASTQ path). Another variant rate
    makes another cell from the same seeds (tools/dense.py)."""
    from psi_tpu_torch.pathutil import sequence
    from psi_tpu_torch.simulate import make_pangenome_graph
    from psi_tpu_torch.tools.ggsim import simulate_haplotypes

    graph = make_pangenome_graph(ref_len, variant_rate, seed=GRAPH_SEED)
    gfa = os.path.join(tmp, f"{prefix}pangenome.gfa")
    write_gfa(graph, gfa)
    haps = [sequence(h) for _, h in simulate_haplotypes(graph, 4, seed=7)]
    fastq = os.path.join(tmp, f"{prefix}reads.fastq")
    write_reads(haps, fastq, n_reads, seed=11)
    return gfa, fastq


def first_chunk_index(finder, fastq: str, chunk: int):
    """Seeds and k-mer index of the first `chunk` reads, with the ftab
    built and the chunk's trie planned (printing both times): (reads,
    seeds, index)."""
    from psi_tpu_torch.io.fastq import FastxStream
    from psi_tpu_torch.records import Records

    names, packed = FastxStream(fastq).read_chunk_packed(chunk)
    reads = Records(names, rec_offset=0, packed=packed)
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)
    t0 = time.monotonic()
    finder._get_ftab()
    print(f"[prepare] ftab (4^p SA ranges, once per index): "
          f"{time.monotonic() - t0:.4f} s", flush=True)
    t0 = time.monotonic()
    finder.prepare_onpath(index)
    print(f"[prepare] trie plan (schedule + padding + upload) of chunk 1: "
          f"{time.monotonic() - t0:.4f} s", flush=True)
    return reads, seeds, index


def lf_steps(arrays, codes, p: int) -> tuple[list, tuple]:
    """The gather route's LF steps over the dense occ table of `arrays`
    (ops/fm.FMArrays with its ftab) for code rows [N, k], replayed with
    the plain version: the (chars, lo, hi) that each step after the
    ftab's p columns takes, and the final (lo, hi). After the first step
    the positions scatter over the text."""
    import torch

    from psi_tpu_torch.ops import fm_pallas

    dev = codes.device
    weights = 4 ** torch.arange(p - 1, -1, -1, device=dev)
    start = arrays.ftab[((codes[:, :p].long() - 1) * weights).sum(dim=1)]
    lo, hi = start[:, 0].contiguous(), start[:, 1].contiguous()
    steps = []
    for c in codes[:, p:].t().contiguous():
        steps.append((c, lo, hi))
        lo, hi = fm_pallas.lf_pair_plain(arrays.occ_dense, arrays.C, c, lo, hi)
    return steps, (lo, hi)
