"""ggsim — graph-genome haplotype and read simulator
(functional parity with ref: tools/src/ggsim.cpp).

Simulates `ploidy` random haplotypes per reference path (uniform random
walk, ref: ggsim.cpp:21-43), then draws reads distributed over
haplotypes proportionally to length (ref: reads_dist, ggsim.cpp:53-82),
with substitution/indel errors. Read names carry the truth origin
(haplotype, position) for downstream precision/recall analysis (alice).

A copy of psi_tpu's tool: the haplotype walks and the reads draw from
`np.random.RandomState(seed)` in psi_tpu's order, so a run with `-S`
writes the bytes psi_tpu's writes. Host only.

    python -m psi_tpu_torch.tools.ggsim GRAPH -o OUT -t {plain,fastq,fasta,
        gam,haplotypes} [-p PLOIDY] [-l LEN] [-n N] [-e ERR] [-i INDEL]
        [-d DIST -s SD] [-S SEED] [-f] [-N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from psi_tpu_torch.graphiter import HaplotyperRandomIter
from psi_tpu_torch.pathutil import Path, sequence


def simulate_haplotypes(graph, ploidy: int, seed: int):
    """Yield (name, Path) random haplotypes, one walk per ploidy per
    reference path."""
    out = []
    for path_rank, (name, nodes) in graph.for_each_path():
        itr = HaplotyperRandomIter(graph, int(nodes[0]), seed=seed or None and seed)
        itr.rng = np.random.RandomState(seed if seed else None)
        for i in range(ploidy):
            hap = Path(graph)
            while not itr.at_end():
                hap.push_back(itr.value)
                itr.next()
            itr.finish()
            out.append((f"{name}-{i + 1}", hap))
    return out


def reads_dist(hap_lengths, readlen: int, numreads: int, span: int):
    """Distribute reads over haplotypes proportional to length
    (ref: ggsim.cpp:53-82)."""
    genome_size = sum(l for l in hap_lengths if l >= span)
    dist = []
    for l in hap_lengths:
        dist.append(numreads * l // genome_size if l >= span else 0)
    extra = numreads - sum(dist)
    i = 0
    while extra > 0 and i < len(dist):
        if hap_lengths[i] >= span:
            dist[i] += 1
            extra -= 1
        i += 1
    return dist


_COMP = str.maketrans("ACGTN", "TGCAN")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def impose_error(frag: str, rng, errorrate: float, indelrate: float) -> str:
    if errorrate <= 0:
        return frag
    out = []
    bases = "ACGT"
    i = 0
    n = len(frag)
    while i < n:
        c = frag[i]
        if rng.random_sample() < errorrate:
            if rng.random_sample() < indelrate:
                if rng.random_sample() < 0.5 or i == n - 1:  # insertion
                    out.append(bases[rng.randint(4)])
                    continue  # do not consume the source base
                else:  # deletion
                    i += 1
                    if i < n:
                        out.append(frag[i])
                    i += 1
                    continue
            alt = bases[rng.randint(4)]
            if alt == c:
                alt = bases[(bases.index(alt) + 1) % 4]
            out.append(alt)
        else:
            out.append(c)
        i += 1
    return "".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ggsim", description=__doc__)
    p.add_argument("graph", help="graph file (vg or gfa)")
    p.add_argument("-o", "--output", default="-")
    p.add_argument(
        "-t", "--type",
        choices=["plain", "fastq", "fasta", "gam", "haplotypes"],
        default="fastq",
    )
    p.add_argument("-p", "--ploidy", type=int, default=2)
    p.add_argument("-l", "--read-length", type=int, default=100)
    p.add_argument("-n", "--num-reads", type=int, default=1000)
    p.add_argument("-e", "--error-rate", type=float, default=0.0)
    p.add_argument("-i", "--indel-rate", type=float, default=0.0)
    p.add_argument(
        "-d", "--distance", type=int, default=0,
        help="outer distance between ends (implies paired-end)",
    )
    p.add_argument("-s", "--std-deviation", type=int, default=0)
    p.add_argument("-S", "--random-seed", type=int, default=0)
    p.add_argument("-f", "--forward-only", action="store_true")
    p.add_argument("-N", "--allow-Ns", action="store_true")
    args = p.parse_args(argv)

    from psi_tpu_torch.io import load_graph

    graph = load_graph(args.graph)
    rng = np.random.RandomState(args.random_seed if args.random_seed else None)
    haps = simulate_haplotypes(graph, args.ploidy, args.random_seed)

    out = sys.stdout if args.output == "-" else open(args.output, "w")

    if args.type == "haplotypes":
        for name, hap in haps:
            out.write(f">{name}\n{sequence(hap)}\n")
        if out is not sys.stdout:
            out.close()
        return 0

    paired = args.distance > 0
    readlen = args.read_length
    span = (
        args.distance if paired else readlen
    )
    seqs = [(name, sequence(hap)) for name, hap in haps]
    dist = reads_dist([len(s) for _, s in seqs], readlen, args.num_reads, span)

    gam_records = []
    hap_by_name = dict(haps)

    def truth_path(hname, pos, length):
        """(node, offset) mappings of [pos, pos+length) on the haplotype."""
        hap = hap_by_name[hname]
        rnk = hap.rank(pos)
        out_nodes = []
        covered = 0
        off0 = pos - hap.select(rnk)
        while covered < length and rnk < hap.size():
            nid = hap.get_nodes()[rnk]
            off = off0 if not out_nodes else 0
            out_nodes.append((hap.graph.coordinate_id(nid), off))
            covered += hap.graph.node_length(nid) - off
            rnk += 1
        return out_nodes

    def emit(name, seq, hname=None, pos=None):
        if args.type == "fastq":
            out.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
        elif args.type == "fasta":
            out.write(f">{name}\n{seq}\n")
        elif args.type == "gam":
            from psi_tpu_torch.io.vgio import encode_vg_alignment

            pathm = (
                truth_path(hname, pos, len(seq))
                if hname is not None
                else []
            )
            gam_records.append(
                encode_vg_alignment(name, seq, pathm, identity=1.0)
            )
        else:
            out.write(f"{seq}\n")

    ridx = 0
    for (hname, hseq), count in zip(seqs, dist):
        L = len(hseq)
        for _ in range(count):
            pos = rng.randint(0, L - span + 1)
            fwd = args.forward_only or rng.random_sample() < 0.5
            if paired:
                frag = hseq[pos: pos + args.distance]
                r1 = frag[:readlen]
                r2 = revcomp(frag[-readlen:])
                if not args.allow_Ns and ("N" in r1 or "N" in r2):
                    continue
                r1 = impose_error(r1, rng, args.error_rate, args.indel_rate)
                r2 = impose_error(r2, rng, args.error_rate, args.indel_rate)
                base = f"read{ridx}_{hname}_{pos}"
                emit(base + "/1", r1 if fwd else revcomp(r1), hname, pos)
                emit(
                    base + "/2", r2 if fwd else revcomp(r2), hname,
                    pos + args.distance - readlen,
                )
            else:
                r = hseq[pos: pos + readlen]
                if not args.allow_Ns and "N" in r:
                    continue
                r = impose_error(r, rng, args.error_rate, args.indel_rate)
                emit(
                    f"read{ridx}_{hname}_{pos}", r if fwd else revcomp(r),
                    hname, pos,
                )
            ridx += 1
    if args.type == "gam":
        from psi_tpu_torch.io.vgio import write_gam

        if args.output == "-":
            print("error: GAM output requires -o FILE", file=sys.stderr)
            return 1
        if out is not sys.stdout:
            out.close()
        write_gam(args.output, gam_records)
        return 0
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
