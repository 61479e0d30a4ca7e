"""The dense pan-genome cell: the off-path traversal at 10^5-10^6 loci,
where the WalkTree no longer fits its cap (2^23 nodes) and the frontier
traversal `traverse_device` is the route. Made from fixed seeds like the
bacterial cell (tools/bacterial.py), whose writers and read model it
shares.

A graph from `simulate.make_pangenome_graph(REF_LEN, VARIANT_RATE,
seed=GRAPH_SEED)`: a 5 Mbp reference with a SNP or insertion bubble about
every 50 bp, the variant density of a dense pan-genome (within 2x of a
human chromosome's loci per bp), written as GFA 1; `-n 2 -P` indexes 2
paths and k = 20. Reads: one chunk of CHUNK reads of 100 bp with 1%
substitutions, as in the bacterial cell. SCALE_REF_LEN and
SCALE_VARIANT_RATE make the 10^6-loci point, which runs the traversal
only: `offpath_inputs` gives the loci and one chunk's seeds index without
building an FM index.
"""

from __future__ import annotations

from psi_tpu_torch.tools.bacterial import CHUNK, N_PATHS, SEED_LEN, make_data

REF_LEN = 5_000_000
VARIANT_RATE = 0.02
SCALE_REF_LEN = 10_000_000
SCALE_VARIANT_RATE = 0.03


def make_dense(tmp: str, ref_len: int = REF_LEN,
               variant_rate: float = VARIANT_RATE,
               n_reads: int = CHUNK) -> tuple[str, str]:
    """Write a dense cell's graph and reads into `tmp`: (GFA path, FASTQ
    path), named after the reference length."""
    return make_data(tmp, ref_len, n_reads, variant_rate=variant_rate,
                     prefix=f"dense{ref_len}_")


def offpath_inputs(gfa: str, fastq: str, device, n_reads: int = CHUNK):
    """A SeedFinder on `device` over the GFA with the CLI's starting loci
    (N_PATHS paths picked unpatched, as `-n 2 -P` picks them, and the
    port's uncovered-loci scan; no FM index is built) and the seeds index
    of the first `n_reads` reads: (finder, index)."""
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.io.fastq import FastxStream
    from psi_tpu_torch.records import Records
    from psi_tpu_torch.seed_finder import SeedFinder

    finder = SeedFinder(load_graph(gfa), SEED_LEN, device=device)
    finder.pick_paths(N_PATHS, patched=False)
    finder.add_uncovered_loci(1)
    names, packed = FastxStream(fastq).read_chunk_packed(n_reads)
    reads = Records(names, rec_offset=0, packed=packed)
    return finder, finder.index_reads(finder.get_seeds(reads))
