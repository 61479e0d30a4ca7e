"""Haplotype simulation from psi_tpu's ggsim tool (functional parity with
ref: tools/src/ggsim.cpp:21-43): `simulate_haplotypes`, which
chip_smoke.py uses to draw reads. The read simulator and the CLI stay in
psi_tpu.tools.ggsim.
"""

from __future__ import annotations

import numpy as np

from psi_tpu_torch.graphiter import HaplotyperRandomIter
from psi_tpu_torch.pathutil import Path


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
