"""dindexctl — distance-index operations
(parity with ref: tools/src/dindexctl.cpp: build/compress with optional
verification by sampled re-query, merge two indexes over different
(dmin, dmax) ranges, stats). A copy of psi_tpu's tool over this
package's DistanceIndex: the artifacts are interchangeable, and
PSI_DINDEX_BUILD=device builds on the card.

    python -m psi_tpu_torch.tools.dindexctl build GRAPH -m 250 -M 450 \
        -o dist.npz [--verify N] [--whole]
    python -m psi_tpu_torch.tools.dindexctl merge A.npz B.npz -o AB.npz \
        [--verify N --graph GRAPH]
    python -m psi_tpu_torch.tools.dindexctl stats dist.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dindexctl", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a distance index from a graph")
    b.add_argument("graph")
    b.add_argument("-m", "--min-distance", type=int, required=True)
    b.add_argument("-M", "--max-distance", type=int, default=0)
    b.add_argument("-o", "--output", required=True)
    b.add_argument("--whole", action="store_true",
                   help="whole-graph mode (default: per-component)")
    b.add_argument("--verify", type=int, default=0, metavar="N",
                   help="verify with N sampled queries against BFS ground truth")

    m = sub.add_parser("merge")
    m.add_argument("first")
    m.add_argument("second")
    m.add_argument("-o", "--output", required=True)
    m.add_argument("--verify", type=int, default=0, metavar="N",
                   help="verify the merged index with N sampled "
                        "re-queries against BFS ground truth "
                        "(ref dindexctl's sampled verification)")
    m.add_argument("--graph", default=None,
                   help="graph for --verify (required with it)")

    s = sub.add_parser("stats")
    s.add_argument("index")

    args = p.parse_args(argv)

    from psi_tpu_torch.dindex import DistanceIndex

    if args.cmd == "build":
        from psi_tpu_torch.io import load_graph

        graph = load_graph(args.graph)
        dmin = args.min_distance
        dmax = args.max_distance or dmin
        idx = DistanceIndex.build(graph, dmin, dmax,
                                  per_component=not args.whole)
        idx.save(args.output)
        print(f"built: {idx.stats()}", file=sys.stderr)
        if args.verify:
            ok = _verify_sampled(graph, idx, args.verify)
            print(f"verification: {'PASS' if ok else 'FAIL'}", file=sys.stderr)
            return 0 if ok else 2
        return 0

    if args.cmd == "merge":
        a = DistanceIndex.load(args.first)
        b_ = DistanceIndex.load(args.second)
        merged = a.merge(b_)
        merged.save(args.output)
        print(f"merged: {merged.stats()}", file=sys.stderr)
        if args.verify:
            if not args.graph:
                print("--verify needs --graph", file=sys.stderr)
                return 2
            from psi_tpu_torch.io import load_graph

            graph = load_graph(args.graph)
            ok = _verify_sampled(graph, merged, args.verify)
            print(f"verification: {'PASS' if ok else 'FAIL'}",
                  file=sys.stderr)
            return 0 if ok else 2
        return 0

    if args.cmd == "stats":
        idx = DistanceIndex.load(args.index)
        for key, val in idx.stats().items():
            print(f"{key}: {val}")
        return 0

    return 1


def _verify_sampled(graph, idx, n_samples: int, seed: int = 0) -> bool:
    """Sampled cross-check against a char-level BFS oracle."""
    rng = np.random.RandomState(seed)
    node_len = np.diff(graph.label_offsets)
    ok = True
    for _ in range(n_samples):
        v = int(rng.randint(1, graph.node_count + 1))
        o = int(rng.randint(0, node_len[v - 1]))
        # BFS over loci up to dmax steps
        reach = {}
        frontier = [(v, o)]
        for d in range(1, idx.dmax + 1):
            nxt = []
            for nid, off in frontier:
                if off + 1 < node_len[nid - 1]:
                    nxt.append((nid, off + 1))
                else:
                    for w in graph.out_neighbors(nid):
                        nxt.append((int(w), 0))
            frontier = list(set(nxt))
            for pos in frontier:
                reach.setdefault(pos, d)
        # sample a few targets
        targets = list(reach.items())
        rng.shuffle(targets)
        for (u, pp), d in targets[:10]:
            expect = idx.dmin <= d <= idx.dmax
            got = idx.verify(graph, v, o, u, pp)
            # ambiguity: multiple distances may reach the same locus; the
            # index is an OR over distances, so only check positives
            if expect and not got:
                print(
                    f"MISMATCH: ({v},{o})->({u},{pp}) d={d} expect True",
                    file=sys.stderr,
                )
                ok = False
    return ok


if __name__ == "__main__":
    sys.exit(main())
