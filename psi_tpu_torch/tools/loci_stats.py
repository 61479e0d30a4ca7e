"""loci_stats — starting-loci inspector
(parity with ref: tools/src/loci_stats.cpp: prints list/count for an
index prefix, filtered by node range). A copy of psi_tpu's tool over
this package's SeedFinder.get_sloci_filepath; no device work.

    python -m psi_tpu_torch.tools.loci_stats PREFIX -l K [-e STEP] [-c]
        [--min-node A] [--max-node B] [--rc-base B]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="loci_stats", description=__doc__)
    p.add_argument("prefix", help="path index prefix")
    p.add_argument("-l", "--seed-length", type=int, required=True)
    p.add_argument("-e", "--step-size", type=int, default=1)
    p.add_argument("--min-node", type=int, default=0)
    p.add_argument("--max-node", type=int, default=0)
    p.add_argument("-c", "--count-only", action="store_true")
    p.add_argument(
        "--rc-base", type=int, default=0,
        help="graph rc_base of a node-doubled bidirected input: print "
        "loci on reverse twins as forward id + strand column",
    )
    args = p.parse_args(argv)

    from psi_tpu_torch.seed_finder import SeedFinder

    path = SeedFinder.get_sloci_filepath(
        args.prefix, args.seed_length, args.step_size
    ) + ".npy"
    try:
        arr = np.load(path)
    except FileNotFoundError:
        print(f"error: no starting loci file at {path}", file=sys.stderr)
        return 1

    sel = np.ones(len(arr), dtype=bool)
    if args.min_node:
        sel &= arr[:, 0] >= args.min_node
    if args.max_node:
        sel &= arr[:, 0] <= args.max_node
    arr = arr[sel]

    if args.count_only:
        print(len(arr))
        return 0
    for nid, off in arr:
        if args.rc_base:
            strand = "-" if nid >= args.rc_base else "+"
            fwd = nid - args.rc_base if nid >= args.rc_base else nid
            print(f"{fwd}\t{off}\t{strand}")
        else:
            print(f"{nid}\t{off}")
    print(f"# total: {len(arr)} loci in {len(set(arr[:, 0].tolist()))} nodes",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
