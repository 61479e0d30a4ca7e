"""sloci — starting-loci file converter/inspector
(parity with ref: tools/src/sloci.cpp: convert between the binary loci
artifact and text/TSV; inspect counts). A copy of psi_tpu's tool: the
loci artifact (PREFIX_loci_e<step>l<k>.npy) is the same file in both
packages.

    python -m psi_tpu_torch.tools.sloci export LOCI.npy [-o TSV] [--rc-base B]
    python -m psi_tpu_torch.tools.sloci import TSV -o LOCI[.npy]
    python -m psi_tpu_torch.tools.sloci info LOCI.npy
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sloci", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    exp = sub.add_parser("export", help="loci artifact -> TSV")
    exp.add_argument("input", help=".npy loci artifact")
    exp.add_argument("-o", "--output", default="-")
    exp.add_argument(
        "--rc-base", type=int, default=0,
        help="graph rc_base of a node-doubled bidirected input: loci on "
        "reverse twins (id >= rc_base) export as forward id + strand "
        "column (the artifact itself stores the synthetic twin ids; "
        "vg is_reverse semantics, ref: vg/vg.proto:29-34)",
    )

    imp = sub.add_parser("import", help="TSV -> loci artifact")
    imp.add_argument("input", help="TSV with node_id<TAB>offset rows")
    imp.add_argument("-o", "--output", required=True)

    info = sub.add_parser("info")
    info.add_argument("input")

    args = p.parse_args(argv)

    if args.cmd == "export":
        arr = np.load(args.input)
        out = sys.stdout if args.output == "-" else open(args.output, "w")
        rcb = args.rc_base
        for nid, off in arr:
            if rcb:
                strand = "-" if nid >= rcb else "+"
                fwd = nid - rcb if nid >= rcb else nid
                out.write(f"{fwd}\t{off}\t{strand}\n")
            else:
                out.write(f"{nid}\t{off}\n")
        if out is not sys.stdout:
            out.close()
        return 0

    if args.cmd == "import":
        rows = []
        with (sys.stdin if args.input == "-" else open(args.input)) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                nid, off = line.split()[:2]
                rows.append((int(nid), int(off)))
        np.save(
            args.output if args.output.endswith(".npy") else args.output + ".npy",
            np.asarray(rows, dtype=np.int64).reshape(-1, 2),
        )
        return 0

    if args.cmd == "info":
        arr = np.load(args.input)
        nodes = set(arr[:, 0].tolist()) if len(arr) else set()
        print(f"loci: {len(arr)}")
        print(f"nodes: {len(nodes)}")
        if len(arr):
            print(f"node id range: [{arr[:, 0].min()}, {arr[:, 0].max()}]")
            print(f"max offset: {arr[:, 1].max()}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
