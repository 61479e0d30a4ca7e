"""pindexctl — path-index inspector/exporter
(parity with ref: tools/src/pindexctl.cpp).

Subcommands:
  inspect   #paths, total sequence length, context, #uncovered vs total loci
  to-fasta  export indexed path sequences
  to-vg     export the induced subgraph of the indexed paths as a vg file,
            optionally marking starting loci
  to-gam    export the indexed paths as GAM, the starting loci as SNP edits

A copy of psi_tpu's tool over this package's SeedFinder; a path index
written by either package loads in both. Each SeedFinder is made on
`--device` (the card unless `--device cpu`; without a GPU `cuda` raises,
it never falls back). The tool itself runs no device work: a missing
loci artifact is rebuilt on the host (native uncovered-loci scan) and
saved.

    python -m psi_tpu_torch.tools.pindexctl inspect GRAPH -I PREFIX -l K
    python -m psi_tpu_torch.tools.pindexctl to-fasta GRAPH -I PREFIX [-o FA]
    python -m psi_tpu_torch.tools.pindexctl to-vg GRAPH -I PREFIX -o OUT.vg
    python -m psi_tpu_torch.tools.pindexctl to-gam GRAPH -I PREFIX -o OUT.gam
        [-l K [-L]]
"""

from __future__ import annotations

import argparse
import sys

from psi_tpu_torch.device import CHOICES


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pindexctl", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ins = sub.add_parser("inspect")
    ins.add_argument("graph")
    ins.add_argument("-I", "--path-index", required=True)
    ins.add_argument("-l", "--seed-length", type=int, required=True)
    ins.add_argument("-e", "--step-size", type=int, default=1)

    fa = sub.add_parser("to-fasta")
    fa.add_argument("graph")
    fa.add_argument("-I", "--path-index", required=True)
    fa.add_argument("-o", "--output", default="-")

    vg = sub.add_parser("to-vg")
    vg.add_argument("graph")
    vg.add_argument("-I", "--path-index", required=True)
    vg.add_argument("-o", "--output", required=True)
    vg.add_argument("-l", "--seed-length", type=int, default=0)
    vg.add_argument("-e", "--step-size", type=int, default=1)

    gam = sub.add_parser("to-gam", help="export indexed paths as GAM")
    gam.add_argument("graph")
    gam.add_argument("-I", "--path-index", required=True)
    gam.add_argument("-o", "--output", required=True)
    gam.add_argument(
        "-l", "--seed-length", type=int, default=0,
        help="load starting loci for this seed length and mark them",
    )
    gam.add_argument("-e", "--step-size", type=int, default=1)
    gam.add_argument(
        "-L", "--no-loci", action="store_true",
        help="do not include starting loci as SNP edits "
        "(ref: pindexctl.cpp:49)",
    )

    for sp in (ins, fa, vg, gam):
        sp.add_argument(
            "--device", choices=CHOICES, default="cuda",
            help="device of the SeedFinder (cuda fails without a GPU)",
        )

    args = p.parse_args(argv)

    from psi_tpu_torch.device import resolve
    from psi_tpu_torch.io import load_graph
    from psi_tpu_torch.pathutil import sequence
    from psi_tpu_torch.seed_finder import SeedFinder

    device = resolve(args.device)
    graph = load_graph(args.graph)

    if args.cmd == "inspect":
        finder = SeedFinder(graph, args.seed_length, device=device)
        if not finder.load_path_index(
            args.path_index, step_size=args.step_size
        ):
            print("error: cannot load path index", file=sys.stderr)
            return 1
        pset = finder.pindex.get_paths_set()
        total_len = sum(p.get_sequence_len() for p in pset)
        print(f"number of paths: {len(pset)}")
        print(f"total sequence length: {total_len}")
        print(f"context: {finder.pindex.get_context()}")
        print(
            f"uncovered loci: {len(finder.get_starting_loci())}"
            f" / {graph.total_nof_loci()}"
        )
        print(f"uncovered unique nodes: {finder.get_nof_uniq_nodes()}")
        return 0

    if args.cmd == "to-fasta":
        finder = SeedFinder(graph, 1, device=device)
        finder.pindex.set_context(0)
        if not finder.pindex.load(args.path_index):
            print("error: cannot load path index", file=sys.stderr)
            return 1
        out = sys.stdout if args.output == "-" else open(args.output, "w")
        for i, path in enumerate(finder.pindex.get_paths_set()):
            out.write(f">path{i}\n{sequence(path)}\n")
        if out is not sys.stdout:
            out.close()
        return 0

    if args.cmd == "to-vg":
        from psi_tpu_torch.io.vgio import encode_vg_graph, write_vg

        finder = SeedFinder(graph, args.seed_length or 1, device=device)
        if not finder.load_path_index(
            args.path_index, step_size=args.step_size
        ):
            print("error: cannot load path index", file=sys.stderr)
            return 1
        # induced subgraph: nodes on any indexed path + edges among
        # consecutive path nodes (ref: induced_graph of path sets,
        # path_interface.hpp:944-1005)
        nodes = {}
        edges = set()
        for path in finder.pindex.get_paths_set():
            pn = path.get_nodes()
            for nid in pn:
                nodes[graph.coordinate_id(nid)] = graph.node_sequence(nid)
            for a, b in zip(pn, pn[1:]):
                edges.add((graph.coordinate_id(a), graph.coordinate_id(b)))
        msg = encode_vg_graph(
            sorted(nodes.items()), sorted(edges), []
        )
        write_vg(args.output, [msg])
        print(
            f"wrote induced subgraph: {len(nodes)} nodes, {len(edges)} edges",
            file=sys.stderr,
        )
        return 0

    if args.cmd == "to-gam":
        from psi_tpu_torch.io.vgio import encode_vg_alignment, write_gam
        from psi_tpu_torch.pathutil import convert_path

        with_loci = bool(args.seed_length) and not args.no_loci
        finder = SeedFinder(graph, args.seed_length or 1, device=device)
        if with_loci:
            if not finder.load_path_index(
                args.path_index, step_size=args.step_size
            ):
                print("error: cannot load path index", file=sys.stderr)
                return 1
            loci = finder.get_starting_loci()
        else:
            finder.pindex.set_context(0)
            if not finder.pindex.load(args.path_index):
                print("error: cannot load path index", file=sys.stderr)
                return 1
            loci = None
        records = []
        for i, path in enumerate(finder.pindex.get_paths_set()):
            # convert with per-locus "S" edits (ref: pindexctl.cpp:100-131
            # over path_interface.hpp:842-942)
            mappings = convert_path(graph, path, loci)
            records.append(
                encode_vg_alignment(
                    f"path{i}", sequence(path), mappings=mappings
                )
            )
        write_gam(args.output, records)
        print(f"wrote {len(records)} path alignments", file=sys.stderr)
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
