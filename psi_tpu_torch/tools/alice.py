"""alice — ALignment InspeCtor and analysEr over GAF alignments
(functional parity with ref: tools/src/alice.cpp: embedded GAF parser,
`dstats` pair-distance verification via the distance index, `analyse`
precision/recall vs a ground-truth GAF). A copy of psi_tpu's tool over
this package's DistanceIndex; `dstats` probes on `--device` (the card by
default, through verify_batch_device), and PSI_DINDEX_DEVICE=0 keeps
the NumPy host probe, which is psi_tpu's default.

    python -m psi_tpu_torch.tools.alice dstats PAIRS.gaf -g GRAPH \
        -d dist.npz [--device {cuda,cpu}]
    python -m psi_tpu_torch.tools.alice analyse ALN.gaf -g GRAPH \
        -T TRUTH.gaf [-t IDENTITY] [--tolerance BP]
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from psi_tpu_torch.device import CHOICES

@dataclass
class GAFRecord:
    """One GAF line (oriented-path parsing per ref: alice.cpp:181-444)."""

    qname: str = ""
    qlen: int = 0
    qstart: int = 0
    qend: int = 0
    strand: str = "+"
    path: List[Tuple[int, bool]] = field(default_factory=list)  # (node, rev)
    plen: int = 0
    pstart: int = 0
    pend: int = 0
    matches: int = 0
    alnlen: int = 0
    mapq: int = 0

    @property
    def identity(self) -> float:
        return self.matches / self.alnlen if self.alnlen else 0.0


def parse_gaf_path(s: str) -> List[Tuple[int, bool]]:
    out = []
    i = 0
    while i < len(s):
        orient = s[i]
        if orient not in "><":
            raise ValueError(f"bad GAF path segment: {s!r}")
        j = i + 1
        while j < len(s) and s[j] not in "><":
            j += 1
        out.append((int(s[i + 1: j]), orient == "<"))
        i = j
    return out


def parse_gaf_line(line: str) -> Optional[GAFRecord]:
    f = line.rstrip("\n").split("\t")
    if len(f) < 12:
        return None
    rec = GAFRecord(
        qname=f[0],
        qlen=int(f[1]) if f[1] != "*" else 0,
        qstart=int(f[2]) if f[2] != "*" else 0,
        qend=int(f[3]) if f[3] != "*" else 0,
        strand=f[4],
        path=parse_gaf_path(f[5]) if f[5] not in ("*", "") else [],
        plen=int(f[6]) if f[6] != "*" else 0,
        pstart=int(f[7]) if f[7] != "*" else 0,
        pend=int(f[8]) if f[8] != "*" else 0,
        matches=int(f[9]) if f[9] != "*" else 0,
        alnlen=int(f[10]) if f[10] != "*" else 0,
        mapq=int(f[11]) if f[11] != "*" else 0,
    )
    return rec


def read_gaf(path: str) -> List[GAFRecord]:
    out = []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            rec = parse_gaf_line(line)
            if rec is not None:
                out.append(rec)
    return out


def _end_locus(graph, rec: GAFRecord) -> Optional[Tuple[int, int]]:
    """(node, offset) of the alignment's last base."""
    if not rec.path:
        return None
    pos = rec.pend - 1
    for nid, rev in rec.path:
        internal = graph.id_by_coordinate(nid)
        ln = graph.node_length(internal)
        if pos < ln:
            return internal, pos
        pos -= ln
    return None


def _start_locus(graph, rec: GAFRecord) -> Optional[Tuple[int, int]]:
    if not rec.path:
        return None
    pos = rec.pstart
    for nid, rev in rec.path:
        internal = graph.id_by_coordinate(nid)
        ln = graph.node_length(internal)
        if pos < ln:
            return internal, pos
        pos -= ln
    return None


def _scan_gaf_dstats(path: str):
    """Column scan of a GAF for dstats: only qname, path, pstart, pend
    are materialised (the full GAFRecord dataclass is ~10x slower to
    build at alice's million-pair workloads,
    ref: tools/src/alice.cpp:599-737)."""
    names: List[str] = []
    paths: List[str] = []
    pstart: List[int] = []
    pend: List[int] = []
    with open(path) as fh:
        for line in fh:
            f = line.split("\t", 11)
            if len(f) < 12:
                continue
            names.append(f[0])
            paths.append(f[5])
            pstart.append(int(f[7]) if f[7] != "*" else 0)
            pend.append(int(f[8]) if f[8] != "*" else 0)
    return names, paths, pstart, pend


def _batch_loci(graph, path_strs, positions):
    """Vectorized (node, offset) of position `positions[i]` along the
    oriented path `path_strs[i]` — the batched form of _start_locus /
    _end_locus (regex fallback; the native GAF scanner hands
    _batch_loci_arrays the flattened segments directly)."""
    import numpy as np

    N = len(path_strs)
    # flatten all path segments: record id + coordinate id per node
    rec_l: List[int] = []
    coord_l: List[int] = []
    import re

    seg_re = re.compile(r"[><](\d+)")
    for i, s in enumerate(path_strs):
        for m in seg_re.finditer(s):
            rec_l.append(i)
            coord_l.append(int(m.group(1)))
    return _batch_loci_arrays(
        graph,
        np.asarray(rec_l, dtype=np.int64),
        np.asarray(coord_l, dtype=np.int64),
        positions,
        N,
    )


def _batch_loci_arrays(graph, pr, pc, positions, N):
    """Core of _batch_loci over flattened (record id, coordinate id)
    segment arrays. Returns (node [N], off [N], found [N])."""
    import numpy as np

    node = np.zeros(N, dtype=np.int64)
    off = np.zeros(N, dtype=np.int64)
    found = np.zeros(N, dtype=bool)
    if N == 0 or len(pr) == 0:
        return node, off, found
    # coordinate -> internal id (sorted lookup over graph.coord_ids)
    coords = np.asarray(graph.coord_ids, dtype=np.int64)
    order = np.argsort(coords, kind="stable")
    ins = np.searchsorted(coords[order], pc)
    ins = np.minimum(ins, len(coords) - 1)
    internal = order[ins] + 1
    bad = coords[internal - 1] != pc
    if bad.any():
        raise KeyError(f"unknown node coordinate {int(pc[bad][0])} in GAF path")
    node_len = np.diff(graph.label_offsets).astype(np.int64)
    ln = node_len[internal - 1]
    # per-record prefix bp before each path node
    cum = np.cumsum(ln)
    first = np.empty(len(pr), dtype=bool)
    first[0] = True
    first[1:] = pr[1:] != pr[:-1]
    rec_base = np.zeros(len(pr), dtype=np.int64)
    rec_base[first] = cum[np.nonzero(first)[0]] - ln[first]
    np.maximum.accumulate(rec_base, out=rec_base)
    cum_before = cum - ln - rec_base
    # locate positions[i] in record i's segment: one searchsorted over
    # composite keys (record-major, cum_before ascending within record)
    pos = np.asarray(positions, dtype=np.int64)
    BIG = np.int64(max(int(cum_before.max()), int(pos.max()), 0) + 2)
    keys = pr * BIG + cum_before
    q = np.arange(N, dtype=np.int64) * BIG + np.maximum(
        np.minimum(pos, BIG - 2), 0
    )
    idx = np.searchsorted(keys, q, side="right") - 1
    idxc = np.maximum(idx, 0)
    ok = (
        (idx >= 0)
        & (pr[idxc] == np.arange(N))
        & (np.maximum(pos, 0) < cum_before[idxc] + ln[idxc])
    )
    node[ok] = internal[idxc][ok]
    off[ok] = pos[ok] - cum_before[idxc][ok]
    found = ok
    return node, off, found


def _segments_for(indptr, coords, ridx):
    """Flattened (record-rank, coordinate) arrays for records `ridx`."""
    import numpy as np

    counts = (indptr[ridx + 1] - indptr[ridx]).astype(np.int64)
    tot = int(counts.sum())
    pr = np.repeat(np.arange(len(ridx), dtype=np.int64), counts)
    within = np.arange(tot, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    pc = coords[np.repeat(indptr[ridx], counts) + within]
    return pr, pc


def cmd_dstats(args) -> int:
    import numpy as np

    from psi_tpu_torch import native
    from psi_tpu_torch.device import resolve
    from psi_tpu_torch.dindex import DistanceIndex
    from psi_tpu_torch.io import load_graph

    graph = load_graph(args.graph)
    idx = DistanceIndex.load(args.dindex)

    with open(args.gaf, "rb") as fh:
        nat = native.gaf_scan(fh.read())
    if nat is not None:
        # native one-pass column scan: pairing + loci fully vectorized
        group, ordv, pstart_arr, pend_arr, indptr, coords, n_groups = nat
        firsts = np.nonzero(ordv == 0)[0]
        first_of_group = np.full(n_groups, -1, dtype=np.int64)
        first_of_group[group[firsts]] = firsts
        sa = np.nonzero(ordv == 1)[0]          # one per >=2-record group
        fa = first_of_group[group[sa]]
        singletons = n_groups - len(sa)
        npair = len(sa)
        ea_n, ea_o, ea_ok = _batch_loci_arrays(
            graph, *_segments_for(indptr, coords, fa),
            pend_arr[fa] - 1, npair,
        )
        sb_n, sb_o, sb_ok = _batch_loci_arrays(
            graph, *_segments_for(indptr, coords, sa),
            pstart_arr[sa], npair,
        )
    else:
        names, paths, pstart, pend = _scan_gaf_dstats(args.gaf)
        # pair up by query name (strip /1 /2 suffixes): the first two
        # records per base name, in file order
        base_of = {}
        first_i: List[int] = []
        second_i: List[int] = []
        group_n = {}
        for i, nm in enumerate(names):
            base = nm.rstrip("12").rstrip("/")
            gi = base_of.setdefault(base, len(base_of))
            c = group_n.get(gi, 0)
            group_n[gi] = c + 1
            if c == 0:
                first_i.append(i)
            elif c == 1:
                second_i.append(i)
        n_groups = len(base_of)
        singletons = sum(1 for c in group_n.values() if c < 2)
        npair = len(second_i)
        paired_g = [g for g in range(n_groups) if group_n.get(g, 0) >= 2]
        fa = np.asarray([first_i[g] for g in paired_g], dtype=np.int64)
        sa = np.asarray(second_i, dtype=np.int64)

        pend_arr = np.asarray(pend, dtype=np.int64)
        pstart_arr = np.asarray(pstart, dtype=np.int64)
        ea_n, ea_o, ea_ok = _batch_loci(
            graph,
            [paths[i] if paths[i] not in ("*", "") else "" for i in fa],
            pend_arr[fa] - 1,
        )
        sb_n, sb_o, sb_ok = _batch_loci(
            graph,
            [paths[i] if paths[i] not in ("*", "") else "" for i in sa],
            pstart_arr[sa],
        )

    ok = ea_ok & sb_ok
    # the pair probe on --device (ops/dindex_probe.py), the DiVerG
    # accelerator offload analogue; PSI_DINDEX_DEVICE=0 probes in NumPy
    if os.environ.get("PSI_DINDEX_DEVICE", "1") in ("", "0"):
        verified = idx.verify_batch(graph, ea_n[ok], ea_o[ok], sb_n[ok],
                                    sb_o[ok])
    else:
        verified = idx.verify_batch_device(
            graph, ea_n[ok], ea_o[ok], sb_n[ok], sb_o[ok],
            device=resolve(args.device),
        )
    n_pairs = int(ok.sum())
    accept = int(verified.sum())
    reject = n_pairs - accept
    skipped = singletons + (npair - n_pairs)
    print(f"pairs: {n_pairs}")
    print(f"accepted: {accept}")
    print(f"rejected: {reject}")
    print(f"skipped: {skipped}")
    return 0


def cmd_analyse(args) -> int:
    from psi_tpu_torch.io import load_graph

    graph = load_graph(args.graph)
    recs = read_gaf(args.gaf)
    truth = {r.qname: r for r in read_gaf(args.truth)}

    tp = fp = 0
    seen = set()
    for r in recs:
        if r.identity < args.identity:
            continue
        t = truth.get(r.qname)
        seen.add(r.qname)
        if t is None:
            fp += 1
            continue
        sl = _start_locus(graph, r)
        tl = _start_locus(graph, t)
        if sl is None or tl is None:
            fp += 1
            continue
        if sl[0] == tl[0] and abs(sl[1] - tl[1]) <= args.tolerance:
            tp += 1
        else:
            fp += 1
    fn = len(truth) - len(seen & set(truth))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    print(f"true positives: {tp}")
    print(f"false positives: {fp}")
    print(f"false negatives: {fn}")
    print(f"precision: {precision:.4f}")
    print(f"recall: {recall:.4f}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="alice", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dstats", help="verify pair distances via the distance index")
    d.add_argument("gaf")
    d.add_argument("-g", "--graph", required=True)
    d.add_argument("-d", "--dindex", required=True)
    d.add_argument("--device", choices=CHOICES, default="cuda",
                   help="device of the pair probe (cuda: the kernel, cpu: "
                        "its plain version)")

    a = sub.add_parser("analyse", help="precision/recall vs truth GAF")
    a.add_argument("gaf")
    a.add_argument("-g", "--graph", required=True)
    a.add_argument("-T", "--truth", required=True)
    a.add_argument("-t", "--identity", type=float, default=0.0)
    a.add_argument("--tolerance", type=int, default=0)

    args = p.parse_args(argv)
    if args.cmd == "dstats":
        return cmd_dstats(args)
    if args.cmd == "analyse":
        return cmd_analyse(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
