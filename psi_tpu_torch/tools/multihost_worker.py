"""One process of an N-process run of the multi-device query pipeline
(torch.distributed, gloo on localhost), one mesh shard a process.

    python -m psi_tpu_torch.tools.multihost_worker PORT PROC_ID NPROC \\
        OUT_JSON [--device cuda|cpu] [--gfa GRAPH --fastq READS \\
        [--index PREFIX] [--chunk N] [-l K] [-n PATHS] [--expect HITS.npy]]

Start NPROC of them with PROC_ID 0..NPROC-1 and the same PORT (a free
localhost port). Each process holds one device (on cuda the card
PROC_ID modulo the visible cards, so N processes may share one card) and
checks, over the global mesh of NPROC shards:

  * component-sharded counting (parallel/distributed.sharded_count, its
    totals summed across processes) against a host-side global FM
    oracle;
  * the data-parallel trie search (parallel/mesh.sharded_trie_search,
    gathered across processes) against the same oracle;
  * the SeedFinder pipeline on the mesh (sharded on-path chain and
    loci-sharded off-path traversal) under PSI_MH_EMIT=shard — each
    process emits its own shards' hits, so the streams must be disjoint
    (no hit emitted twice: their sizes add up) and their union, as a
    multiset, the single-device finder's — and
    under PSI_MH_EMIT=full, where every process's stream must equal it.

The pipeline runs on a small branchy graph by default, or on --gfa's
graph (its path index loaded from --index, else built with -n paths) and
the first --chunk reads of --fastq; --expect gives the single-device
finder's hit rows (a SEED_DTYPE .npy), which process 0 otherwise
computes itself. Process 0 writes the parity flags, the hit counts, the
kernel launches and the wall times of every process to OUT_JSON; the
exit code is 0 only when every check passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

SORT_ORDER = ["node_id", "node_offset", "read_id", "read_offset",
              "match_len", "gocc"]
#: kernel wrappers whose launches each process reports
COUNTED = (("fm_fused", "trie_level"), ("traverse", "traverse_step"),
           ("traverse", "range_refine4"), ("traverse", "traverse_step_approx"),
           ("fm_pallas", "lf_pair"))


def _counters() -> dict:
    import importlib

    return {f"{mod}.{fn}": getattr(importlib.import_module(
        f"psi_tpu_torch.ops.{mod}"), fn).launches for mod, fn in COUNTED}


def _sorted(hits: np.ndarray) -> np.ndarray:
    return np.sort(hits, order=SORT_ORDER)


def _small_inputs():
    """The CI-sized pipeline inputs: a branchy graph and 32 reads plus
    one through the branch node."""
    from psi_tpu_torch.graph import Graph
    from psi_tpu_torch.records import Records

    rng = np.random.RandomState(5)
    seq = "".join(rng.choice(list("ACGT"), size=3000))
    g = Graph.from_parts(
        nodes={1: seq[:1500], 2: seq[1500:], 3: "ACGTAGGTACGTTCGTACGATTAG"},
        edges=[(1, 2), (1, 3), (3, 2)],
        paths=[("ref", [1, 2])],
    )
    branch = (g.node_sequence(1)[-6:] + g.node_sequence(3)
              + g.node_sequence(2)[:10])
    reads = Records(
        [f"r{i}" for i in range(32)] + ["b0"],
        [seq[i * 61: i * 61 + 48] for i in range(32)] + [branch],
    )
    return g, reads, 12


def _count_and_trie(dev, n_devices: int) -> dict:
    """Component-sharded counting and the data-parallel trie search over
    n_devices shards, against a global FM oracle (identical inputs on
    every process)."""
    from psi_tpu_torch.fmindex import FMIndex
    from psi_tpu_torch.ops.fm import keys_to_codes
    from psi_tpu_torch.ops.fm_stream import build_stream_arrays
    from psi_tpu_torch.parallel.distributed import (
        build_sharded_index, sharded_count,
    )
    from psi_tpu_torch.parallel.mesh import device_mesh, sharded_trie_search

    rng = np.random.RandomState(42)
    shard_strings = [
        ["".join(rng.choice(list("ACGT"), size=2000)) for _ in range(2)]
        for _ in range(n_devices)
    ]
    fms = [FMIndex.build_from_strings([s[::-1] for s in g])
           for g in shard_strings]
    all_strings = [s for g in shard_strings for s in g]
    fm_all = FMIndex.build_from_strings([s[::-1] for s in all_strings])
    k = 12
    kmers = []
    for _ in range(4096):
        s = all_strings[rng.randint(len(all_strings))]
        st = rng.randint(0, len(s) - k + 1)
        kmers.append(s[st: st + k])
    lut = {c: i for i, c in enumerate("ACGT")}
    ukeys = np.unique(np.array(
        [sum(lut[c] << (2 * (k - 1 - j)) for j, c in enumerate(km))
         for km in kmers], dtype=np.uint64))
    codes = keys_to_codes(ukeys, k)
    decode = ["".join("ACGT"[(int(key) >> (2 * (k - 1 - j))) & 3]
                      for j in range(k)) for key in ukeys]
    expect = np.array([fm_all.count(km[::-1]) for km in decode])

    mesh_s = device_mesh(axes=("shard",), devices=[dev])
    t0 = time.monotonic()
    total, _, _ = sharded_count(mesh_s, build_sharded_index(fms, mesh_s),
                                codes)
    t_count = time.monotonic() - t0
    mesh_d = device_mesh(devices=[dev])
    t0 = time.monotonic()
    lo, hi = sharded_trie_search(mesh_d, build_stream_arrays(fm_all, dev),
                                 ukeys, k)
    t_trie = time.monotonic() - t0
    return {"count_ok": bool(np.array_equal(total, expect)),
            "trie_ok": bool(np.array_equal((hi - lo).astype(np.int64),
                                           expect)),
            "n_keys": int(len(ukeys)), "t_count": t_count,
            "t_trie": t_trie}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port")
    ap.add_argument("proc_id", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--gfa")
    ap.add_argument("--fastq")
    ap.add_argument("--index", help="path-index prefix to load")
    ap.add_argument("--chunk", type=int, default=100_000)
    ap.add_argument("-l", "--seed-length", type=int, default=20)
    ap.add_argument("-n", "--path-num", type=int,
                    help="paths to index (default 2 with --gfa, else 1)")
    ap.add_argument("--expect", help="the single-device hits (.npy)")
    args = ap.parse_args(argv)
    pid, nproc, out = args.proc_id, args.nproc, args.out

    from psi_tpu_torch.parallel.distributed import (
        barrier, initialize_multihost, process_allgather, process_count,
    )

    if nproc > 1:
        initialize_multihost(f"localhost:{args.port}", nproc, pid)
    assert process_count() == nproc, process_count()
    if args.device == "cuda":
        dev = torch.device("cuda", pid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")

    res = _count_and_trie(dev, nproc)

    from psi_tpu_torch.seed_finder import SeedFinder

    if args.gfa:
        from psi_tpu_torch.io import load_graph
        from psi_tpu_torch.io.fastq import FastxStream
        from psi_tpu_torch.records import Records

        graph = load_graph(args.gfa)
        names, packed = FastxStream(args.fastq).read_chunk_packed(args.chunk)
        reads = Records(names, rec_offset=0, packed=packed)
        k = args.seed_length
    else:
        graph, reads, k = _small_inputs()
    n_paths = args.path_num or (2 if args.gfa else 1)

    def make_finder(devices):
        f = SeedFinder(graph, k, devices=devices, device=dev)
        if not (args.index and f.load_path_index(args.index)):
            f.create_path_index(n_paths, patched=False)
        # the per-index state the first chunk would build: not timed as
        # the query's
        f._get_ftab()
        f._get_stream_arrays()
        f._get_sa()
        f._get_map_arrays()
        f._get_graph_arrays()
        seeds = f.get_seeds(reads)
        return f, seeds, f.index_reads(seeds)

    t0 = time.monotonic()
    finder, seeds, index = make_finder((dev,))
    t_build = time.monotonic() - t0
    mesh = finder._get_mesh()
    assert mesh is not None and mesh.size == nproc, mesh
    # one query first, neither timed nor counted: the process's first
    # launches load their kernels
    finder.prepare_onpath(index)
    finder.seeds_all_arrays(seeds, index)
    walls = {}
    hits = {}
    launches = {}
    for mode in ("shard", "full"):
        os.environ["PSI_MH_EMIT"] = mode
        before = _counters()
        t0 = time.monotonic()
        finder.prepare_onpath(index)
        hits[mode] = finder.seeds_all_arrays(seeds, index)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls[mode] = time.monotonic() - t0
        launches[mode] = {name: n - before[name]
                          for name, n in _counters().items()}
        np.save(f"{out}.{mode}{pid}.npy", hits[mode])
    barrier()
    # every process's walls and launches, in process order
    names = sorted(launches["shard"])
    table = process_allgather(np.array([[
        walls["shard"], walls["full"], t_build,
        *(launches[m][n] for m in ("shard", "full") for n in names),
    ]], dtype=np.float64))
    ok = res["count_ok"] and res["trie_ok"]
    if pid == 0:
        if args.expect:
            expect = np.load(args.expect)
        else:
            single, s_seeds, s_index = make_finder(1)
            assert single._get_mesh() is None
            single.prepare_onpath(s_index)
            expect = single.seeds_all_arrays(s_seeds, s_index)
        expect = _sorted(expect)
        shard = [np.load(f"{out}.shard{q}.npy") for q in range(nproc)]
        full = [np.load(f"{out}.full{q}.npy") for q in range(nproc)]
        merged = _sorted(np.concatenate(shard))
        # no hit emitted by two processes: the shard streams' sizes add
        # up to the single-device stream's, which they equal as a
        # multiset. A row may still come from two processes where the
        # single-device stream holds it twice (an on-path and an
        # off-path hit alike, or one k-mer on two indexed paths)
        disjoint = sum(len(h) for h in shard) == len(expect)
        rows = [set(map(bytes, h.view(f"V{h.dtype.itemsize}")))
                for h in shard]
        shared_rows = len(set.intersection(*rows)) if nproc > 1 else 0
        shard_ok = bool(disjoint and np.array_equal(merged, expect)
                        and len(expect) > 0)
        full_ok = all(np.array_equal(_sorted(h), expect) for h in full)
        ok = ok and shard_ok and full_ok
        per_proc = []
        for q in range(nproc):
            row = table[q]
            n = len(names)
            per_proc.append({
                "wall_shard_s": row[0], "wall_full_s": row[1],
                "build_s": row[2],
                "launches_shard": dict(zip(names, map(int, row[3:3 + n]))),
                "launches_full": dict(zip(names, map(int, row[3 + n:]))),
                "hits_shard": int(len(shard[q])),
                "hits_full": int(len(full[q])),
            })
        with open(out, "w") as fh:
            json.dump({
                "nproc": nproc, "devices": mesh.size,
                "device": str(dev), "mesh": [str(d) for d in mesh.devices],
                **res, "shard_ok": shard_ok, "disjoint": disjoint,
                "shared_rows": shared_rows,
                "full_ok": full_ok, "pipeline_ok": shard_ok and full_ok,
                "pipeline_hits": int(len(expect)),
                "pipeline_keys": int(len(np.unique(index.sorted_keys))),
                "pipeline_loci": len(finder.get_starting_loci()),
                "processes": per_proc,
            }, fh)
    barrier()
    for mode in ("shard", "full"):
        os.remove(f"{out}.{mode}{pid}.npy")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
