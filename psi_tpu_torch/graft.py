"""Entry points for a quick check of the engine: one batched search on a
device and a multi-device dry run (the counterpart of psi_tpu's
__graft_entry__.py).

    fn, args = entry()            # on the card; entry("cpu") on the CPU
    fn(*args)                     # int32 [1024] counts
    dryrun_multichip(2, devices=("cuda:0", "cuda:0"))   # one card, twice
    dryrun_multichip(8, devices=("cpu",) * 8)           # virtual shards
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from psi_tpu_torch.device import resolve


def _tiny_index():
    """Small FM index over synthetic haplotype-like sequences."""
    from psi_tpu_torch.fmindex import FMIndex

    rng = np.random.RandomState(0)
    strings = [
        "".join(rng.choice(list("ACGT"), size=2048)) for _ in range(4)
    ]
    return FMIndex.build_from_strings([s[::-1] for s in strings])


def entry(device: Optional[str] = None):
    """A forward step on the flagship compute path: batched FM backward
    search on the dense occ layout (one lf_pair launch a step), on the
    card unless `device` names the CPU. Returns (fn, example_args)."""
    from psi_tpu_torch.ops import fm as fm_ops

    dev = resolve("cuda") if device is None else torch.device(device)
    fm = _tiny_index()
    arrays = fm_ops.to_device(fm, dev, dense_occ=True)
    k = 20
    rng = np.random.RandomState(1)
    codes = torch.from_numpy(
        rng.randint(1, 5, size=(1024, k)).astype(np.int32)).to(dev)

    def fn(arrays, codes):
        lo, hi = fm_ops.backward_search_codes(arrays, codes)
        return hi - lo

    return fn, (arrays, codes)


def _finder_hits(graph, reads, devices, device):
    """A SeedFinder's lexsorted hits on the device-chained on-path route
    and the off-path traversal."""
    from psi_tpu_torch.seed_finder import SeedFinder

    f = SeedFinder(graph, seed_len=12, devices=devices, device=device)
    f.create_path_index(n=1, patched=False)
    f.add_uncovered_loci()
    seeds = f.get_seeds(reads)
    index = f.index_reads(seeds)
    f.prepare_onpath(index)
    hits = f.seeds_all_arrays(seeds, index)
    mesh = f._get_mesh()
    return np.sort(hits, order=["node_id", "node_offset", "read_id",
                                "read_offset", "match_len", "gocc"]), mesh


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    """Run the sharded query steps over an n-device mesh on tiny shapes
    and hold each to its single-device counterpart (raising on any
    difference): the train step (data-parallel batch, replicated index,
    summed stats), the sharded backward search, the sharded trie search,
    the SeedFinder pipeline on the mesh (sharded chain and loci-sharded
    traversal) bit-identical to the single-device finder, and
    component-sharded counting against the sum of per-index counts.
    `devices` names the mesh's devices (it may name one card twice);
    without it, the first n_devices cards."""
    from psi_tpu_torch.graph import Graph
    from psi_tpu_torch.ops import fm as fm_ops
    from psi_tpu_torch.ops import fm_stream
    from psi_tpu_torch.parallel.distributed import (
        build_sharded_index, sharded_count,
    )
    from psi_tpu_torch.parallel.mesh import (
        device_mesh, make_train_step, replicate, shard_batch,
        sharded_backward_search, sharded_trie_search,
    )
    from psi_tpu_torch.records import Records

    if devices is None:
        mesh = device_mesh(n_devices)
    else:
        mesh = device_mesh(n_devices, devices=list(devices))
    if mesh.size != n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {mesh.size}")
    dev = mesh.device(0)
    fm = _tiny_index()
    arrays = fm_ops.to_device(fm, dev, dense_occ=True)

    k = 16
    rng = np.random.RandomState(2)
    codes = rng.randint(1, 5, size=(8 * n_devices, k)).astype(np.int32)

    # full sharded step: replicated index, data-sharded batch
    step = make_train_step(mesh)
    counts, total_occ, nonzero = step(replicate(mesh, arrays),
                                      shard_batch(mesh, codes))
    expect_lo, expect_hi = (
        a.cpu().numpy() for a in fm_ops.backward_search_codes(
            arrays, torch.from_numpy(codes).to(dev)))
    expect = expect_hi.astype(np.int64) - expect_lo
    if (total_occ, nonzero) != (int(expect.sum()), int((expect > 0).sum())):
        raise AssertionError(f"train step stats {(total_occ, nonzero)}")

    # cross-check against the single-device path
    lo, hi = sharded_backward_search(mesh, arrays, codes)
    np.testing.assert_array_equal(lo, expect_lo)
    np.testing.assert_array_equal(hi, expect_hi)

    # sharded trie route (the on-path kernel path): per-device plans,
    # replicated stream index
    keys_u = np.unique(
        (codes.astype(np.int64) - 1)
        @ (4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
    ).astype(np.uint64)
    sarr = fm_stream.build_stream_arrays(fm, dev)
    t_lo, t_hi = sharded_trie_search(mesh, sarr, keys_u, k)
    e_lo, e_hi = (a.cpu().numpy() for a in fm_ops.backward_search_codes(
        arrays, torch.from_numpy(fm_ops.keys_to_codes(keys_u, k)).to(dev)))
    np.testing.assert_array_equal(e_hi - e_lo, t_hi - t_lo)

    # the pipeline on the mesh: SeedFinder with the mesh's devices —
    # sharded on-path chain and loci-sharded off-path traversal,
    # bit-identical to the single-device finder
    seq = "".join(rng.choice(list("ACGT"), size=1500))
    parts = dict(
        nodes={1: seq[:700], 2: seq[700:], 3: "ACGTAGGTACGTTCGTACGA"},
        edges=[(1, 2), (1, 3), (3, 2)],
        paths=[("ref", [1, 2])],
    )
    reads = Records(
        [f"r{i}" for i in range(16)],
        [seq[i * 61: i * 61 + 48] for i in range(16)],
    )
    local = [mesh.device(p) for p in mesh.local_positions()]
    multi, fmesh = _finder_hits(Graph.from_parts(**parts), reads,
                                tuple(local), dev)
    single, _ = _finder_hits(Graph.from_parts(**parts), reads, 1, dev)
    if fmesh is None or fmesh.size != n_devices or not len(multi):
        raise AssertionError(f"the finder's mesh is {fmesh}, with "
                             f"{len(multi)} hits")
    np.testing.assert_array_equal(multi, single)

    # index-sharded path: component-sharded FM over a shard-axis mesh
    # with summed global counts
    from psi_tpu_torch.fmindex import FMIndex

    shard_mesh = device_mesh(n_devices, axes=("shard",), devices=local)
    fms = [
        FMIndex.build_from_strings(
            ["".join(rng.choice(list("ACGT"), size=256))[::-1]]
        )
        for _ in range(n_devices)
    ]
    s_arrays = build_sharded_index(fms, shard_mesh)
    total, _, _ = sharded_count(shard_mesh, s_arrays, codes)
    expect_total = np.zeros(len(codes), dtype=np.int64)
    codes_d = torch.from_numpy(codes).to(dev)
    for one in fms:
        a_lo, a_hi = fm_ops.backward_search_codes(
            fm_ops.to_device(one, dev, dense_occ=True), codes_d)
        expect_total += (a_hi - a_lo).cpu().numpy()
    np.testing.assert_array_equal(total, expect_total)
