"""Multi-process runtime + component-sharded path index.

Counterpart of psi_tpu/parallel/distributed.py. Two scaling axes
(SURVEY.md §2.3 mapping):
  * data  — read/k-mer batches (embarrassingly parallel);
  * shard — the path index partitioned by graph *component* (the
    reference's per-component block-diagonal partitioning,
    ref: seed_finder.hpp:1178-1235, reused as the index-sharding axis).

Sharded counting: each shard holds an FM index over the path sequences
of its components; a query batch is broadcast, each shard counts its own
occurrences with one `fm_pallas.lf_pair` launch a step (csrc/occ_gather.cu
on the card), and the global genome-occurrence count (gocc) is the sum
over shards — identical to the single-index count because components are
disjoint. Locate stays shard-local; hit sets merge on the host.

The runtime is `torch.distributed` with the gloo backend over CPU
tensors: every exchange psi_tpu makes across processes ends on the host
(its process_allgather returns host arrays, and sharded_count reads its
psum'd totals there), so a host collective is the faithful port, and it
also runs two processes that share one card, which NCCL refuses.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from psi_tpu_torch.fmindex import FMIndex
from psi_tpu_torch.ops import fm_pallas


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Bring up the multi-process runtime: a gloo process group whose
    rendezvous is `coordinator_address` ("host:port"). No-op when
    unconfigured (one process)."""
    if coordinator_address is None:
        return
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d is not None else 1


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d is not None else 0


def process_allgather(x) -> np.ndarray:
    """Every process's `x` concatenated on axis 0 in process order (what
    psi_tpu's `multihost_utils.process_allgather(x, tiled=True)` gives),
    as a host array. The leading sizes may differ between processes; the
    trailing shape and the dtype may not. One process: x itself."""
    a = np.ascontiguousarray(np.asarray(x))
    d = _dist()
    if d is None:
        return a
    n = d.get_world_size()
    rows = torch.tensor([a.shape[0]], dtype=torch.int64)
    sizes = [torch.zeros_like(rows) for _ in range(n)]
    d.all_gather(sizes, rows)
    sizes = [int(s) for s in sizes]
    m = max(sizes)
    wire = a.astype(np.uint8) if a.dtype == np.bool_ else a
    pad = np.zeros((m,) + a.shape[1:], dtype=wire.dtype)
    pad[: a.shape[0]] = wire
    t = torch.from_numpy(pad)
    parts = [torch.empty_like(t) for _ in range(n)]
    d.all_gather(parts, t)
    out = np.concatenate([p.numpy()[:s] for p, s in zip(parts, sizes)])
    return out.astype(a.dtype, copy=False)


def process_sum(x) -> np.ndarray:
    """Elementwise sum of `x` over every process (the cross-process half
    of psi_tpu's psum), as a host array. One process: x itself."""
    a = np.ascontiguousarray(np.asarray(x))
    d = _dist()
    if d is None:
        return a
    t = torch.from_numpy(a.astype(np.int64))
    d.all_reduce(t)
    return t.numpy().astype(a.dtype, copy=False)


def barrier() -> None:
    d = _dist()
    if d is not None:
        d.barrier()


def _to_device(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def put_global(x, mesh, axis: Optional[str] = None) -> list:
    """Place host data on a (possibly multi-process) mesh: every process
    passes the same full-size array and gets, per flat mesh position, the
    tensor on that position's device — or None where another process owns
    the position (only this process's own shards are placed).

    axis None: the whole array at every position, one copy per distinct
    device (a mesh that names a device twice holds one copy). axis named:
    the leading dimension splits into mesh.shape[axis] equal blocks, and a
    position gets the block of its coordinate on that axis."""
    x = x if isinstance(x, torch.Tensor) else np.asarray(x)
    out: list = [None] * mesh.size
    copies: dict = {}
    if axis is not None:
        n = mesh.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"put_global: {x.shape[0]} rows do not split "
                             f"into {n} blocks")
        per = x.shape[0] // n
    for p in mesh.local_positions():
        dev = mesh.device(p)
        if axis is None:
            key = (dev, None)
            if key not in copies:
                copies[key] = _to_device(x, dev)
        else:
            c = mesh.coord(p, axis)
            key = (dev, c)
            if key not in copies:
                copies[key] = _to_device(x[c * per: (c + 1) * per], dev)
        out[p] = copies[key]
    return out


class ShardedFMArrays(NamedTuple):
    """Per-shard FM arrays, padded to a common size, one entry per flat
    mesh position (None where another process owns it): position p holds
    shard mesh.coord(p, axis)."""

    occ_dense: list       # int32 [n_pad+1, 4] per position
    C: list               # int32 [SIGMA+1] per position
    sa: list              # int32 [n_pad] per position
    sizes: np.ndarray     # int32 [S] true text sizes
    n_pad: int
    mesh: object = None
    axis: str = "shard"


def build_sharded_index(
    fms: List[FMIndex], mesh, axis: str = "shard"
) -> ShardedFMArrays:
    """Stack per-shard FM indexes (one per component group) and place
    them sharded over the mesh axis."""
    n_shards = mesh.shape[axis]
    assert len(fms) == n_shards, (len(fms), n_shards)
    n_pad = max(fm.size for fm in fms)
    S = n_shards
    occ = np.zeros((S, n_pad + 1, 4), dtype=np.int32)
    C = np.zeros((S, 7), dtype=np.int32)
    sa = np.zeros((S, n_pad), dtype=np.int32)
    sizes = np.zeros(S, dtype=np.int32)
    for s, fm in enumerate(fms):
        n = fm.size
        sizes[s] = n
        for c in range(1, 5):
            occ[s, 1: n + 1, c - 1] = np.cumsum(fm.bwt == c, dtype=np.int32)
        occ[s, n + 1:] = occ[s, n]
        C[s, : len(fm.C)] = fm.C
        sa[s, :n] = fm.sa

    def place(stacked):
        return [None if t is None else t[0]
                for t in put_global(stacked, mesh, axis)]

    return ShardedFMArrays(
        occ_dense=place(occ), C=place(C), sa=place(sa), sizes=sizes,
        n_pad=n_pad, mesh=mesh, axis=axis,
    )


def _count_shard(occ, C, n: int, codes: torch.Tensor):
    """psi_tpu's scan step over one shard: C[c] + occ[lo, c-1] for lo and
    hi (one lf_pair launch a column), with its alive mask and
    max(new_lo, new_hi). Returns device (lo, hi) int32 [N]."""
    N = codes.shape[0]
    dev = codes.device
    hi = torch.full((N,), n, dtype=torch.int32, device=dev)
    lo = torch.zeros_like(hi)
    for c in codes.t().contiguous():
        new_lo, new_hi = fm_pallas.lf_pair(occ, C, c, lo, hi)
        alive = lo < hi
        lo = torch.where(alive, new_lo, lo)
        hi = torch.where(alive, torch.maximum(new_lo, new_hi), hi)
    return lo, hi


def _shard_owners(mesh, axis: str) -> dict:
    """For each shard coordinate, the first flat position holding it
    (exactly one process owns that position)."""
    owners: dict = {}
    for p in range(mesh.size):
        owners.setdefault(mesh.coord(p, axis), p)
    return owners


def sharded_count(
    mesh, arrays: ShardedFMArrays, codes: np.ndarray, axis: str = "shard"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Count a query batch against every shard.

    Returns (total_counts [N], per-shard lo [S, N], per-shard hi [S, N]);
    total counts equal the unsharded gocc (components are disjoint). On a
    multi-process mesh lo/hi hold this process's shards only (locate
    stays shard-local by design) and the totals are summed across
    processes."""
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    N = codes.shape[0]
    codes_r = put_global(codes, mesh)
    pending = {}
    for s, p in sorted(_shard_owners(mesh, axis).items()):
        if mesh.is_local(p):
            pending[s] = _count_shard(arrays.occ_dense[p], arrays.C[p],
                                      int(arrays.sizes[s]), codes_r[p])
    lo = {s: a.cpu().numpy() for s, (a, _) in pending.items()}
    hi = {s: b.cpu().numpy() for s, (_, b) in pending.items()}
    total = np.zeros(N, dtype=np.int64)
    for s in lo:
        total += hi[s].astype(np.int64) - lo[s]
    total = process_sum(total)
    shards = sorted(lo)
    empty = np.zeros((0, N), dtype=np.int32)
    return (
        total,
        np.stack([lo[s] for s in shards]) if shards else empty,
        np.stack([hi[s] for s in shards]) if shards else empty,
    )


def sharded_count_2d(
    mesh,
    arrays: ShardedFMArrays,
    codes: np.ndarray,
    data_axis: str = "data",
    shard_axis: str = "shard",
) -> np.ndarray:
    """Fully composed 2-D parallelism: the query batch shards over the
    `data` axis while the index shards over the `shard` axis — every
    device holds one (query-slice, index-shard) tile; global gocc is the
    sum over the shard axis only. Returns total counts [N]."""
    n_data = mesh.shape[data_axis]
    pad = (-codes.shape[0]) % n_data
    padded = np.concatenate(
        [codes, np.ones((pad,) + codes.shape[1:], codes.dtype)]
    ) if pad else codes
    padded = np.ascontiguousarray(padded, dtype=np.int32)
    per = padded.shape[0] // n_data
    codes_d = put_global(padded, mesh, data_axis)
    pending = []
    for p in mesh.local_positions():
        i, s = mesh.coord(p, data_axis), mesh.coord(p, shard_axis)
        lo, hi = _count_shard(arrays.occ_dense[p], arrays.C[p],
                              int(arrays.sizes[s]), codes_d[p])
        pending.append((i, hi - lo))
    total = np.zeros(padded.shape[0], dtype=np.int64)
    for i, w in pending:
        total[i * per: (i + 1) * per] += w.cpu().numpy()
    return process_sum(total)[: codes.shape[0]]


def sharded_locate(
    arrays: ShardedFMArrays, lo: np.ndarray, hi: np.ndarray,
    max_width: int, axis: str = "shard",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gather text positions per shard for the given ranges.

    Returns (shard_idx, query_idx, positions) flattened across shards —
    the host-side merge of per-shard hit sets. The SA stays on each
    shard's device: the occurrence expansion plans shard-local SA indices
    on the host (lo/hi are small), every shard gathers its positions on
    its own device, and only the hits come down."""
    S, N = lo.shape
    widths = np.maximum(hi - lo, 0).astype(np.int64)
    per_tot = widths.sum(axis=1)
    total = int(per_tot.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    cap = max(16, 1 << (int(per_tot.max()) - 1).bit_length())
    idx = np.zeros((S, cap), dtype=np.int32)
    query_l = []
    for s in range(S):
        w = widths[s]
        t = int(per_tot[s])
        rows = np.repeat(np.arange(N, dtype=np.int64), w)
        within = np.arange(t, dtype=np.int64) - np.repeat(
            np.cumsum(w) - w, w
        )
        idx[s, :t] = lo[s][rows] + within
        query_l.append(rows)
    mesh = arrays.mesh
    pos2 = np.zeros((S, cap), dtype=np.int64)
    gathered = []
    for s, p in sorted(_shard_owners(mesh, axis).items()):
        if mesh.is_local(p):
            sa = arrays.sa[p]
            safe = torch.from_numpy(idx[s]).to(sa.device).long().clamp(
                0, sa.shape[0] - 1)
            gathered.append((s, sa[safe]))
    for s, t in gathered:
        pos2[s] = t.cpu().numpy()
    pos2 = process_sum(pos2)
    shard = np.repeat(np.arange(S, dtype=np.int64), per_tot)
    query = np.concatenate(query_l)
    pos = np.concatenate(
        [pos2[s, : int(per_tot[s])] for s in range(S)]
    ).astype(np.int64)
    return shard, query, pos


def partition_paths_by_component(
    graph, pindex, n_shards: int
) -> Tuple[List[List[int]], List[int]]:
    """Assign indexed paths to shards by their component, balancing total
    sequence length. Returns (per-shard path-index lists, component of
    each path)."""
    ranges = graph.component_ranges()

    def comp_of(path) -> int:
        first = path.get_nodes()[0]
        rank = graph.id_to_rank(first)
        for ci, (lo_r, hi_r) in enumerate(ranges):
            if lo_r <= rank < hi_r:
                return ci
        return 0

    pset = pindex.get_paths_set()
    comp = [comp_of(p) for p in pset]
    comp_len = {}
    for p, c in zip(pset, comp):
        comp_len[c] = comp_len.get(c, 0) + p.get_sequence_len()
    # greedy bin packing of components over shards
    shard_load = [0] * n_shards
    comp_shard = {}
    for c in sorted(comp_len, key=comp_len.get, reverse=True):
        s = int(np.argmin(shard_load))
        comp_shard[c] = s
        shard_load[s] += comp_len[c]
    per_shard = [[] for _ in range(n_shards)]
    for i, c in enumerate(comp):
        per_shard[comp_shard[c]].append(i)
    return per_shard, comp
