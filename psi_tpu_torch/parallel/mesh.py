"""Multi-device scale-out: device mesh + sharded query pipeline.

Counterpart of psi_tpu/parallel/mesh.py. The reference is single-process
(SURVEY.md §2.3); this layer is the engine's distribution backend:

  * axis "data"  — read/k-mer batches are data-parallel (the reference's
    thread-per-chunk design, ref: seed_finder.hpp:386-399, scaled out);
  * axis "shard" — index sharding for chr-scale occ tables (components
    partitioned across devices; queries routed, hits gathered).

psi_tpu builds on jax.sharding; here a `Mesh` is a named-axis grid of
`torch.device`s and a sharded value is a list with one entry per flat
mesh position: the tensor on that position's device, or None where
another process owns the position. Every shard runs the single-device
kernels of ops/ (trie_level, traverse_step, range_refine4, lf_pair), and
every shard's work is issued before any result is downloaded, so shards
on different cards overlap. Index arrays are replicated once per distinct
device (a mesh may name one card twice); cross-process exchanges are
gloo collectives over host arrays (parallel/distributed.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from psi_tpu_torch import stats as run_stats
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_trie
from psi_tpu_torch.ops import traverse as trav
from psi_tpu_torch.parallel.distributed import (
    process_allgather, process_count, process_index, process_sum,
    put_global,
)

#: virtual CPU devices of a process: the counterpart of the 8 virtual
#: devices psi_tpu's test mesh runs on
#: (--xla_force_host_platform_device_count=8)
CPU_DEVICES = 8


def _object_array(items: list) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out


class Mesh:
    """A grid of devices with named axes (jax.sharding.Mesh's role).
    `devices` is an object array of torch.device; `process` the rank that
    owns each position (this process's by default). On a multi-process
    mesh the positions run over (rank, local device) in rank order, and a
    process computes only on the positions it owns."""

    def __init__(self, devices, axis_names: Sequence[str], process=None):
        devices = np.asarray(devices, dtype=object)
        shape = devices.shape
        self.devices = _object_array(
            [torch.device(d) for d in devices.reshape(-1)]).reshape(shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {shape} with axes "
                             f"{self.axis_names}")
        if process is None:
            process = np.full(shape, process_index(), dtype=np.int64)
        self.process = np.asarray(process, dtype=np.int64).reshape(shape)
        if np.any(np.diff(self.process.reshape(-1)) < 0):
            raise ValueError("mesh positions must run in rank order")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, p: int) -> torch.device:
        return self.devices.reshape(-1)[p]

    def coord(self, p: int, axis: str) -> int:
        """Coordinate of flat position p along `axis`."""
        idx = np.unravel_index(p, self.devices.shape)
        return int(idx[self.axis_names.index(axis)])

    def is_local(self, p: int) -> bool:
        return int(self.process.reshape(-1)[p]) == process_index()

    def local_positions(self) -> list:
        return [p for p in range(self.size) if self.is_local(p)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def local_devices(platform: str = "cuda") -> list:
    """This process's devices: every visible card on "cuda" (raising
    without one), CPU_DEVICES virtual shards of the CPU on "cpu"."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_mesh on cuda: no CUDA device is visible "
                "(torch.cuda.is_available() is False)")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        return [torch.device("cpu")] * CPU_DEVICES
    raise ValueError(f"unknown platform {platform!r}")


def _global_devices(local: Sequence[torch.device]) -> list:
    """(rank, device) of every process's local devices, in rank order (a
    collective on a multi-process run: every process calls it alike)."""
    local = [torch.device(d) for d in local]
    if process_count() == 1:
        return [(0, d) for d in local]
    import torch.distributed as dist

    parts = [None] * process_count()
    dist.all_gather_object(parts, [str(d) for d in local])
    return [(r, torch.device(d)) for r, names in enumerate(parts)
            for d in names]


def device_count(platform: str = "cuda") -> int:
    """Devices over every process (psi_tpu's jax.device_count())."""
    return len(_global_devices(local_devices(platform)))


def device_mesh(
    n_devices: Optional[int] = None,
    axes=("data",),
    devices: Optional[Sequence] = None,
    platform: str = "cuda",
    shape: Optional[Tuple[int, ...]] = None,
) -> Mesh:
    """A mesh over the first n_devices devices of every process in rank
    order. `devices` names this process's devices (a sequence may name a
    card twice); without it they are every visible card on "cuda" or, on
    "cpu", n_devices virtual shards of the CPU (CPU_DEVICES a process on
    a multi-process run). A 2-D mesh needs `shape`."""
    if devices is None:
        if platform == "cpu" and n_devices and process_count() == 1:
            devices = [torch.device("cpu")] * n_devices
        else:
            devices = local_devices(platform)
    devs = _global_devices(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        if len(axes) != 1:
            raise ValueError("a mesh of several axes needs its shape")
        shape = (len(devs),)
    return Mesh(_object_array([d for _, d in devs]).reshape(shape), axes,
                process=np.asarray([r for r, _ in devs]).reshape(shape))


def _tree_to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_to(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_to(x, device) for x in tree)
    return tree


def replicate(mesh: Mesh, tree) -> list:
    """A pytree (tensors, arrays, NamedTuples, tuples) on every position
    of the mesh this process owns: one copy per distinct device, shared
    by the positions that name it (a tensor already there is not
    copied); None at other processes' positions."""
    copies: dict = {}
    out: list = [None] * mesh.size
    for p in mesh.local_positions():
        dev = mesh.device(p)
        if dev not in copies:
            copies[dev] = _tree_to(tree, dev)
        out[p] = copies[dev]
    return out


class ShardedArray(NamedTuple):
    """A batch split over a mesh axis: `shards[p]` is position p's block
    of `per` rows (None at other processes' positions); rows past `n` are
    padding."""

    shards: list
    n: int
    per: int
    axis: str

    def valid(self, mesh: Mesh, p: int) -> int:
        """Rows of position p's block that are not padding."""
        c = mesh.coord(p, self.axis)
        return max(min(self.n - c * self.per, self.per), 0)


def shard_batch(mesh: Mesh, arr, axis: str = "data") -> ShardedArray:
    """Shard the leading dimension over the given mesh axis (padding to a
    multiple of the axis size with zeros)."""
    arr = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    n = mesh.shape[axis]
    pad = (-arr.shape[0]) % n
    if pad:
        arr = torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
    per = arr.shape[0] // n
    return ShardedArray(put_global(arr, mesh, axis), int(arr.shape[0] - pad),
                        per, axis)


def _gather_rows(mesh: Mesh, rows: dict, like: np.ndarray) -> np.ndarray:
    """[D, ...] host array of per-position rows: this process's from
    `rows` (flat position -> array shaped like `like`), the others' by
    a cross-process allgather (positions run in rank order)."""
    local = mesh.local_positions()
    mine = np.stack([rows[p] for p in local]) if local else np.zeros(
        (0,) + like.shape, like.dtype)
    return process_allgather(mine)


def sharded_backward_search(
    mesh: Mesh, arrays: fm_ops.FMArrays, codes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Data-parallel batched FM search: queries sharded over "data",
    index replicated; each shard runs `backward_search_codes` (one
    lf_pair launch a step on the dense layout) on its own block and the
    hit ranges come back gathered on the host."""
    n_queries = codes.shape[0]
    arrays_r = replicate(mesh, arrays)
    codes_d = shard_batch(mesh, np.ascontiguousarray(codes, dtype=np.int32))
    pending = {}
    for p in mesh.local_positions():
        m = codes_d.valid(mesh, p)
        pending[p] = (m, fm_ops.backward_search_codes(
            arrays_r[p], codes_d.shards[p][:m]))
    rows = {}
    for p, (m, (lo, hi)) in pending.items():
        out = np.zeros((2, codes_d.per), dtype=np.int32)
        out[0, :m] = lo.cpu().numpy()
        out[1, :m] = hi.cpu().numpy()
        rows[p] = out
    both = _gather_rows(mesh, rows, np.zeros((2, codes_d.per), np.int32))
    lo = both[:, 0].reshape(-1)[:n_queries]
    hi = both[:, 1].reshape(-1)[:n_queries]
    return lo, hi


def make_train_step(mesh: Mesh) -> Callable:
    """The engine's "training step" analogue: one sharded iteration of
    the query pipeline — batched backward search over the data axis plus
    a summed gocc-statistics reduction (the reference's atomic counters,
    ref: traverser_base.hpp:103-268, as a reduction over shards and
    processes). step(arrays_r, codes_d) takes `replicate`d arrays and a
    `shard_batch`ed code batch and returns (counts, a ShardedArray of
    per-shard device counts, padding rows 0; total_occ; nonzero)."""

    def step(arrays_r: list, codes_d: ShardedArray):
        counts = [None] * mesh.size
        for p in mesh.local_positions():
            m = codes_d.valid(mesh, p)
            codes_p = codes_d.shards[p]
            lo, hi = fm_ops.backward_search_codes(arrays_r[p], codes_p[:m])
            c = torch.zeros(codes_p.shape[0], dtype=torch.int32,
                            device=codes_p.device)
            c[:m] = hi - lo
            counts[p] = c
        stats = np.zeros(2, dtype=np.int64)
        for p in mesh.local_positions():
            c = counts[p]
            stats += np.array([int(c.sum()), int((c > 0).sum())])
        total_occ, nonzero = process_sum(stats)
        return (ShardedArray(counts, codes_d.n, codes_d.per, codes_d.axis),
                int(total_occ), int(nonzero))

    return step


class ShardedPreparedTrie(NamedTuple):
    """Per-device trie plans (the multi-device analogue of
    fm_trie.PreparedTrie; built on the producer thread by
    SeedFinder.prepare_onpath when a mesh is active). The plain wire
    only: psi_tpu's packed, delta and nibble wires shrink the upload over
    a tunnelled TPU link and are not ported (ROADMAP.md item 11). Entry p
    of the tensor lists is flat mesh position p's plan on its device
    (None at other processes' positions)."""

    parents: list      # int32 [L, Npad] per position
    chars: list
    lo0: list          # int32 [Npad] per position
    hi0: list
    leaf_perms: Tuple[np.ndarray, ...]
    sizes: Tuple[int, ...]
    per: int
    n: int


def prepare_trie_sharded(
    mesh: Mesh,
    keys: np.ndarray,
    k: int,
    n_text: int,
    ftab: Optional[np.ndarray] = None,
    wire: Optional[str] = None,
) -> ShardedPreparedTrie:
    """Split sorted distinct keys into contiguous per-device chunks
    (each stays sorted/pattern-orderable) and build one trie plan per
    shard this process owns with a COMMON pad width, on the shard's
    device (`fm_trie.prepare`, which returns once the plan is complete
    there). Thread-safe (producer thread). Other processes' shards get
    only their leaf permutation, which the gathered results need."""
    if wire not in (None, "plain"):
        raise ValueError(f"wire {wire!r}: only the plain wire is ported "
                         "(ROADMAP.md item 11)")
    D = mesh.shape["data"]
    N = len(keys)
    per = -(-N // D)
    Npad = fm_trie.NPAD_MIN
    while Npad < per:
        Npad *= 2

    def chunk(d):
        c = keys[d * per: (d + 1) * per]
        # empty shards (N < D) run a 1-key dummy plan; its results are
        # discarded by sizes[d] == 0
        return (c if len(c) else keys[-1:]), len(c)

    parents, chars, lo0, hi0 = ([None] * D for _ in range(4))
    perms, sizes = [], []
    for d in range(D):
        c, size = chunk(d)
        sizes.append(size)
        if not mesh.is_local(d):
            perms.append(fm_trie.build_schedule(c, k).leaf_perm)
            continue
        dev = mesh.device(d)
        plan = fm_trie.prepare(c, k, ftab, device=dev, npad=Npad)
        perms.append(plan.leaf_perm)
        parents[d], chars[d] = plan.parents, plan.chars
        npad = plan.parents.shape[1]
        lo0[d] = (plan.lo0 if plan.lo0 is not None else torch.zeros(
            npad, dtype=torch.int32, device=dev))
        hi0[d] = (plan.hi0 if plan.hi0 is not None else torch.full(
            (npad,), n_text, dtype=torch.int32, device=dev))
    return ShardedPreparedTrie(
        parents=parents, chars=chars, lo0=lo0, hi0=hi0,
        leaf_perms=tuple(perms), sizes=tuple(sizes), per=per, n=N,
    )


def _sharded_trie_device(
    mesh: Mesh,
    arrays_r: list,
    prepared: ShardedPreparedTrie,
    with_counts: bool = False,
):
    """The trie level kernels over every local shard's plan (one
    trie_level launch a level a shard, all issued before any result is
    read). Returns per-position lists (lo, hi[, counts]) of device leaf
    ranges in pattern order, None at other processes' positions: the
    results stay on the device for chaining."""
    lo_l, hi_l, cnt_l = ([None] * mesh.size for _ in range(3))
    for p in mesh.local_positions():
        lo, hi = fm_trie._trie_device(
            arrays_r[p], prepared.parents[p], prepared.chars[p],
            prepared.lo0[p], prepared.hi0[p],
        )
        lo_l[p], hi_l[p] = lo, hi
        if with_counts:
            cnt_l[p] = hi - lo
    return (lo_l, hi_l, cnt_l) if with_counts else (lo_l, hi_l)


def sharded_trie_search(
    mesh: Mesh,
    stream_arrays,
    keys: np.ndarray,
    k: int,
    ftab: Optional[np.ndarray] = None,
    prepared: Optional[ShardedPreparedTrie] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Data-parallel trie-batched search (ops/fm_trie.py): sorted
    distinct keys split into contiguous per-device chunks (each stays
    sorted), per-shard plans (optionally ftab-seeded), index replicated;
    every shard runs the level kernels on its device.

    Returns (lo, hi) int32 [N] in key order. This IS the on-path route
    when SeedFinder runs with a multi-device mesh (ref:
    src/psikt.cpp:183-209 chunk loop, scaled out per SURVEY §2.3)."""
    if prepared is None:
        prepared = prepare_trie_sharded(
            mesh, keys, k, stream_arrays.n, ftab
        )
    D = mesh.shape["data"]
    N = prepared.n
    per = prepared.per
    arrays_r = replicate(mesh, stream_arrays)
    lo_d, hi_d = _sharded_trie_device(mesh, arrays_r, prepared)
    local = mesh.local_positions()
    npad = lo_d[local[0]].shape[0] if local else 0
    rows = {p: np.stack([lo_d[p].cpu().numpy(), hi_d[p].cpu().numpy()])
            for p in local}
    both = _gather_rows(mesh, rows, np.zeros((2, npad), np.int32))
    out_lo = np.empty(N, dtype=np.int32)
    out_hi = np.empty(N, dtype=np.int32)
    for d in range(D):
        if prepared.sizes[d]:
            sl = slice(d * per, d * per + prepared.sizes[d])
            out_lo[sl] = both[d, 0][prepared.leaf_perms[d]]
            out_hi[sl] = both[d, 1][prepared.leaf_perms[d]]
    return out_lo, out_hi


def sharded_expand_locate(
    mesh: Mesh,
    sa_r: list,
    str_starts_r: list,
    lengths_r: list,
    seq_off_r: list,
    lo_d: list,
    hi_d: list,
    n_leaves: np.ndarray,
    thr: int,
    k: int,
    cap: int,
    local_only: bool = False,
):
    """The device-chained occurrence expansion + locate, per shard: each
    device expands its own device-resident (lo, hi) ranges against its
    copy of the SA and downloads one int32 global position per hit.
    Returns np int32 [D, cap]; with `local_only` returns (gpos [D, cap]
    filled for this process's shards, local_ds bool [D]) and skips the
    cross-process gather."""
    D = mesh.shape["data"]
    n_leaves = np.asarray(n_leaves).reshape(D)
    pending = {}
    for p in mesh.local_positions():
        gpos, _ = fm_trie.expand_locate(
            sa_r[p], str_starts_r[p], lengths_r[p], seq_off_r[p],
            lo_d[p], hi_d[p], int(n_leaves[p]), thr, k, cap,
        )
        pending[p] = gpos
    rows = {p: run_stats.download(g).numpy().astype(np.int32)
            for p, g in pending.items()}
    if local_only:
        # process-sharded emission: this process's shards only; the
        # caller joins/emits its key slice and the merged hit stream is
        # the concatenation of the processes' disjoint streams
        out = np.zeros((D, cap), dtype=np.int32)
        local_ds = np.zeros(D, dtype=bool)
        for p, r in rows.items():
            out[p] = r
            local_ds[p] = True
        return out, local_ds
    return _gather_rows(mesh, rows, np.zeros(cap, np.int32))


def sharded_traverse_dispatch(
    mesh: Mesh,
    graph_arrays,
    seeds_arrays,
    start_nodes: np.ndarray,
    start_offs: np.ndarray,
    k: int,
    cap_local: int,
    max_mm: int = 0,
):
    """Dispatch the data-parallel off-path traversal: starting loci split
    into contiguous per-device chunks; every shard runs the frontier
    traversal (ops/traverse.py: one traverse_step launch a step, or with
    max_mm one range_refine4 a step) over its loci against its copy of
    the graph and seed index. The per-locus fork trees are independent,
    so results concatenate exactly (HOT LOOP #2 scaled out, ref:
    traverser_bfs.hpp:72-164). The k steps of every shard are queued
    without a host sync, so the device work overlaps whatever the host
    does before `sharded_traverse_collect`. Returns an opaque handle."""
    D = mesh.shape["data"]
    n = len(start_nodes)
    per = max(-(-n // D), 1)
    g_r = replicate(mesh, graph_arrays)
    sa_r = replicate(mesh, seeds_arrays)
    packed = [None] * D
    for d in mesh.local_positions():
        c = slice(d * per, min((d + 1) * per, n))
        m = max(c.stop - c.start, 0)
        loci = np.zeros((2, cap_local), dtype=np.int32)
        loci[0, :m] = start_nodes[c]
        loci[1, :m] = start_offs[c]
        dev = mesh.device(d)
        sn, so = (run_stats.upload(torch.from_numpy(a), dev) for a in loci)
        packed[d] = trav.traverse_device_packed(
            g_r[d], sa_r[d], sn, so, m, k, cap_local, max_mm)
    return (packed, D, per, cap_local, mesh)


def sharded_traverse_collect(pending, local_only: bool = False):
    """Fetch a sharded_traverse_dispatch result. Returns (locus_idx
    [global ids], lo, hi, n_used[D], overflow[D], tstats[D, 3],
    local_ds bool [D]) with per-shard arrays of width cap_local.

    With `local_only` on a multi-process mesh, the bulk survivor payloads
    (li/lo/hi) stay this process's (local_ds marks its shards) — each
    process then emits only its loci shard's hits and the merged stream
    is the concatenation of disjoint per-process streams. The small
    control arrays (n_used, overflow, tstats) are still gathered: the
    overflow retry is a global decision (every process re-dispatches)
    and the traversal stats stay globally consistent."""
    packed, D, per, cap, mesh = pending
    rows = {d: run_stats.download(p).numpy() for d, p in enumerate(packed)
            if p is not None}
    ctl = _gather_rows(mesh, {d: r[3 * cap:] for d, r in rows.items()},
                       np.zeros(5, np.int64))
    nu = ctl[:, 0].astype(np.int32)
    ov = ctl[:, 1].astype(bool)
    ts = ctl[:, 2:]
    if local_only:
        bulk = np.zeros((D, 3 * cap), dtype=np.int64)
        local_ds = np.zeros(D, dtype=bool)
        for d, r in rows.items():
            bulk[d] = r[: 3 * cap]
            local_ds[d] = True
    else:
        bulk = _gather_rows(mesh, {d: r[: 3 * cap] for d, r in rows.items()},
                            np.zeros(3 * cap, np.int64))
        local_ds = np.ones(D, dtype=bool)
    li = bulk[:, :cap].astype(np.int32)
    lo = bulk[:, cap: 2 * cap].astype(np.int32)
    hi = bulk[:, 2 * cap:].astype(np.int32)
    # locus indices are shard-local: rebase to global locus ids
    li = li + (np.arange(D, dtype=np.int32) * per)[:, None]
    return li, lo, hi, nu, ov, ts, local_ds


def sharded_traverse(
    mesh: Mesh,
    graph_arrays,
    seeds_arrays,
    start_nodes: np.ndarray,
    start_offs: np.ndarray,
    k: int,
    cap_local: int,
    max_mm: int = 0,
):
    """Synchronous dispatch + collect (see sharded_traverse_dispatch)."""
    return sharded_traverse_collect(sharded_traverse_dispatch(
        mesh, graph_arrays, seeds_arrays, start_nodes, start_offs,
        k, cap_local, max_mm,
    ))

