"""Off-path route: the crossing-seed graph traversal (counterpart of
psi_tpu/ops/traverse.py, with the same names).

A frontier of states advances over the graph one character per step for
every state, while the reads side is a range (lo, hi) over the chunk's
sorted packed seed keys, narrowed per depth by a rank over that depth's
2-bit plane words (records.SeedsIndex). Semantics (ref:
traverser_bfs.hpp:72-164 + traverser_base.hpp:103-268): one state per
starting locus, a fork per out-edge at a node end, 'N' kills, death on a
failed descent, one hit per (state x matching seed) with gocc = the match
count. Three forms:

  * the WalkTree: the graph walk from the starting loci (forks, labels,
    'N' kills) is fixed per index, so it is enumerated once and each chunk
    reduces to prefix probes of the chunk's sorted seed keys, on the host
    (`walks_match`, NumPy) or on a torch device (`walks_match_device`);
  * `traverse_device`, the gather-compacted frontier at a fixed cap, k
    steps queued without a host sync, and `traverse_device_approx`, its
    mismatch-tolerant form (a fork per read character, a budget);
  * `traverse_host`, the host mirror of the BFS automaton, exact and with
    mismatches.

Kernel, behind wrappers that run the plain PyTorch version for CPU
tensors, launch the kernel for CUDA tensors (raising on any other device)
and count those launches in `.launches`:

  traverse_step         csrc/traverse_step.cu         one whole step of
                                                      traverse_device
  range_refine4         csrc/range_refine.cu          lo', hi' of all four
                                                      chars
  traverse_step_approx  csrc/traverse_step_approx.cu  the rest of a step of
                                                      traverse_device_approx

psi_tpu's `_range_refine` and `traverse_device` are plain XLA; the port
has kernels for them because torch has no popcount operator, so the plain
versions spend some tens of device operations per step on what one launch
does, and because eager torch pays a launch for each of the ~45 operations
of a step. `traverse_device` runs `traverse_step`, fork, rank and
compaction in one launch; `range_refine_plain`, psi_tpu's
`_range_refine`, is the rank of its plain version `traverse_step_plain`.
`traverse_device_approx` runs `range_refine4` over the parent state and
`traverse_step_approx`, the fork, the label, the four-char fork under the
budget and the compaction, in place of the ~96 operations of its plain
step `traverse_step_approx_plain`.

Departures from psi_tpu:
  * `walks_match` probes the upper end of a prefix range as
    `klo + (width - 1)` with side="right". At k=32 the first level's
    `klo + width` wraps past 2^64 for prefixes starting with T, which made
    psi_tpu's WalkTree drop states its device traversal keeps (R1 in
    ROADMAP.md); for k < 32 both forms give the same bound.
  * TraverserStats are counted in int64, where psi_tpu's int32 wraps once
    a chunk's summed ended-path lengths pass 2^31 (R6), and
    `traverse_device_packed` is an int64 vector for that reason.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from psi_tpu_torch import _build, stats
from psi_tpu_torch.graph import Graph, Position
from psi_tpu_torch.ops.fm_stream import below_mask, popcount32
from psi_tpu_torch.records import BLOCK, SeedsIndex

#: largest WalkTree (total nodes) built before the route gives up
NODE_CAP = 1 << 23
_U32 = 0xFFFFFFFF
_SIGN = np.uint64(1 << 63)


class GraphArrays(NamedTuple):
    """Device-resident graph: concatenated label codes + CSR adjacency."""

    labels: torch.Tensor         # int32 [total_loci] codes: 0..3 = ACGT, 4 = N
    label_offsets: torch.Tensor  # int32 [n+1]
    out_indptr: torch.Tensor     # int32 [n+1]
    out_indices: torch.Tensor    # int32 [m] (1-based node ids)
    max_out: int                 # max outdegree


def graph_to_device(graph: Graph, device) -> GraphArrays:
    """The graph's labels, label offsets and edges as int32 on `device`;
    raises for a label text of 2^31 chars or more, whose offsets int32
    cannot hold."""
    from psi_tpu_torch.ops.kmers import ACGT_CODE

    if len(graph.labels) >= 1 << 31:
        raise ValueError(f"graph of {len(graph.labels)} label chars: int32 "
                         f"label offsets need < 2^31")
    codes = ACGT_CODE[graph.labels].astype(np.int32)
    codes[codes < 0] = 4  # N and unknowns kill states
    outdeg = np.diff(graph.out_indptr)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            device)

    return GraphArrays(
        labels=up(codes),
        label_offsets=up(graph.label_offsets),
        out_indptr=up(graph.out_indptr),
        out_indices=up(graph.out_indices),
        max_out=int(outdeg.max()) if len(outdeg) else 0,
    )


# --- the WalkTree ---------------------------------------------------------

class WalkTree(NamedTuple):
    """Chunk-independent unpruned state tree from the starting loci."""

    k: int
    n_init: int
    ccount0: np.ndarray        # int64 [n_init] child count of each locus state
    parent: tuple              # per depth: int32 [m_t] -> prev structural slot
    okn: tuple                 # per depth: bool [m_t] ('N'-free children)
    klo: tuple                 # per depth: uint64 [m_t] prefix range start
    ccount: tuple              # per depth: int64 [s_t] over structural survivors
    locus: np.ndarray          # int32 [s_{k-1}] locus of each complete walk
    n_nodes: int               # total tree nodes (diagnostics)


def enumerate_walks(
    graph: Graph,
    start_nodes: np.ndarray,
    start_offs: np.ndarray,
    k: int,
    node_cap: int = NODE_CAP,
) -> WalkTree | None:
    """Host enumeration of the unpruned k-step state tree. Returns None
    when the tree exceeds `node_cap` nodes (callers then run the pruned
    per-chunk device traversal)."""
    from psi_tpu_torch.ops.kmers import ACGT_CODE

    codes = ACGT_CODE[graph.labels].astype(np.int64)
    codes[codes < 0] = 4
    loff = graph.label_offsets.astype(np.int64)
    iptr = graph.out_indptr.astype(np.int64)
    oidx = graph.out_indices.astype(np.int64)

    node = start_nodes.astype(np.int64)
    off = start_offs.astype(np.int64)
    n_init = len(node)
    locus = np.arange(n_init, dtype=np.int32)
    key = np.zeros(n_init, dtype=np.uint64)

    parents, okns, klos, ccounts = [], [], [], []
    ccount0 = None
    total = 0
    for t in range(k):
        nlen = loff[node] - loff[node - 1]
        at_end = off >= nlen
        outdeg = iptr[node] - iptr[node - 1]
        counts = np.where(at_end, outdeg, 1)
        if t == 0:
            ccount0 = counts.astype(np.int64)
        else:
            ccounts.append(counts.astype(np.int64))
        base = np.cumsum(counts) - counts
        m = int(counts.sum())
        total += m
        if total > node_cap:
            return None
        parent = np.repeat(
            np.arange(len(node), dtype=np.int64), counts
        )
        j = np.arange(m, dtype=np.int64) - base[parent]
        p_end = at_end[parent]
        nb = oidx[
            np.clip(iptr[node[parent] - 1] + j, 0, max(len(oidx) - 1, 0))
        ] if len(oidx) else np.zeros(m, dtype=np.int64)
        cnode = np.where(p_end, nb, node[parent])
        coff = np.where(p_end, 0, off[parent])
        c = codes[loff[np.maximum(cnode, 1) - 1] + coff]
        ok = c < 4
        ckey = (key[parent] << np.uint64(2)) | np.where(
            ok, c, 0
        ).astype(np.uint64)
        parents.append(parent.astype(np.int32))
        okns.append(ok)
        klos.append(ckey << np.uint64(2 * (k - t - 1)))
        # structural survivors advance
        node = cnode[ok]
        off = coff[ok] + 1
        locus = locus[parent[ok]]
        key = ckey[ok]
    return WalkTree(
        k=k, n_init=n_init, ccount0=ccount0,
        parent=tuple(parents), okn=tuple(okns), klo=tuple(klos),
        ccount=tuple(ccounts), locus=locus, n_nodes=total,
    )


def _prefix_last(k: int, t: int) -> np.uint64:
    """width - 1 of a depth-t prefix range: the low 2(k-t-1) key bits."""
    return (np.uint64(1) << np.uint64(2 * (k - t - 1))) - np.uint64(1)


def walks_match(tree: WalkTree, sorted_keys: np.ndarray):
    """Per-chunk evaluation of a WalkTree against the chunk's sorted
    uint64 seed keys: returns (locus_idx, lo, hi, gd, ended, ended_len),
    the surviving states and TraverserStats of the pruned traversal. The
    host form, kept as the reference of `walks_match_device`."""
    k = tree.k
    alive = np.ones(tree.n_init, dtype=bool)
    gd = ended = ended_len = 0
    lo_t = hi_t = None
    for t in range(k):
        ccount_prev = tree.ccount0 if t == 0 else tree.ccount[t - 1]
        attempted = int(ccount_prev[alive].sum())
        klo = tree.klo[t]
        lo_t = np.searchsorted(sorted_keys, klo, side="left")
        hi_t = np.searchsorted(sorted_keys, klo + _prefix_last(k, t),
                               side="right")
        alive_child = (
            tree.okn[t] & alive[tree.parent[t]] & (lo_t < hi_t)
        )
        survivors = int(alive_child.sum())
        gd += attempted
        ended += attempted - survivors
        ended_len += (attempted - survivors) * (t + 1)
        alive = alive_child[tree.okn[t]]
    sel = tree.okn[k - 1]
    return (
        tree.locus[alive],
        lo_t[sel][alive].astype(np.int64),
        hi_t[sel][alive].astype(np.int64),
        gd, ended, ended_len,
    )


class DeviceWalkTree(NamedTuple):
    """A WalkTree on a torch device (`tree_to_device`), built once per
    loci set. Keys are uint64 mapped to int64 by flipping the top bit,
    which keeps their order (k=32 keys set it)."""

    k: int
    n_init: int
    ccount: tuple      # int64 [n_init] then per depth 1..k-1 [s_{t-1}]
    parent: tuple      # per depth: int64 [m_t]
    okn: tuple         # per depth: bool [m_t]
    okn_idx: tuple     # per depth: int64 [s_t], the indices of okn
    key_lo: tuple      # per depth: int64 [m_t], mapped klo
    key_hi: tuple      # per depth: int64 [m_t], mapped klo + (width - 1)
    locus: np.ndarray  # int32 [s_{k-1}] (host)


def _order_map(keys: np.ndarray) -> np.ndarray:
    """uint64 -> int64 with the same order: x ^ (1 << 63)."""
    return (np.asarray(keys, dtype=np.uint64) ^ _SIGN).view(np.int64)


def tree_to_device(tree: WalkTree, device) -> DeviceWalkTree:
    def up(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    k = tree.k
    return DeviceWalkTree(
        k=k, n_init=tree.n_init,
        ccount=tuple(up(c, np.int64) for c in (tree.ccount0, *tree.ccount)),
        parent=tuple(up(p, np.int64) for p in tree.parent),
        okn=tuple(up(o) for o in tree.okn),
        okn_idx=tuple(up(np.flatnonzero(o), np.int64) for o in tree.okn),
        key_lo=tuple(up(_order_map(klo)) for klo in tree.klo),
        key_hi=tuple(up(_order_map(klo + _prefix_last(k, t)))
                     for t, klo in enumerate(tree.klo)),
        locus=tree.locus,
    )


def walks_match_device(tree: DeviceWalkTree, sorted_keys: np.ndarray):
    """`walks_match` on the tree's device: one upload of the chunk's
    mapped keys, two `torch.searchsorted` per depth, the TraverserStats
    as masked sums on the device, and one download at the end. Same
    returns as `walks_match`."""
    ccount0 = tree.ccount[0]
    dev = ccount0.device
    k = tree.k
    keys = stats.upload(torch.from_numpy(_order_map(sorted_keys)), dev)
    alive = torch.ones(tree.n_init, dtype=torch.bool, device=dev)
    tstats = torch.zeros(3, dtype=torch.int64, device=dev)
    lo_t = hi_t = None
    for t in range(k):
        attempted = (tree.ccount[t] * alive).sum()
        lo_t = torch.searchsorted(keys, tree.key_lo[t])
        hi_t = torch.searchsorted(keys, tree.key_hi[t], right=True)
        alive_child = tree.okn[t] & alive[tree.parent[t]] & (lo_t < hi_t)
        dead = attempted - alive_child.sum()
        tstats = tstats + torch.stack([attempted, dead, dead * (t + 1)])
        alive = alive_child[tree.okn_idx[t]]
    sel = tree.okn_idx[k - 1]
    packed = stats.download(
        torch.cat([alive.long(), lo_t[sel], hi_t[sel], tstats])).numpy()
    s = len(sel)
    emit = packed[:s].astype(bool)
    gd, ended, ended_len = (int(v) for v in packed[3 * s:])
    return (
        tree.locus[emit],
        packed[s: 2 * s][emit],
        packed[2 * s: 3 * s][emit],
        gd, ended, ended_len,
    )


# --- the reads side on the device ------------------------------------------

class SeedsArrays(NamedTuple):
    """Device-resident reads-side index (see SeedsIndex)."""

    occ: torch.Tensor     # int32 [k, nb+1, 4] rank checkpoints
    planes: torch.Tensor  # int32 [k, nb+1, 2] per-depth 2-bit plane words
    size: int             # V


def _char_words(p0: torch.Tensor, p1: torch.Tensor, c: int) -> torch.Tensor:
    """Bit i set iff char c sits at offset i (p0/p1 as int64 in
    [0, 2^32): bit 0 of the code in p0, bit 1 in p1)."""
    return ((p0 if c & 1 else ~p0 & _U32)
            & (p1 if c >> 1 else ~p1 & _U32))


def occ_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """Rank checkpoints derived on the device from the plane words (an
    exclusive cumsum of per-block popcounts), as psi_tpu derives them to
    save 2/3 of the per-chunk seeds upload. Exact for every consulted
    row: occ[b] is only read for b <= V // BLOCK, and blocks before that
    are full."""
    p0 = planes[..., 0].long() & _U32
    p1 = planes[..., 1].long() & _U32
    outs = []
    for c in range(4):
        csum = torch.cumsum(popcount32(_char_words(p0, p1, c)), dim=1)
        outs.append(torch.cat([torch.zeros_like(csum[:, :1]),
                               csum[:, :-1]], dim=1))
    return torch.stack(outs, dim=-1).to(torch.int32)


def seeds_to_device(index: SeedsIndex, device) -> SeedsArrays:
    planes = stats.upload(
        torch.from_numpy(np.ascontiguousarray(index.planes)), device)
    return SeedsArrays(occ=occ_from_planes(planes), planes=planes,
                       size=index.size)


# --- range refine: the traversal's rank step ---------------------------------

_REFINE4_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int] + [ctypes.c_void_p] * 4 + [
                     ctypes.c_int, ctypes.c_void_p]


def range_refine4_plain(seeds: SeedsArrays, depth: int, lo: torch.Tensor,
                        hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of csrc/range_refine.cu's psi_range_refine4:
    (lo', hi'), int32 [N, 4], the narrowing of every int32 [lo, hi) by
    each char 0..3 at `depth`. Rank = occ checkpoint + masked popcount of
    the block's two plane words (psi_tpu/ops/traverse.py::_range_refine
    for the four chars)."""
    occ_d = seeds.occ[depth]                      # [nb+1, 4]
    planes_d = seeds.planes[depth]                # [nb+1, 2]

    def counts_at(i):
        """#(chars_d[0:i) == c') for all 4 c' -> [N, 4]."""
        b = (i // BLOCK).long()
        pw = planes_d[b].long() & _U32
        mask = below_mask(i)
        pc = torch.stack([popcount32(_char_words(pw[:, 0], pw[:, 1], c)
                                     & mask) for c in range(4)], dim=1)
        return occ_d[b] + pc.to(torch.int32)

    in_range = counts_at(hi) - counts_at(lo)      # [N, 4] counts per char
    lt = (torch.cumsum(in_range, dim=1) - in_range).to(torch.int32)
    new_lo = lo[:, None] + lt                     # chars < c' come first
    return new_lo, new_lo + in_range


def range_refine_plain(seeds: SeedsArrays, depth: int, lo: torch.Tensor,
                       hi: torch.Tensor, c: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """psi_tpu's `_range_refine`: [lo, hi) narrowed by char c (0..3) per
    state, int32 [N] each; the rank of `traverse_step_plain`, which
    csrc/traverse_step.cu fuses on the card."""
    lo4, hi4 = range_refine4_plain(seeds, depth, lo, hi)
    col = c.long()[:, None]
    return lo4.gather(1, col)[:, 0], hi4.gather(1, col)[:, 0]


def _check_refine(name: str, seeds: SeedsArrays, depth: int,
                  dev: torch.device, **vectors) -> None:
    """The seeds tables and the state vectors for a range-refine kernel:
    contiguous int32 on `dev`, occ [k, R, 4] 16-byte and planes [k, R, 2]
    8-byte aligned (one load each per block), vectors [N] of one shape."""
    _build.check_int32(name, dev, occ=seeds.occ, planes=seeds.planes,
                       **vectors)
    occ, planes = seeds.occ, seeds.planes
    if (occ.dim() != 3 or occ.shape[2] != 4 or planes.dim() != 3
            or planes.shape[2] != 2 or planes.shape[:2] != occ.shape[:2]):
        raise ValueError(f"{name}: occ must be [k, R, 4] and planes [k, R, 2]")
    if occ.data_ptr() % 16 or planes.data_ptr() % 8:
        raise ValueError(f"{name}: occ or planes is not aligned")
    if not 0 <= depth < occ.shape[0]:
        raise ValueError(f"{name}: depth {depth} outside [0, {occ.shape[0]})")
    shapes = {t.shape for t in vectors.values()}
    if len(shapes) > 1 or any(len(s) != 1 for s in shapes):
        raise ValueError(f"{name}: {', '.join(vectors)} must be [N] each")


def range_refine4(seeds: SeedsArrays, depth: int, lo: torch.Tensor,
                  hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) narrowed by each char 0..3 at `depth`, per state: (lo',
    hi'), int32 [N, 4] each, in one launch."""
    dev = lo.device
    if dev.type == "cpu":
        return range_refine4_plain(seeds, depth, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"range_refine4: unsupported device {dev}")
    _check_refine("range_refine4", seeds, depth, dev, lo=lo, hi=hi)
    n = lo.shape[0]
    lo4 = torch.empty((n, 4), dtype=torch.int32, device=dev)
    hi4 = torch.empty((n, 4), dtype=torch.int32, device=dev)
    if n == 0:
        return lo4, hi4
    _build.launch(
        "psi_range_refine4", _REFINE4_ARGTYPES, dev,
        seeds.occ.data_ptr(), seeds.planes.data_ptr(), seeds.occ.shape[1],
        depth, lo.data_ptr(), hi.data_ptr(), lo4.data_ptr(), hi4.data_ptr(),
        n, _build.stream_ptr(dev),
    )
    range_refine4.launches += 1
    return lo4, hi4


range_refine4.launches = 0


# --- the frontier traversal ------------------------------------------------

def _fork(g: GraphArrays, node, off, n_used, slot, cap):
    """The graph-edge fork shared by both traversals: every state in use
    expands into `count` children (1 mid-node, the outdegree at a node
    end), placed by an exclusive prefix sum; the inverse slot -> parent
    map is a searchsorted. Every index is clipped as psi_tpu clips it, so
    padding slots gather in bounds. Returns (new_n, parent slot per
    child, at_end per parent, the child's node and offset, valid)."""
    in_use = slot < n_used
    safe_node = node.clamp(min=1).long()
    node_len = g.label_offsets[safe_node] - g.label_offsets[safe_node - 1]
    at_end = in_use & (off >= node_len)
    outdeg = g.out_indptr[safe_node] - g.out_indptr[safe_node - 1]
    counts = torch.where(in_use, torch.where(at_end, outdeg, 1), 0)
    csum = torch.cumsum(counts, dim=0)            # int64
    base = csum - counts                          # exclusive prefix sum
    new_n = csum[-1]
    parent = torch.searchsorted(csum, slot, right=True).clamp(0, cap - 1)
    j = slot - base[parent]
    valid = slot < new_n
    p_at_end = at_end[parent]
    p_node = node[parent].clamp(min=1).long()
    n_edges = g.out_indices.shape[0]
    if n_edges:
        nb = g.out_indices[
            (g.out_indptr[p_node - 1] + j).clamp(0, n_edges - 1)]
    else:
        nb = torch.zeros_like(node)
    new_node = torch.where(p_at_end, nb, node[parent])
    new_off = torch.where(p_at_end, 0, off[parent])
    return new_n, parent, new_node, new_off, valid


def _label(g: GraphArrays, node, off):
    """The label code at (node, off), the position clipped into labels."""
    sn = node.clamp(min=1).long()
    pos = (g.label_offsets[sn - 1] + off).clamp(0, g.labels.shape[0] - 1)
    return g.labels[pos.long()]


class TraverseState(NamedTuple):
    """The exact traversal's state between steps, on one device: the
    frontier (slots < n_used in use, the rest padding), the overflow flag
    and the TraverserStats so far."""

    locus_idx: torch.Tensor  # int32 [cap] starting locus of each state
    node: torch.Tensor       # int32 [cap]
    off: torch.Tensor        # int32 [cap] offset of the next char
    lo: torch.Tensor         # int32 [cap] seeds range
    hi: torch.Tensor         # int32 [cap]
    overflow: torch.Tensor   # bool 0-d: some step had more children than cap
    tstats: torch.Tensor     # int64 [3]: go-downs, ended, summed lengths


def traverse_step_plain(g: GraphArrays, seeds: SeedsArrays, t: int,
                        state: TraverseState, n_used, cap: int):
    """Plain PyTorch version of csrc/traverse_step.cu: step t of
    `traverse_device`. Every state in use expands into its children
    (`_fork`), consumes one label character (`_label`, then the rank
    `range_refine_plain`), and the states it kills are dropped by a second
    prefix sum and searchsorted, order kept; slots >= n2 take the values
    of child slot cap - 1. `n_used` is an int or an int64 0-d tensor.
    Returns (state, new_n, n2), the counts int64 0-d tensors."""
    slot = torch.arange(cap, dtype=torch.int64, device=state.lo.device)
    new_n, parent, new_node, new_off, valid = _fork(g, state.node, state.off,
                                                    n_used, slot, cap)
    overflow = state.overflow | (new_n > cap)
    c = _label(g, new_node, new_off)
    ok = valid & (c < 4)  # 'N' kills
    r_lo, r_hi = range_refine_plain(seeds, t, state.lo[parent],
                                    state.hi[parent], c.clamp(0, 3))
    ok = ok & (r_lo < r_hi)

    # second compaction pass: for each slot s < n2, the s-th ok state
    csum2 = torch.cumsum(ok, dim=0)
    n2 = csum2[-1]
    src = torch.searchsorted(csum2, slot + 1).clamp(0, cap - 1)
    attempted = new_n.clamp(max=cap)
    ended = attempted - n2
    return TraverseState(
        locus_idx=state.locus_idx[parent][src],
        node=new_node[src],
        off=new_off[src] + 1,
        lo=r_lo[src],
        hi=r_hi[src],
        overflow=overflow,
        tstats=state.tstats + torch.stack([attempted, ended, ended * (t + 1)]),
    ), new_n, n2


_STEP_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                  + [ctypes.c_int] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
                  + [ctypes.c_int, ctypes.c_void_p])
_scratch_lock = threading.Lock()
#: the step kernels' scratch per (entry, device index, stream pointer)
_scratch: dict = {}


def _step_scratch(dev: torch.device, cap: int,
                  entry: str = "psi_traverse_step") -> torch.Tensor:
    """The scratch of kernel `entry` on `dev` for the current stream:
    zeroed once, left zeroed by every launch (so launches of the kernel
    on one stream share it), grown when a larger cap needs more."""
    words = -(-_build.call(f"{entry}_scratch_bytes",
                           [ctypes.c_int], ctypes.c_longlong, cap) // 8)
    key = (entry, dev.index, _build.stream_ptr(dev))
    with _scratch_lock:
        buf = _scratch.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.zeros(words, dtype=torch.int64, device=dev)
            _scratch[key] = buf
    return buf


def _check_step(g: GraphArrays, seeds: SeedsArrays, t: int,
                state: TraverseState, n_used: torch.Tensor, cap: int,
                dev: torch.device) -> None:
    """The graph and the state for traverse_step's kernel: contiguous
    int32 on `dev`, the state arrays [cap], n_used an int64 and overflow
    a bool 0-d tensor, tstats int64 [3]; the seeds tables as for
    range_refine4."""
    if not 0 < cap < 1 << 31:
        raise ValueError(f"traverse_step: cap {cap} outside [1, 2^31)")
    _build.check_int32("traverse_step", dev, labels=g.labels,
                       label_offsets=g.label_offsets,
                       out_indptr=g.out_indptr, out_indices=g.out_indices)
    if g.labels.numel() == 0 or g.label_offsets.numel() < 2:
        raise ValueError("traverse_step: the graph has no labels")
    _check_refine("traverse_step", seeds, t, dev, locus_idx=state.locus_idx,
                  node=state.node, off=state.off, lo=state.lo, hi=state.hi)
    if state.lo.shape != (cap,):
        raise ValueError(f"traverse_step: the state arrays must be [{cap}]")
    for name, x, dtype, shape in (
            ("n_used", n_used, torch.int64, ()),
            ("overflow", state.overflow, torch.bool, ()),
            ("tstats", state.tstats, torch.int64, (3,))):
        if (x.device != dev or x.dtype != dtype or x.shape != shape
                or not x.is_contiguous()):
            raise ValueError(f"traverse_step: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}")


def traverse_step(g: GraphArrays, seeds: SeedsArrays, t: int,
                  state: TraverseState, n_used, cap: int):
    """Step t of the exact traversal: (state, new_n, n2) as
    `traverse_step_plain` gives them, for `n_used` an int or an int64
    0-d tensor. On a CUDA device in one launch, which reads n_used and
    leaves every count on the device (no host sync)."""
    dev = state.lo.device
    if dev.type == "cpu":
        return traverse_step_plain(g, seeds, t, state, n_used, cap)
    if dev.type != "cuda":
        raise ValueError(f"traverse_step: unsupported device {dev}")
    if not isinstance(n_used, torch.Tensor):
        n_used = torch.full((), n_used, dtype=torch.int64, device=dev)
    _check_step(g, seeds, t, state, n_used, cap, dev)
    out = torch.empty((5, cap), dtype=torch.int32, device=dev)
    counts = torch.empty(5, dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    scratch = _step_scratch(dev, cap)
    _build.launch(
        "psi_traverse_step", _STEP_ARGTYPES, dev,
        g.labels.data_ptr(), g.labels.numel(), g.label_offsets.data_ptr(),
        g.out_indptr.data_ptr(), g.out_indices.data_ptr(),
        g.out_indices.numel(), seeds.occ.data_ptr(),
        seeds.planes.data_ptr(), seeds.occ.shape[1], t,
        state.locus_idx.data_ptr(), state.node.data_ptr(),
        state.off.data_ptr(), state.lo.data_ptr(), state.hi.data_ptr(),
        n_used.data_ptr(), state.overflow.data_ptr(),
        state.tstats.data_ptr(), out.data_ptr(), counts.data_ptr(),
        overflow.data_ptr(), scratch.data_ptr(), cap,
        _build.stream_ptr(dev),
    )
    traverse_step.launches += 1
    return (TraverseState(*out.unbind(0), overflow=overflow,
                          tstats=counts[2:]), counts[0], counts[1])


traverse_step.launches = 0


def traverse_device(
    g: GraphArrays,
    seeds: SeedsArrays,
    start_nodes: torch.Tensor,  # int32 [cap], zero-padded beyond n_init
    start_offs: torch.Tensor,   # int32 [cap]
    n_init: int,                # number of seeded states
    k: int,
    cap: int,
):
    """Advance a frontier of states k characters over the graph.

    Gather-based frontier rebuild per step (no scatters), one
    `traverse_step` a step: every state expands into its children,
    consumes one label character, and the states it kills are dropped,
    order kept. Every array stays at `cap` and every count on the device,
    so the k steps queue without a host sync.

    Returns (locus_idx, lo, hi, n_used, overflow, tstats) on the device;
    slots < n_used are the surviving matches. tstats = int64 [3]: go-down
    ops (attempted descents incl. failed), ended-path count, summed
    ended-path lengths (survivors count as length-k paths and are added by
    the caller).
    """
    dev = start_nodes.device
    state = TraverseState(
        locus_idx=torch.arange(cap, dtype=torch.int32, device=dev),
        node=start_nodes,
        off=start_offs,
        lo=torch.zeros(cap, dtype=torch.int32, device=dev),
        hi=torch.full((cap,), seeds.size, dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        tstats=torch.zeros(3, dtype=torch.int64, device=dev),
    )
    n_used = n_init
    for t in range(k):
        state, _, n_used = traverse_step(g, seeds, t, state, n_used, cap)
    n_used = torch.as_tensor(n_used, device=dev).to(torch.int32)
    return (state.locus_idx, state.lo, state.hi, n_used, state.overflow,
            state.tstats)


class ApproxState(NamedTuple):
    """The mismatch-tolerant traversal's state between steps, on one
    device: the frontier (slots < n_used in use, the rest padding) with
    each state's remaining mismatch budget, and the overflow flag."""

    locus_idx: torch.Tensor  # int32 [cap] starting locus of each state
    node: torch.Tensor       # int32 [cap]
    off: torch.Tensor        # int32 [cap] offset of the next char
    lo: torch.Tensor         # int32 [cap] seeds range
    hi: torch.Tensor         # int32 [cap]
    budget: torch.Tensor     # int32 [cap] substitutions still allowed
    overflow: torch.Tensor   # bool 0-d: some step had more children than cap


def traverse_step_approx_plain(g: GraphArrays, seeds: SeedsArrays, t: int,
                               state: ApproxState, n_used, cap: int):
    """Plain PyTorch version of csrc/traverse_step_approx.cu: step t of
    `traverse_device_approx`. Every state in use expands into its graph
    children (`_fork`), each takes one label char (`_label`; 'N' kills)
    and forks into a child per read char c' whose range (`range_refine4`
    over the children's [lo, hi)) is not empty and whose cost (c' differs
    from the label) the budget covers; the survivors fill the slots in
    (graph child, char) order by a second prefix sum and searchsorted,
    the char picked by a rank-select over each child's 4-bit mask. Slots
    >= n2 take the values of graph child slot cap - 1 with char 0.
    `n_used` is an int or an int64 0-d tensor. Returns (state, new_n, n2),
    the counts int64 0-d tensors."""
    dev = state.lo.device
    slot = torch.arange(cap, dtype=torch.int64, device=dev)
    chars = torch.arange(4, dtype=torch.int32, device=dev)
    # phase 1: graph-edge fork/compaction (as the exact traversal)
    new_n, parent, node1, off1, valid = _fork(g, state.node, state.off,
                                              n_used, slot, cap)
    overflow = state.overflow | (new_n > cap)
    bud1 = state.budget[parent]

    # phase 2: character fork, a child per read character c'
    gc = _label(g, node1, off1)
    alive1 = valid & (gc < 4)  # 'N' kills
    los, his = range_refine4(seeds, t, state.lo[parent], state.hi[parent])
    cost = (chars[None, :] != gc.clamp(0, 3)[:, None]).to(torch.int32)
    child_ok = alive1[:, None] & (los < his) & (bud1[:, None] >= cost)
    ccounts = child_ok.sum(dim=1)
    csum2 = torch.cumsum(ccounts, dim=0)
    base2 = csum2 - ccounts
    n2 = csum2[-1]
    overflow = overflow | (n2 > cap)

    parent2 = torch.searchsorted(csum2, slot, right=True).clamp(0, cap - 1)
    j2 = slot - base2[parent2]
    # the j2-th valid char of parent2: rank-select over the 4-bit mask,
    # argmax of an int mask giving the first true index
    ok_row = child_ok[parent2].to(torch.int32)            # [cap, 4]
    prefix = torch.cumsum(ok_row, dim=1) - ok_row         # exclusive
    sel = torch.argmax(((prefix == j2[:, None]) & (ok_row > 0)).to(
        torch.int32), dim=1)
    return ApproxState(
        locus_idx=state.locus_idx[parent][parent2],
        node=node1[parent2],
        off=off1[parent2] + 1,
        lo=los[parent2, sel],
        hi=his[parent2, sel],
        budget=bud1[parent2] - cost[parent2, sel],
        overflow=overflow,
    ), new_n, n2


_APPROX_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                    + [ctypes.c_int] + [ctypes.c_void_p] * 12
                    + [ctypes.c_int, ctypes.c_void_p])


def _check_step_approx(g: GraphArrays, state: ApproxState,
                       n_used: torch.Tensor, cap: int,
                       dev: torch.device) -> None:
    """The graph and the state for traverse_step_approx's kernel:
    contiguous int32 on `dev`, the state arrays [cap], n_used an int64
    and overflow a bool 0-d tensor (range_refine4 checks the seeds
    tables, lo and hi)."""
    if not 0 < cap < 1 << 31:
        raise ValueError(f"traverse_step_approx: cap {cap} outside "
                         f"[1, 2^31)")
    _build.check_int32("traverse_step_approx", dev, labels=g.labels,
                       label_offsets=g.label_offsets,
                       out_indptr=g.out_indptr, out_indices=g.out_indices,
                       **{f: getattr(state, f) for f in ApproxState._fields
                          if f != "overflow"})
    if g.labels.numel() == 0 or g.label_offsets.numel() < 2:
        raise ValueError("traverse_step_approx: the graph has no labels")
    if any(getattr(state, f).shape != (cap,) for f in ApproxState._fields
           if f != "overflow"):
        raise ValueError(f"traverse_step_approx: the state arrays must be "
                         f"[{cap}]")
    for name, x, dtype in (("n_used", n_used, torch.int64),
                           ("overflow", state.overflow, torch.bool)):
        if (x.device != dev or x.dtype != dtype or x.shape != ()
                or not x.is_contiguous()):
            raise ValueError(f"traverse_step_approx: {name} must be a "
                             f"contiguous {dtype} 0-d tensor on {dev}")


def traverse_step_approx(g: GraphArrays, seeds: SeedsArrays, t: int,
                         state: ApproxState, n_used, cap: int):
    """Step t of the mismatch-tolerant traversal: (state, new_n, n2) as
    `traverse_step_approx_plain` gives them, for `n_used` an int or an
    int64 0-d tensor. On a CUDA device in two launches: `range_refine4`
    over the parent state (every graph child inherits its parent's [lo,
    hi), so the parent's row is the rank the plain step takes at each of
    its children), then csrc/traverse_step_approx.cu's kernel, which
    reads n_used and leaves every count on the device (no host sync)."""
    dev = state.lo.device
    if dev.type == "cpu":
        return traverse_step_approx_plain(g, seeds, t, state, n_used, cap)
    if dev.type != "cuda":
        raise ValueError(f"traverse_step_approx: unsupported device {dev}")
    if not isinstance(n_used, torch.Tensor):
        n_used = torch.full((), n_used, dtype=torch.int64, device=dev)
    _check_step_approx(g, state, n_used, cap, dev)
    lo4, hi4 = range_refine4(seeds, t, state.lo, state.hi)
    out = _launch_step_approx(g, state, lo4, hi4, n_used, cap)
    traverse_step_approx.launches += 1
    stats.count("approx-step-launches", 1)
    return out


traverse_step_approx.launches = 0


def _launch_step_approx(g: GraphArrays, state: ApproxState, lo4: torch.Tensor,
                        hi4: torch.Tensor, n_used: torch.Tensor, cap: int):
    """The kernel of `traverse_step_approx` alone, on checked inputs and
    the parents' range_refine4 rows (lo4, hi4): (state, new_n, n2)."""
    dev = state.lo.device
    out = torch.empty((6, cap), dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    scratch = _step_scratch(dev, cap, "psi_traverse_step_approx")
    _build.launch(
        "psi_traverse_step_approx", _APPROX_ARGTYPES, dev,
        g.labels.data_ptr(), g.labels.numel(), g.label_offsets.data_ptr(),
        g.out_indptr.data_ptr(), g.out_indices.data_ptr(),
        g.out_indices.numel(), state.locus_idx.data_ptr(),
        state.node.data_ptr(), state.off.data_ptr(),
        state.budget.data_ptr(), lo4.data_ptr(), hi4.data_ptr(),
        n_used.data_ptr(), state.overflow.data_ptr(), out.data_ptr(),
        counts.data_ptr(), overflow.data_ptr(), scratch.data_ptr(), cap,
        _build.stream_ptr(dev),
    )
    return (ApproxState(*out.unbind(0), overflow=overflow), counts[0],
            counts[1])


def traverse_device_approx(
    g: GraphArrays,
    seeds: SeedsArrays,
    start_nodes: torch.Tensor,
    start_offs: torch.Tensor,
    n_init: int,
    k: int,
    cap: int,
    max_mm: int,
):
    """Mismatch-tolerant frontier traversal.

    Same gather-compacted schedule as `traverse_device`, but the
    character-consumption phase forks each state into up to four
    children, one per substituted read character, decrementing a
    mismatch budget when the read character differs from the graph
    label: one `traverse_step_approx` a step (on the card a range_refine4
    and one step kernel, every count on the device, so the k steps queue
    without a host sync). Each (walk, seed) pair is reached by exactly
    one leaf.

    Returns (locus_idx, lo, hi, n_used, overflow) on the device.
    """
    dev = start_nodes.device
    state = ApproxState(
        locus_idx=torch.arange(cap, dtype=torch.int32, device=dev),
        node=start_nodes,
        off=start_offs,
        lo=torch.zeros(cap, dtype=torch.int32, device=dev),
        hi=torch.full((cap,), seeds.size, dtype=torch.int32, device=dev),
        budget=torch.full((cap,), max_mm, dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
    )
    n_used = n_init
    for t in range(k):
        state, _, n_used = traverse_step_approx(g, seeds, t, state, n_used,
                                                cap)
    n_used = torch.as_tensor(n_used, device=dev).to(torch.int32)
    return state.locus_idx, state.lo, state.hi, n_used, state.overflow


def traverse_device_packed(
    g: GraphArrays,
    seeds: SeedsArrays,
    start_nodes: torch.Tensor,
    start_offs: torch.Tensor,
    n_init: int,
    k: int,
    cap: int,
    max_mm: int = 0,
) -> torch.Tensor:
    """traverse_device (or, with max_mm, traverse_device_approx with zero
    tstats) with the outputs packed into one int64 vector [3*cap + 5] =
    (locus_idx | lo | hi | n_used, overflow, tstats[3]): one fetch instead
    of six."""
    if max_mm:
        li, lo, hi, nu, ov = traverse_device_approx(
            g, seeds, start_nodes, start_offs, n_init, k, cap, max_mm)
        ts = torch.zeros(3, dtype=torch.int64, device=li.device)
    else:
        li, lo, hi, nu, ov, ts = traverse_device(
            g, seeds, start_nodes, start_offs, n_init, k, cap)
    return torch.cat([li.long(), lo.long(), hi.long(), nu.view(1).long(),
                      ov.view(1).long(), ts])


def traverse(
    graph: Graph,
    g: GraphArrays,
    seeds_arrays: SeedsArrays,
    index: SeedsIndex,
    loci: List[Position],
    k: int,
    cap: int = 1 << 15,
) -> List[Tuple[int, int, int, int, int]]:
    """Device traversal wrapper with overflow retry.

    Returns raw hits (node_id, node_offset, seed_id, gocc, match_len) as
    the host mirror does; ordering is by frontier slot (multiset-equal to
    the reference's emission order).
    """
    if not loci or index.size == 0 or g.max_out == 0:
        return []
    n = len(loci)
    dev = g.labels.device
    while True:
        cap_eff = max(cap, 1 << (n - 1).bit_length())
        start_nodes = np.zeros(cap_eff, dtype=np.int32)
        start_offs = np.zeros(cap_eff, dtype=np.int32)
        for i, l in enumerate(loci):
            start_nodes[i] = l.node_id()
            start_offs[i] = l.offset()
        locus_idx, lo, hi, n_used, overflow, _tstats = traverse_device(
            g, seeds_arrays,
            torch.from_numpy(start_nodes).to(dev),
            torch.from_numpy(start_offs).to(dev),
            n, k, cap_eff,
        )
        if bool(overflow):
            cap = cap_eff * 2
            continue
        n_used = int(n_used)
        locus_idx, lo, hi = (a[:n_used].cpu().numpy()
                             for a in (locus_idx, lo, hi))
        break

    cols = traverse_columnar_from_states(index, loci, locus_idx, lo, hi, k)
    return list(zip(*(c.tolist() for c in cols))) if len(cols[0]) else []


def traverse_columnar_from_states(index, loci, locus_idx, lo, hi, k):
    """Vectorized hit expansion: (node, off, seed_id, gocc, len) columns."""
    widths = (hi - lo).astype(np.int64)
    total = int(widths.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z
    loci_nodes = np.array([l.node_id() for l in loci], dtype=np.int64)
    loci_offs = np.array([l.offset() for l in loci], dtype=np.int64)
    rep = np.repeat(np.arange(len(lo)), widths)
    within = np.arange(total) - np.repeat(np.cumsum(widths) - widths, widths)
    seed_sel = index.seed_ids[lo.astype(np.int64)[rep] + within]
    nodes = loci_nodes[locus_idx[rep]]
    offs = loci_offs[locus_idx[rep]]
    goccs = widths[rep]
    lens = np.full(total, k, dtype=np.int64)
    return nodes, offs, seed_sel, goccs, lens


def traverse_host(
    graph: Graph,
    index: SeedsIndex,
    loci: List[Position],
    k: int,
    max_mismatches: int = 0,
) -> List[Tuple[int, int, int, int, int]]:
    """Host mirror of the reference BFS traverser automaton
    (ref: traverser_bfs.hpp:72-164) over the SeedsIndex trie, extended
    with working mismatch-tolerant matching (the reference *declares*
    ApproxMatching, ref: traverser_base.hpp:98-101, but implements no
    approx traverser — here a state forks per substituted read character,
    consuming mismatch budget; each (walk, seed) pair is reached by
    exactly one leaf, so no duplicate hits arise).

    Returns raw hits (node_id, node_offset, seed_id, gocc, match_len);
    read mapping is applied by the caller. gocc of a hit is the match
    count of its leaf state (exact-matching: all equal seeds).
    """
    out = []
    # state: (start (nid, off), cur (nid, off), depth, lo, hi, budget)
    states = [
        (
            (l.node_id(), l.offset()),
            (l.node_id(), l.offset()),
            0,
            0,
            index.size,
            max_mismatches,
        )
        for l in loci
    ]
    labels = {}  # node -> codes

    def node_codes(nid):
        if nid not in labels:
            from psi_tpu_torch.ops.kmers import ACGT_CODE

            c = ACGT_CODE[
                np.frombuffer(
                    graph.node_sequence(nid).encode("ascii"), dtype=np.uint8
                )
            ].astype(np.int32)
            c[c < 0] = 4
            labels[nid] = c
        return labels[nid]

    while states:
        next_states = []
        for (spos, (nid, off), depth, lo, hi, budget) in states:
            codes = node_codes(nid)
            # consume chars until node end / depth k / death / fork
            dead = False
            forked = False
            while depth < k and off < len(codes):
                c = int(codes[off])
                if c == 4:
                    dead = True
                    break
                if budget > 0:
                    # fork per read character; mismatches consume budget
                    for cprime in range(4):
                        nlo, nhi = index.go_down(lo, hi, depth, cprime)
                        if nlo >= nhi:
                            continue
                        nbudget = budget - (cprime != c)
                        if nbudget < 0:
                            continue
                        next_states.append(
                            (spos, (nid, off + 1), depth + 1, nlo, nhi, nbudget)
                        )
                    forked = True
                    break
                lo, hi = index.go_down(lo, hi, depth, c)
                if lo >= hi:
                    dead = True
                    break
                depth += 1
                off += 1
            if dead or forked:
                continue
            if depth == k:
                gocc = hi - lo
                for sid in index.occurrences(lo, hi):
                    out.append((spos[0], spos[1], int(sid), gocc, k))
                continue
            # node end with depth < k: fork per out-edge
            for nb in graph.out_neighbors(nid):
                next_states.append((spos, (int(nb), 0), depth, lo, hi, budget))
        states = next_states
    return out
