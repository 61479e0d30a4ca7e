"""FM-index state on the device and the batched FM gather route.

Counterpart of psi_tpu/ops/fm.py, all of it: the prefix table
(`build_ftab`), the device layouts (`to_device`), batched rank, backward
search over code rows, the lockstep MEM automaton (`find_mems_device`),
locate and the SA-position -> (node, offset) mapping.

Three rank layouts, as in psi_tpu:
  * checkpointed: occ rows every BLOCK (128) positions + BWT byte blocks
    for the intra-block count;
  * bit-plane: occ rows + the BWT's three bit planes packed 32 positions a
    word, [nblocks+1, 3, 4] (uint32 bits held in int32);
  * dense: the full per-position occ table [n+1, 4] int32; one LF step
    of lo and hi is one launch of csrc/occ_gather.cu's psi_occ_lf_pair
    (ops/fm_pallas.lf_pair).

Everything but the dense step is plain PyTorch: in psi_tpu it is XLA
code, not Pallas. Unsigned words are widened to int64 and masked to 32
bits, as the kernels' plain versions do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from psi_tpu_torch.device import resolve
from psi_tpu_torch.fmindex import BLOCK, SIGMA, FMIndex
from psi_tpu_torch.ops import fm_pallas
from psi_tpu_torch.ops.fm_stream import popcount32

WORDS = BLOCK // 32
_U32 = 0xFFFFFFFF


def build_ftab(fm: FMIndex, p: int) -> np.ndarray:
    """SA ranges for every length-p ACGT prefix, int32 [4**p, 2]; key
    layout matches the packed k-mers (first char most significant).
    Built on the host by level extension: the length-(j+1) ranges are
    one LF step from the length-j ranges (searchsorted over per-symbol
    BWT position lists)."""
    if not 1 <= p <= 14:
        raise ValueError(f"ftab depth {p} out of range (4**p rows)")
    C = fm.C.astype(np.int64)
    pos = [np.flatnonzero(fm.bwt == c) for c in range(1, 5)]
    lo = C[1:5].copy()
    hi = C[2:6].copy()
    for _ in range(p - 1):
        nl = np.empty(4 * lo.shape[0], dtype=np.int64)
        nh = np.empty_like(nl)
        for ci in range(4):
            # new index 4*i + ci <=> slice(ci, None, 4); rank(c, i) =
            # C-offset + #positions of c before i (monotone, so empty
            # ranges stay empty with no alive mask)
            nl[ci::4] = C[ci + 1] + np.searchsorted(pos[ci], lo)
            nh[ci::4] = C[ci + 1] + np.searchsorted(pos[ci], hi)
        lo, hi = nl, nh
    return np.stack([lo, hi], axis=1).astype(np.int32)


class FMArrays(NamedTuple):
    """Device-resident FM index (psi_tpu's fields, in its order)."""

    bwt_blocks: torch.Tensor  # uint8 [nblocks+1, BLOCK] (padded with 255)
    occ: torch.Tensor         # int32 [nblocks+1, SIGMA]
    C: torch.Tensor           # int32 [SIGMA+1]
    sa: torch.Tensor          # int32 [n]
    n: int                    # text length
    occ_dense: Optional[torch.Tensor] = None  # int32 [n+1, 4] (ACGT only)
    planes: Optional[torch.Tensor] = None     # int32 [nblocks+1, 3, WORDS]
    ftab: Optional[torch.Tensor] = None       # int32 [4**p, 2]


def sa_to_device(fm: FMIndex, device: torch.device) -> torch.Tensor:
    """The dense int32 SA on `device` (all the trie route reads)."""
    if fm.size >= 1 << 31:
        raise ValueError(
            f"index of {fm.size} chars: int32 positions need < 2^31"
        )
    return torch.from_numpy(fm.sa.astype(np.int32)).to(device)


def _bitplanes(bwt_pad: np.ndarray, nblocks: int) -> np.ndarray:
    """uint32 [nblocks+1, 3, WORDS]: bit p of the symbol at block
    position i -> word i//32, bit i%32."""
    sym = bwt_pad.reshape(-1, BLOCK).astype(np.uint32)
    planes = np.zeros((nblocks + 1, 3, WORDS), dtype=np.uint32)
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for p in range(3):
        bits = ((sym >> p) & 1).reshape(nblocks + 1, WORDS, 32)
        planes[:, p, :] = (bits * weights[None, None, :]).sum(
            axis=2, dtype=np.uint32
        )
    return planes


def to_device(
    fm: FMIndex,
    device: torch.device,
    dense_occ: bool = False,
    bitplanes: bool = False,
    ftab_bits: int = 0,
    sa: torch.Tensor | None = None,
) -> FMArrays:
    """The FM index on `device`: always the checkpointed layout and the
    SA (pass `sa` to reuse one already there), plus the dense occ table
    and/or the bit planes on request, and the ftab at depth `ftab_bits`.
    The dense table is built on the device from the 1-byte BWT (a cumsum
    per symbol), so only n bytes cross the bus, not 16 n."""
    if sa is None:
        sa = sa_to_device(fm, device)
    n = fm.size
    nblocks = (n + BLOCK - 1) // BLOCK
    # one spare block: position n (range end) may index block nblocks
    bwt_pad = np.full((nblocks + 1) * BLOCK, 255, dtype=np.uint8)
    bwt_pad[:n] = fm.bwt
    bwt_d = torch.from_numpy(bwt_pad).to(device)
    occ_dense = None
    if dense_occ:
        occ_dense = torch.zeros((n + 1, 4), dtype=torch.int32, device=device)
        for c in range(1, 5):  # ACGT codes
            occ_dense[1:, c - 1] = torch.cumsum(bwt_d[:n] == c, 0,
                                                dtype=torch.int32)
    planes = None
    if bitplanes:
        planes = torch.from_numpy(
            _bitplanes(bwt_pad, nblocks).view(np.int32)).to(device)
    arrays = FMArrays(
        bwt_blocks=bwt_d.reshape(nblocks + 1, BLOCK),
        occ=torch.from_numpy(fm.occ.astype(np.int32)).to(device),
        C=torch.from_numpy(fm.C.astype(np.int32)).to(device),
        sa=sa,
        n=n,
        occ_dense=occ_dense,
        planes=planes,
    )
    if ftab_bits and n and fm.sigma == SIGMA:
        arrays = arrays._replace(
            ftab=torch.from_numpy(build_ftab(fm, ftab_bits)).to(device))
    return arrays


def _rank_bitplane(arrays: FMArrays, c: torch.Tensor,
                   i: torch.Tensor) -> torch.Tensor:
    """Batched rank via bit-plane popcount. c, i int32 [N]."""
    b = (i // BLOCK).long()
    cl = c.long()
    base = arrays.occ[b, cl]
    rows = arrays.planes[b].long() & _U32              # [N, 3, WORDS]
    match = torch.full_like(rows[:, 0, :], _U32)
    for p in range(3):
        bit = ((cl >> p) & 1).bool()[:, None]
        plane = rows[:, p, :]
        match &= torch.where(bit, plane, ~plane & _U32)
    # prefix mask for position r = i % BLOCK
    r = (i % BLOCK).long()[:, None]
    widx = torch.arange(WORDS, device=i.device)[None, :]
    full = torch.where(widx < r // 32, _U32, 0)
    partial = torch.where(widx == r // 32, (1 << (r % 32)) - 1, 0)
    counts = popcount32(match & (full | partial))
    return base + counts.sum(dim=1).to(torch.int32)


def _rank(arrays: FMArrays, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Batched rank: # of symbol c in bwt[0:i]. c, i: int32 [N]."""
    b = (i // BLOCK).long()
    base = arrays.occ[b, c.long()]
    block = arrays.bwt_blocks[b]                        # [N, BLOCK]
    within = (torch.arange(BLOCK, dtype=torch.int32, device=i.device)[None, :]
              < (i % BLOCK)[:, None])
    hits = (block == c[:, None].to(torch.uint8)) & within
    return base + hits.sum(dim=1, dtype=torch.int32)


def _rank_fn(arrays: FMArrays):
    """Batched rank of the bit-plane or checkpointed layout. The dense
    layout has no single-position rank here: `_lf_pair` steps lo and hi
    together there, in one lf_pair launch."""
    if arrays.planes is not None:
        return lambda c, i: _rank_bitplane(arrays, c, i)
    return lambda c, i: _rank(arrays, c, i)


def _lf_pair(arrays: FMArrays, c: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LF step of lo and hi, (C[c] + rank(c, lo), C[c] + rank(c, hi)),
    on the best layout the arrays hold (dense, bit-plane, checkpointed)."""
    if arrays.occ_dense is not None:
        return fm_pallas.lf_pair(arrays.occ_dense, arrays.C, c, lo, hi)
    rank = _rank_fn(arrays)
    base = arrays.C[c.long()]
    return base + rank(c, lo), base + rank(c, hi)


def backward_search_codes(
    arrays: FMArrays, codes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """SA ranges for a batch of k-mers given as an int32 code matrix
    [N, k] of ACGT codes 1..4 (others raise), consumed in FORWARD
    character order (the reversed-text path index). The first p columns
    come from the ftab when it is there and p <= k; every further column
    is one LF step of lo and hi, with no liveness mask (an empty range
    stays empty). Returns (lo, hi) int32 [N]; empty ranges have lo == hi
    at an unspecified value (compare hi - lo, and lo only where hi > lo).
    """
    fm_pallas.check_codes(codes)
    N, k = codes.shape
    dev = codes.device
    lo = torch.zeros(N, dtype=torch.int32, device=dev)
    hi = torch.full((N,), arrays.n, dtype=torch.int32, device=dev)
    rest = codes
    if arrays.ftab is not None:
        p = (arrays.ftab.shape[0].bit_length() - 1) // 2
        if 0 < p <= k:
            # codes are 1..4, so every prefix has its ftab row (psi_tpu
            # masks non-ACGT prefixes to an empty range instead)
            weights = 4 ** torch.arange(p - 1, -1, -1, device=dev)
            pk = ((codes[:, :p].long() - 1) * weights[None, :]).sum(dim=1)
            start = arrays.ftab[pk]
            lo = start[:, 0].contiguous()
            hi = start[:, 1].contiguous()
            rest = codes[:, p:]
    for c in rest.t().contiguous():
        lo, hi = _lf_pair(arrays, c, lo, hi)
    return lo, hi


def find_mems_device(
    arrays: FMArrays,
    codes: torch.Tensor,   # int32 [N, L]: FM codes 1..4; 0 = 'N' or pad
    rlens: torch.Tensor,   # int32 [N] read lengths
    k: int,                # minimum MEM length
    thr: int,              # gocc threshold (big value = unlimited)
    max_mem: int,          # occurrence cap per read (big = unlimited)
    max_out: int,          # MEM record slots per read
):
    """Batched find_mems: every read runs the reference's MEM automaton
    (sliding start; descend per char; emit the range once plen >= k and
    count <= threshold; restart after a hit / mismatch / 'N';
    ref: include/psi/index_iter.hpp:854-906), one lockstep step per
    cursor position, so L steps cover the whole batch. Each step is one
    LF step of every read's (lo, hi): one lf_pair launch on the dense
    layout.

    Returns (out_lo, out_hi, out_start, out_plen int32 [N, max_out],
    nout int32 [N], overflow bool 0-d). A read can emit at most
    ceil(L / (k+1)) + 1 MEMs; overflow reports max_out exhaustion."""
    N, L = codes.shape
    n = arrays.n
    dev = codes.device
    i32 = torch.int32
    jslots = torch.arange(max_out, dtype=i32, device=dev)[None, :]
    rows = torch.arange(N, device=dev)
    z = torch.zeros(N, dtype=i32, device=dev)
    start, plen, lo, nout, occ_tot = z, z, z, z, z
    hi = torch.full((N,), n, dtype=i32, device=dev)
    finished = torch.zeros(N, dtype=torch.bool, device=dev)
    buf = torch.zeros((N, max_out), dtype=i32, device=dev)
    out_lo, out_hi, out_start, out_plen = buf, buf, buf, buf
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    zero, full = torch.zeros_like(lo), torch.full_like(hi, n)

    for _ in range(L):
        cursor = start + plen
        alive = ~finished & (cursor < rlens)
        count = hi - lo
        emit = alive & (plen >= k) & (count <= thr)
        slot_hit = emit[:, None] & (jslots == nout[:, None])
        out_lo = torch.where(slot_hit, lo[:, None], out_lo)
        out_hi = torch.where(slot_hit, hi[:, None], out_hi)
        out_start = torch.where(slot_hit, start[:, None], out_start)
        out_plen = torch.where(slot_hit, plen[:, None], out_plen)
        overflow = overflow | (emit & (nout >= max_out)).any()
        nout = nout + emit.to(i32)
        occ_tot = occ_tot + torch.where(emit, count, zero)
        finished = finished | (emit & (occ_tot >= max_mem))

        ch = codes[rows, cursor.clamp(max=L - 1).long()]
        restart = alive & (emit | (ch == 0))
        c = ch.clamp(1, 4)
        nlo, nhi = _lf_pair(arrays, c, lo, hi)
        fail = alive & ~restart & (nlo >= nhi)
        reset = restart | fail
        start = torch.where(reset, cursor + 1, start)
        plen = torch.where(reset, zero, torch.where(alive, plen + 1, plen))
        lo = torch.where(reset, zero, torch.where(alive, nlo, lo))
        hi = torch.where(reset, full, torch.where(alive, nhi, hi))
    return out_lo, out_hi, out_start, out_plen, nout, overflow


def keys_to_codes(keys: np.ndarray, k: int) -> np.ndarray:
    """Host: unpack uint64 keys to an int32 [N, k] FM-code matrix (1..4)."""
    shifts = (2 * (k - 1 - np.arange(k, dtype=np.uint64))).astype(np.uint64)
    return (((keys[:, None] >> shifts[None, :]) & np.uint64(3)) + 1).astype(
        np.int32
    )


def locate_ranges(
    arrays: FMArrays, lo: torch.Tensor, hi: torch.Tensor, max_width: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather text positions for SA ranges, padded to max_width per query.

    Returns (positions int32 [N, max_width], mask bool [N, max_width]).
    Dense-SA design: locate is a single gather (no LF walk)."""
    widths = hi - lo
    j = torch.arange(max_width, dtype=torch.int32, device=lo.device)[None, :]
    mask = j < widths[:, None]
    idx = (lo[:, None] + j).clamp(0, arrays.sa.shape[0] - 1)
    return arrays.sa[idx.long()], mask


def count_kmers_device(fm: FMIndex, keys: np.ndarray, k: int,
                       device: torch.device | str | None = None
                       ) -> np.ndarray:
    """Convenience host wrapper: counts for packed k-mers, on the card
    unless `device` names the CPU."""
    dev = resolve("cuda") if device is None else torch.device(device)
    arrays = to_device(fm, dev)
    codes = torch.from_numpy(keys_to_codes(keys, k)).to(dev)
    lo, hi = backward_search_codes(arrays, codes)
    return (hi - lo).cpu().numpy()


# --- device-side locate + SA-position -> graph-locus mapping -----------------
#
# The batched equivalent of PathIndex::position_to_id/position_to_offset
# (ref: pathindex.hpp:360-416 incl. the Reversed-text end-position fixup):
# SA gather, string-id binary search, forward-offset flip, and node
# rank/select (ref: path_interface.hpp:172-197).


class MapArrays(NamedTuple):
    """Device-resident SA-position -> (node_id, node_offset) mapping."""

    str_starts: torch.Tensor  # int32 [m+1] flat-text start of each string
    lengths: torch.Tensor     # int32 [m]   string lengths (no sentinel)
    seq_off: torch.Tensor     # int32 [m+1] forward global seq offset per path
    starts: torch.Tensor      # int32 [E]   global seq start per path-node entry
    ids: torch.Tensor         # int32 [E]   node id per entry
    base: torch.Tensor        # int32 [E]   head-offset base per entry


def _i32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)


def map_arrays_from_host(str_starts, lengths, seq_off, starts, ids, base,
                         device: torch.device) -> MapArrays:
    return MapArrays(*(_i32(a, device) for a in (
        str_starts, lengths, seq_off, starts, ids, base)))


def map_to_device(fm: FMIndex, path_map: dict,
                  device: torch.device) -> MapArrays:
    return map_arrays_from_host(
        fm.str_starts, fm.lengths, path_map["seq_off"], path_map["starts"],
        path_map["ids"], path_map["base"], device,
    )


def locate_map_device(
    arrays: FMArrays, maps: MapArrays, sa_idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Map absolute SA indices (int32 [T]) to (node_id, node_offset) int32
    [T] on the device. k = match length used in the reversed-text
    end-position flip (ref: pathindex.hpp:378-387). psi_tpu pads sa_idx
    to power-of-two buckets to bound its compiled shapes; eager PyTorch
    needs no padding."""
    pos = arrays.sa[sa_idx.long()]
    sid = torch.searchsorted(maps.str_starts, pos, right=True) - 1
    q = pos - maps.str_starts[sid]
    fwd = maps.lengths[sid] - q - k
    gpos = maps.seq_off[sid] + fwd
    entry = torch.searchsorted(maps.starts, gpos, right=True) - 1
    node_id = maps.ids[entry]
    node_off = gpos - maps.starts[entry] + maps.base[entry]
    return node_id, node_off
