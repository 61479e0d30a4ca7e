"""FM-index state on the device: prefix table, dense SA, locus mapping.

Counterpart of the parts of psi_tpu/ops/fm.py the trie route uses:
`build_ftab` (host table of SA ranges for every length-p prefix, which
seeds the trie frontier), the dense int32 SA upload of `to_device`, and
`map_to_device` (the arrays that map an SA position to a global path
position).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from psi_tpu_torch.fmindex import FMIndex


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
    """Device-resident FM state the trie route reads: the dense SA."""

    sa: torch.Tensor  # int32 [n]


def to_device(fm: FMIndex, device: torch.device) -> FMArrays:
    if fm.size >= 1 << 31:
        raise ValueError(
            f"index of {fm.size} chars: int32 positions need < 2^31"
        )
    sa = torch.from_numpy(fm.sa.astype(np.int32)).to(device)
    return FMArrays(sa=sa)


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
