"""psi_tpu state -> this package's tensors.

Each function takes one of psi_tpu's state objects with its arrays
readable as numpy (`np.asarray` works on device arrays without importing
jax) and returns the counterpart on `device`. The parity tests feed both
packages identical state through here.
"""

from __future__ import annotations

import numpy as np
import torch

from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_stream, fm_trie


def _np(a) -> np.ndarray:
    """A writable, contiguous host copy (device arrays read back
    read-only)."""
    return np.array(a, order="C")


def _t(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_np(a)).to(device)


def stream_arrays(src, device: torch.device) -> fm_stream.StreamArrays:
    """psi_tpu StreamArrays -> StreamArrays: payloadT, and the rank
    records payloadR and per-char words payloadC built from it (psi_tpu's
    payloadW, None there past its VMEM budget, holds the same words and
    is not read)."""
    return fm_stream.stream_arrays_from_host(
        _np(src.payloadT), _np(src.C), src.n, device
    )


def prepared_trie(src, device: torch.device) -> fm_trie.PreparedTrie:
    """A plain-wire psi_tpu PreparedTrie (`prepare(..., wire="plain",
    pack=False)`) -> PreparedTrie."""
    if src.parents is None or src.chars is None:
        raise ValueError("only the plain wire format converts (parents/chars)")
    return fm_trie.PreparedTrie(
        parents=_t(src.parents, device),
        chars=_t(src.chars, device),
        lo0=None if src.lo0 is None else _t(src.lo0, device),
        hi0=None if src.hi0 is None else _t(src.hi0, device),
        leaf_perm=_np(src.leaf_perm).astype(np.int64),
        n=int(src.n),
    )


def fm_sa(src, device: torch.device) -> torch.Tensor:
    """psi_tpu FMArrays -> the dense int32 SA."""
    return _t(_np(src.sa).astype(np.int32), device)


def fm_arrays(src, device: torch.device) -> fm_ops.FMArrays:
    """psi_tpu FMArrays -> FMArrays, every layout it holds and the ftab.
    The bit planes' uint32 words are kept as int32 of the same bits."""

    def opt(a, dtype=None):
        if a is None:
            return None
        a = _np(a)
        return _t(a if dtype is None else a.view(dtype), device)

    return fm_ops.FMArrays(
        bwt_blocks=_t(src.bwt_blocks, device),
        occ=_t(src.occ, device),
        C=_t(src.C, device),
        sa=fm_sa(src, device),
        n=int(src.n),
        occ_dense=opt(src.occ_dense),
        planes=opt(src.planes, np.int32),
        ftab=opt(src.ftab),
    )


def map_arrays(src, device: torch.device) -> fm_ops.MapArrays:
    """psi_tpu MapArrays -> MapArrays."""
    return fm_ops.map_arrays_from_host(
        *(_np(a) for a in (src.str_starts, src.lengths, src.seq_off,
                           src.starts, src.ids, src.base)),
        device=device,
    )
