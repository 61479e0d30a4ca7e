"""Trie level extension over the per-char rank words: the main path.

Counterpart of psi_tpu/ops/fm_fused.py. There, one Pallas launch runs
every level with payload and frontier resident in VMEM. Here
`trie_level` runs one level per launch of csrc/trie_level.cu (two
children per thread) and `trie_fused` chains the levels, ping-ponging
the frontier between two buffer pairs. Per child i with parent slot p and
char c:

    lo'[i] = C[c] + rank_c(lo[p]),  hi'[i] = C[c] + rank_c(hi[p])
    rank_c(pos) = occ + popcount(match & ((1 << pos%32) - 1))

where (occ, match) = payloadC[c-1, pos >> 5] (ops/fm_stream.py).
`trie_level` runs its plain PyTorch version for CPU tensors and launches
the kernel for CUDA tensors, counting those launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from psi_tpu_torch import _build
from psi_tpu_torch.ops.fm_stream import (
    StreamArrays, below_mask, check_char_words, check_vectors, popcount32,
)

_TRIE_LEVEL_ARGTYPES = [ctypes.c_void_p, ctypes.c_int] + \
    [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]


def _rank(payloadC: torch.Tensor, c: torch.Tensor,
          pos: torch.Tensor) -> torch.Tensor:
    """rank(c, pos) from the (occ_c, match_c) word of pos's block."""
    word = payloadC[c - 1, (pos >> 5).long()]           # [M, 2]
    match = word[:, 1].long() & 0xFFFFFFFF
    return word[:, 0] + popcount32(match & below_mask(pos)).to(torch.int32)


def trie_level_plain(payloadC: torch.Tensor, C: torch.Tensor,
                     parent: torch.Tensor, char: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of csrc/trie_level.cu: one level's children
    (lo', hi') from the parent frontier (lo, hi)."""
    p = parent.long()
    c = char.long()
    base = C[c]
    return base + _rank(payloadC, c, lo[p]), base + _rank(payloadC, c, hi[p])


def trie_level(payloadC: torch.Tensor, C: torch.Tensor,
               parent: torch.Tensor, char: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor,
               out_lo: torch.Tensor, out_hi: torch.Tensor) -> None:
    """One level: writes the children of frontier (lo, hi) into
    (out_lo, out_hi). payloadC is the [4, NBpad, 2] table of per-char rank
    words; parent/char are int32 [M]; the outputs must not alias the
    inputs. On the card, payloadC, parent, char and the outputs must be
    8-byte aligned (a fresh tensor, or a row of a [levels, Npad]
    schedule, is)."""
    dev = parent.device
    if dev.type == "cpu":
        new_lo, new_hi = trie_level_plain(payloadC, C, parent, char, lo, hi)
        out_lo.copy_(new_lo)
        out_hi.copy_(new_hi)
        return
    if dev.type != "cuda":
        raise ValueError(f"trie_level: unsupported device {dev}")
    check_char_words("trie_level", payloadC, dev)
    check_vectors("trie_level", dev,
                  pairs=("parent", "char", "out_lo", "out_hi"),
                  parent=parent, char=char, out_lo=out_lo, out_hi=out_hi)
    check_vectors("trie_level", dev, lo=lo, hi=hi)
    _build.check_int32("trie_level", dev, C=C)
    m = parent.shape[0]
    _build.launch(
        "psi_trie_level", _TRIE_LEVEL_ARGTYPES, dev,
        payloadC.data_ptr(), payloadC.shape[1], C.data_ptr(),
        parent.data_ptr(), char.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        out_lo.data_ptr(), out_hi.data_ptr(), m, _build.stream_ptr(dev),
    )
    trie_level.launches += 1


trie_level.launches = 0


def trie_fused(arrays: StreamArrays, parents: torch.Tensor,
               chars: torch.Tensor, lo0: torch.Tensor, hi0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-trie level extension, one `trie_level` per level. parents /
    chars int32 [levels, Npad], lo0/hi0 the seeded frontier [Npad].
    Returns the leaf (lo, hi) in pattern order (psi_tpu's contract)."""
    bufs = [(torch.empty_like(lo0), torch.empty_like(hi0)) for _ in range(2)]
    lo, hi = lo0, hi0
    for j in range(parents.shape[0]):
        out_lo, out_hi = bufs[j % 2]
        trie_level(arrays.payloadC, arrays.C, parents[j], chars[j], lo, hi,
                   out_lo, out_hi)
        lo, hi = out_lo, out_hi
    return lo, hi
