"""Rank payloads, the two-pass level routes and per-query rank.

Counterpart of psi_tpu/ops/fm_stream.py, all of it. The payload layouts
are the same arrays, element for element:

    payloadT [16, NBpad] int32   rows 0..5 = occ checkpoints per symbol
                                 before each 32-position block, rows
                                 6..8 = BWT bit-plane words, rest pad

and `match_format` gives psi_tpu's match-format payloadW [NW, 8, 128]
(occ of A/C/G/T in rows 0..3, per-char match-mask words in rows 4..7,
NW = NBpad / 128) on the host. The port keeps, beside payloadT, two
layouts of its own, payloadW's words regrouped by block and by char:

    payloadR [NBpad, 8] int32    the rank record of each block: row b is
                                 (occ_1..occ_4, match_1..match_4) of block
                                 b; 32 bytes, one L2 sector
    payloadC [4, NBpad, 2] int32 word (c-1, b) is (occ_c, match_c) of
                                 block b: one 8-byte load per rank, four
                                 blocks of one char per sector

No kernel reads payloadW, so it is not kept on the device.

Kernels, each behind a wrapper that runs its plain PyTorch version for
CPU tensors, launches the kernel for CUDA tensors (raising on any other
device) and counts those launches in `.launches`:

  rank4_pair_stream  csrc/rank4_pair.cu  ranks of A/C/G/T at lo and hi
  rank4_stream       csrc/rank4.cu       ranks of A/C/G/T at one array
  compact_children   csrc/compact.cu     child ranges from parent ranks
  rank_stream        csrc/rank.cu        rank(c_i, pos_i) per query
  rank_lf_pair       csrc/rank.cu        one LF step of lo and hi per key

The first three are the passes of the two-pass level route
(ops/fm_trie.py); rank_lf_pair carries `backward_search_sorted`, the
count query over sorted k-mer code rows, one launch per step. rank4_pair
reads payloadT, the rest payloadR; ops/fm_fused.py's trie_level, the main
path, reads payloadC.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from psi_tpu_torch.fmindex import FMIndex
from psi_tpu_torch import _build

SBLOCK = 32            # text positions per checkpoint block
WB = 128               # blocks per payloadW window
PAYLOAD_ROWS = 16      # 6 occ + 3 plane words + pad
_U32 = 0xFFFFFFFF


class StreamArrays(NamedTuple):
    payloadT: torch.Tensor  # int32 [16, NBpad]
    payloadR: torch.Tensor  # int32 [NBpad, 8]
    payloadC: torch.Tensor  # int32 [4, NBpad, 2]
    C: torch.Tensor         # int32 [SIGMA+1]
    n: int                  # text length
    nblocks: int            # real blocks incl. the position-n spare


def payload_host(fm: FMIndex) -> np.ndarray:
    """The checkpointed bit-plane payload [16, nbpad] int32 on the host
    (psi_tpu/ops/fm_stream.py:payload_host): payloadT before its upload,
    and what the single-core baseline (native.fm_backward_batch,
    csrc/host/psi_fm.cpp) reads."""
    n = fm.size
    nblocks = n // SBLOCK + 1  # block of position n always addressable
    nbpad = -(-nblocks // WB) * WB
    payload = np.zeros((PAYLOAD_ROWS, nbpad), dtype=np.int32)
    bwt_pad = np.full(nbpad * SBLOCK, 255, dtype=np.uint8)
    bwt_pad[:n] = fm.bwt
    sym = bwt_pad.reshape(nbpad, SBLOCK)
    for c in range(6):
        counts = np.count_nonzero(sym == c, axis=1)
        payload[c, 1:nblocks] = np.cumsum(counts, dtype=np.int64)[
            : nblocks - 1
        ].astype(np.int32)
    # bit-plane words (pad symbol 255 -> plane bits 1,1,1, distinct from
    # real codes 0..5)
    weights = np.uint32(1) << np.arange(SBLOCK, dtype=np.uint32)
    symu = sym.astype(np.uint32)
    for p in range(3):
        words = (((symu >> p) & 1) * weights[None, :]).sum(
            axis=1, dtype=np.uint32
        )
        payload[6 + p, :] = words.view(np.int32)
    return payload


def match_format(payloadT: np.ndarray) -> np.ndarray:
    """payloadW [NW, 8, 128] from payloadT: occ rows 1..4, then for each
    char c the AND of its three bit planes (bit i of row 4+c-1 set iff
    bwt[blk*32+i] == c; the pad symbol never matches)."""
    nbpad = payloadT.shape[1]
    planes = payloadT[6:9].view(np.uint32)
    wrows = np.empty((8, nbpad), dtype=np.int32)
    wrows[0:4] = payloadT[1:5]
    for c in range(1, 5):
        match = np.full(nbpad, _U32, dtype=np.uint32)
        for p in range(3):
            match &= planes[p] if (c >> p) & 1 else ~planes[p]
        wrows[4 + c - 1] = match.view(np.int32)
    return np.ascontiguousarray(
        wrows.reshape(8, nbpad // WB, WB).transpose(1, 0, 2)
    )


def rank_records(payloadT: np.ndarray) -> np.ndarray:
    """payloadR [NBpad, 8] from payloadT: `match_format`'s eight words of
    each block side by side."""
    return np.ascontiguousarray(
        match_format(payloadT).transpose(0, 2, 1).reshape(-1, 8))


def char_words(records: np.ndarray) -> np.ndarray:
    """payloadC [4, NBpad, 2] from payloadR: each char's (occ, match) word
    pairs, block after block."""
    return np.ascontiguousarray(
        np.stack([records[:, :4].T, records[:, 4:].T], axis=-1))


def stream_arrays_from_host(payloadT: np.ndarray, C: np.ndarray, n: int,
                            device: torch.device) -> StreamArrays:
    """payloadT, payloadR and payloadC on `device` (20, 10 and 10 MB at 10
    Mbp): the main path reads payloadC alone, the other routes payloadR,
    and the two-pass route's rank4_pair payloadT. A fresh device
    allocation is 32-byte aligned, as the kernels' wrappers require."""
    payloadT = np.ascontiguousarray(payloadT, dtype=np.int32)
    records = rank_records(payloadT)
    return StreamArrays(
        payloadT=torch.from_numpy(payloadT).to(device),
        payloadR=torch.from_numpy(records).to(device),
        payloadC=torch.from_numpy(char_words(records)).to(device),
        C=torch.from_numpy(np.asarray(C).astype(np.int32)).to(device),
        n=int(n),
        nblocks=int(n) // SBLOCK + 1,
    )


def build_stream_arrays(fm: FMIndex, device: torch.device) -> StreamArrays:
    if fm.size >= 1 << 31:
        raise ValueError(
            f"index of {fm.size} chars: int32 positions need < 2^31"
        )
    return stream_arrays_from_host(payload_host(fm), fm.C, fm.size, device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR; torch has no
    popcount operator)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


def below_mask(pos: torch.Tensor) -> torch.Tensor:
    """(1 << (pos % 32)) - 1 as int64, exact at offset 31."""
    return (torch.ones_like(pos, dtype=torch.int64) << (pos & 31).long()) - 1


def check_vectors(name: str, dev: torch.device, pairs: tuple = (),
                  **vectors) -> None:
    """Contiguous int32 [M] vectors of one shape on `dev`; those named in
    `pairs` also 8-byte aligned (their kernel loads or stores two items
    at a time)."""
    _build.check_int32(name, dev, **vectors)
    shapes = {t.shape for t in vectors.values()}
    if len(shapes) > 1 or any(len(shape) != 1 for shape in shapes):
        raise ValueError(f"{name}: {', '.join(vectors)} must be [M] each")
    for arg in pairs:
        if vectors[arg].data_ptr() % 8:
            raise ValueError(f"{name}: {arg} is not 8-byte aligned")


def check_records(name: str, payloadR: torch.Tensor,
                  dev: torch.device) -> None:
    """payloadR for a kernel: a contiguous int32 [NBpad, 8] table on
    `dev` whose base is 32-byte aligned (one record is one sector, read
    by 16-byte loads)."""
    _build.check_int32(name, dev, payloadR=payloadR)
    if payloadR.dim() != 2 or payloadR.shape[1] != 8:
        raise ValueError(f"{name}: payloadR must be [NBpad, 8]")
    if payloadR.data_ptr() % 32:
        raise ValueError(f"{name}: payloadR is not 32-byte aligned")


def check_char_words(name: str, payloadC: torch.Tensor,
                     dev: torch.device) -> None:
    """payloadC for a kernel: a contiguous int32 [4, NBpad, 2] table on
    `dev` whose base is 8-byte aligned (one word pair is one load)."""
    _build.check_int32(name, dev, payloadC=payloadC)
    if payloadC.dim() != 3 or payloadC.shape[0] != 4 or payloadC.shape[2] != 2:
        raise ValueError(f"{name}: payloadC must be [4, NBpad, 2]")
    if payloadC.data_ptr() % 8:
        raise ValueError(f"{name}: payloadC is not 8-byte aligned")


# --- rank4_pair: ranks of A/C/G/T at every lo and hi --------------------

_RANK4_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]


def rank4_plain(payloadR: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of csrc/rank4.cu: int32 [4, M] ranks of
    chars 1..4 at each position, from the records of payloadR."""
    rec = payloadR[(pos >> 5).long()]                # [M, 8]
    match = rec[:, 4:].long() & _U32
    ranks = rec[:, :4] + popcount32(match & below_mask(pos)[:, None]).to(
        torch.int32)
    return ranks.t().contiguous()


def rank4_pair_plain(arrays: StreamArrays, lo: torch.Tensor,
                     hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of csrc/rank4_pair.cu: int32 [4, M] ranks of
    chars 1..4 at each lo and at each hi (from payloadR, where the kernel
    reads payloadT)."""
    return rank4_plain(arrays.payloadR, lo), rank4_plain(arrays.payloadR, hi)


def rank4_pair_stream(arrays: StreamArrays, lo: torch.Tensor,
                      hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ranks of all four characters at every lo and hi: (r4lo, r4hi),
    int32 [4, M] each (psi_tpu's [T, SLABS, 4, 8, 128] output is the same
    numbers, as `transpose(2,0,1,3,4).reshape(4, -1)` shows)."""
    dev = lo.device
    if dev.type == "cpu":
        return rank4_pair_plain(arrays, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"rank4_pair_stream: unsupported device {dev}")
    _build.check_int32("rank4_pair_stream", dev, payloadT=arrays.payloadT,
                       lo=lo, hi=hi)
    if lo.shape != hi.shape or lo.dim() != 1:
        raise ValueError("rank4_pair_stream: lo and hi must be [M]")
    m = lo.shape[0]
    r4lo = torch.empty((4, m), dtype=torch.int32, device=dev)
    r4hi = torch.empty((4, m), dtype=torch.int32, device=dev)
    _build.launch(
        "psi_rank4_pair", _RANK4_ARGTYPES, dev,
        arrays.payloadT.data_ptr(), arrays.payloadT.shape[1],
        lo.data_ptr(), hi.data_ptr(), r4lo.data_ptr(), r4hi.data_ptr(), m,
        _build.stream_ptr(dev),
    )
    rank4_pair_stream.launches += 1
    return r4lo, r4hi


rank4_pair_stream.launches = 0


# --- compact: child ranges from the parents' rank tables ----------------

_COMPACT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p]


def compact_plain(r4lo: torch.Tensor, r4hi: torch.Tensor,
                  parent: torch.Tensor, char: torch.Tensor,
                  C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of csrc/compact.cu."""
    c = char.long()
    idx = (c - 1, parent.long())
    base = C[c]
    return base + r4lo[idx], base + r4hi[idx]


def compact_children(r4lo: torch.Tensor, r4hi: torch.Tensor,
                     parent: torch.Tensor, char: torch.Tensor,
                     C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Child ranges C[c_i] + r4[c_i - 1, parent_i] for lo and hi; parent
    and char are int32 [M] in child order, r4lo/r4hi [4, Mprev]."""
    dev = parent.device
    if dev.type == "cpu":
        return compact_plain(r4lo, r4hi, parent, char, C)
    if dev.type != "cuda":
        raise ValueError(f"compact_children: unsupported device {dev}")
    _build.check_int32("compact_children", dev, r4lo=r4lo, r4hi=r4hi,
                       parent=parent, char=char, C=C)
    if r4lo.shape != r4hi.shape or r4lo.dim() != 2 or r4lo.shape[0] != 4:
        raise ValueError("compact_children: r4lo/r4hi must be [4, Mprev]")
    if parent.shape != char.shape or parent.dim() != 1:
        raise ValueError("compact_children: parent and char must be [M]")
    m = parent.shape[0]
    lo = torch.empty(m, dtype=torch.int32, device=dev)
    hi = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return lo, hi
    _build.launch(
        "psi_compact", _COMPACT_ARGTYPES, dev,
        r4lo.data_ptr(), r4hi.data_ptr(), r4lo.shape[1],
        parent.data_ptr(), char.data_ptr(), C.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), m, _build.stream_ptr(dev),
    )
    compact_children.launches += 1
    return lo, hi


compact_children.launches = 0


# --- rank4: ranks of A/C/G/T at one position array ---------------------

_RANK4_ONE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]


def rank4_stream(arrays: StreamArrays, pos: torch.Tensor) -> torch.Tensor:
    """Ranks of all four characters at every position of int32 `pos`
    [M] in [0, n] (8-byte aligned on the card, as a fresh tensor is):
    int32 [4, M]. psi_tpu's rank4_stream returns the same
    numbers as [T, SLABS, 4, 8, 128] (`transpose(2,0,1,3,4).reshape(4,
    -1)`) from any of its four kernel variants."""
    dev = pos.device
    if dev.type == "cpu":
        return rank4_plain(arrays.payloadR, pos)
    if dev.type != "cuda":
        raise ValueError(f"rank4_stream: unsupported device {dev}")
    check_records("rank4_stream", arrays.payloadR, dev)
    check_vectors("rank4_stream", dev, pairs=("pos",), pos=pos)
    m = pos.shape[0]
    out = torch.empty((4, m), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    _build.launch(
        "psi_rank4", _RANK4_ONE_ARGTYPES, dev,
        arrays.payloadR.data_ptr(), pos.data_ptr(), out.data_ptr(), m,
        _build.stream_ptr(dev),
    )
    rank4_stream.launches += 1
    return out


rank4_stream.launches = 0


# --- rank: rank(c_i, pos_i) per query, and one LF step of lo and hi ------

_RANK_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_RANK_LF_PAIR_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _match_word(pw: list, c: torch.Tensor) -> torch.Tensor:
    """int64 match words of chars c: the AND over the three bit planes
    of the plane or its complement, chosen by the bits of c (a tensor of
    chars shaped like the planes)."""
    match = torch.full_like(pw[0], _U32)
    for p in range(3):
        bit = ((c >> p) & 1).bool()
        match &= torch.where(bit, pw[p], ~pw[p] & _U32)
    return match


def rank_plain(payloadT: torch.Tensor, chars: torch.Tensor,
               pos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of csrc/rank.cu's psi_rank: int32 [M] ranks
    of chars c_i at positions pos_i, from payloadT."""
    blk = (pos >> 5).long()
    c = chars.long()
    pw = [payloadT[6 + p, blk].long() & _U32 for p in range(3)]
    match = _match_word(pw, c)
    return payloadT[c, blk] + popcount32(match & below_mask(pos)).to(
        torch.int32)


def rank_stream(arrays: StreamArrays, chars: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Batched rank(c, i), the number of c in bwt[0:i], for int32 chars
    [M] in 1..4 and int32 pos [M] in [0, n], in any order: int32 [M].
    Neither range is checked on the device (psi_tpu's contract)."""
    dev = pos.device
    if dev.type == "cpu":
        return rank_plain(arrays.payloadT, chars, pos)
    if dev.type != "cuda":
        raise ValueError(f"rank_stream: unsupported device {dev}")
    check_records("rank_stream", arrays.payloadR, dev)
    check_vectors("rank_stream", dev, chars=chars, pos=pos)
    m = pos.shape[0]
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    _build.launch(
        "psi_rank", _RANK_ARGTYPES, dev,
        arrays.payloadR.data_ptr(), chars.data_ptr(), pos.data_ptr(),
        out.data_ptr(), m, _build.stream_ptr(dev),
    )
    rank_stream.launches += 1
    return out


rank_stream.launches = 0


def rank_lf_pair_plain(arrays: StreamArrays, chars: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of csrc/rank.cu's psi_rank_lf_pair."""
    base = arrays.C[chars.long()]
    return (base + rank_plain(arrays.payloadT, chars, lo),
            base + rank_plain(arrays.payloadT, chars, hi))


def rank_lf_pair(arrays: StreamArrays, chars: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LF step of every key's range: (C[c] + rank(c, lo), C[c] +
    rank(c, hi)) for int32 chars [M] in 1..4 and lo, hi [M] in [0, n],
    int32 [M] each, in one launch. Neither range is checked on the
    device."""
    dev = lo.device
    if dev.type == "cpu":
        return rank_lf_pair_plain(arrays, chars, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"rank_lf_pair: unsupported device {dev}")
    check_records("rank_lf_pair", arrays.payloadR, dev)
    check_vectors("rank_lf_pair", dev, chars=chars, lo=lo, hi=hi)
    _build.check_int32("rank_lf_pair", dev, C=arrays.C)
    m = lo.shape[0]
    lo_out = torch.empty(m, dtype=torch.int32, device=dev)
    hi_out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return lo_out, hi_out
    _build.launch(
        "psi_rank_lf_pair", _RANK_LF_PAIR_ARGTYPES, dev,
        arrays.payloadR.data_ptr(), arrays.C.data_ptr(), chars.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), lo_out.data_ptr(), hi_out.data_ptr(),
        m, _build.stream_ptr(dev),
    )
    rank_lf_pair.launches += 1
    return lo_out, hi_out


rank_lf_pair.launches = 0


def backward_search_sorted(
    arrays: StreamArrays,
    codes: torch.Tensor,
    lo0: torch.Tensor | None = None,
    hi0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SA ranges (lo, hi), int32 [N] each, of k-mers given as int32
    code rows [N, k] (ACGT codes 1..4), fed column 0 first as psi_tpu's
    backward_search_sorted feeds them; lo0/hi0 optionally seed the
    search (ftab ranges). Each column is one LF step, one rank_lf_pair
    launch: lo' = C[c] + rank(c, lo), and the same for hi. Empty ranges
    keep stepping, so lo == hi there at a route-specific value.

    psi_tpu wants the rows sorted and pads them to whole tiles; its
    kernel walks payload windows and ranks lo and hi in two passes. Here
    rows may come in any order and are not padded: after the first step
    the positions are scattered whatever the row order, and each key's
    step is its own gather of one rank record (two where lo and hi lie in
    different blocks)."""
    dev = codes.device
    n_rows = codes.shape[0]
    if lo0 is None:
        lo0 = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    if hi0 is None:
        hi0 = torch.full((n_rows,), arrays.n, dtype=torch.int32, device=dev)
    cols = codes.t().contiguous()                 # [k, N], one row a step
    lo, hi = lo0, hi0
    for j in range(cols.shape[0]):
        lo, hi = rank_lf_pair(arrays, cols[j], lo, hi)
    return lo, hi
