"""Packed k-mer utilities.

The reads side of both matching engines is a dense array of 2-bit-packed
k-mers instead of the reference's WOTD/ESA trie (design delta per
SURVEY.md §7.1.2): a sorted packed array *is* the trie — prefix descent is
binary search on prefix ranges.

Codes here are 0..3 for A,C,G,T; k-mers containing N (or any non-ACGT
symbol) are flagged invalid — they can never match (graph 'N' kills
traverser states, ref: traverser_bfs.hpp:124; and the k-mer enumeration in
the reference iterates DnaString seeds only, ref: index_iter.hpp:831-851).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from psi_tpu_torch import stats

ACGT_CODE = np.full(256, -1, dtype=np.int8)
for i, ch in enumerate("ACGT"):
    ACGT_CODE[ord(ch)] = i
    ACGT_CODE[ord(ch.lower())] = i

MAX_PACK_K = 32


def increment_kmer(codes: np.ndarray, pos: int = None) -> int:
    """Lexicographic k-mer successor with carry, in place over a 0..3
    code array (ref: increment_kmer, include/psi/sequence.hpp:1639-1674).

    Increments the character at `pos` (default: last), resetting higher
    positions; returns the smallest modified position, or -1 when the
    k-mer space is exhausted.
    """
    k = len(codes)
    if pos is None:
        pos = k - 1
    codes[pos + 1:] = 0
    while pos >= 0 and codes[pos] == 3:
        codes[pos] = 0
        pos -= 1
    if pos >= 0:
        codes[pos] += 1
    return pos


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII -> 0..3 codes, -1 for N/unknown."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return ACGT_CODE[np.frombuffer(seq, dtype=np.uint8)]


def pack_kmers(codes_matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pack rows of a (N, k) code matrix into uint64 keys.

    Returns (keys, valid): invalid rows (containing a negative code) get
    key 0 and valid=False. Requires k <= 32.
    """
    n, k = codes_matrix.shape
    if k > MAX_PACK_K:
        raise ValueError(f"k={k} > {MAX_PACK_K} unsupported by 2-bit packing")
    valid = (codes_matrix >= 0).all(axis=1)
    cm = np.where(codes_matrix < 0, 0, codes_matrix).astype(np.uint64)
    shifts = (2 * (k - 1 - np.arange(k, dtype=np.uint64))).astype(np.uint64)
    keys = (cm << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    return keys, valid


def unpack_kmer(key: int, k: int) -> str:
    chars = []
    for i in range(k):
        chars.append("ACGT"[(int(key) >> (2 * (k - 1 - i))) & 3])
    return "".join(chars)


def kmer_char(keys: np.ndarray, pos: int, k: int) -> np.ndarray:
    """Extract the 0..3 code of character `pos` (0-based from the left)."""
    shift = np.uint64(2 * (k - 1 - pos))
    return ((keys >> shift) & np.uint64(3)).astype(np.int32)


def expand_hamming(keys: np.ndarray, k: int, m: int):
    """All packed k-mers within Hamming distance <= m of each input key.

    Returns (variant_keys uint64[V], origin_idx int64[V]) deduplicated
    per origin, each pair where it first appears. Used by the
    mismatch-tolerant on-path route: searching every variant exactly
    equals allowing <= m substitutions.

    At m <= 1 no pair repeats: an origin's one-substitution keys differ
    from each other in the position or the character and from the key,
    so the levels come back as they are. From m = 2 keys come back (a
    second substitution at the same position), so the (origin, key) rows
    are sorted, and counted as ball-dedup-rows.
    """
    cur_keys = keys.astype(np.uint64)
    cur_origin = np.arange(len(keys), dtype=np.int64)
    all_keys = [cur_keys]
    all_origin = [cur_origin]
    for _ in range(m):
        parts_k = []
        parts_o = []
        for pos in range(k):
            shift = np.uint64(2 * (k - 1 - pos))
            mask = np.uint64(3) << shift
            base = cur_keys & ~mask
            old = (cur_keys >> shift) & np.uint64(3)
            for delta in (1, 2, 3):
                newc = (old + np.uint64(delta)) & np.uint64(3)
                parts_k.append(base | (newc << shift))
                parts_o.append(cur_origin)
        cur_keys = np.concatenate(parts_k)
        cur_origin = np.concatenate(parts_o)
        all_keys.append(cur_keys)
        all_origin.append(cur_origin)
    vk = np.concatenate(all_keys)
    vo = np.concatenate(all_origin)
    if m <= 1:
        return vk, vo
    stats.count("ball-dedup-rows", len(vk))
    # dedup (origin, key) pairs
    combo = np.stack([vo.astype(np.uint64), vk], axis=1)
    _, idx = np.unique(combo, axis=0, return_index=True)
    idx = np.sort(idx)
    return vk[idx], vo[idx]


def extract_kmers(
    seqs, k: int, step: int, greedy_tail: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seeding: all k-mers with `step` spacing from each sequence
    (ref seeding() semantics: include/psi/sequence.hpp:1688-1718 — windows
    start at 0,step,... while start + k <= len). With `greedy_tail` a
    final window at len-k is added when the length is not divisible
    (GreedyNonOverlapping, ref: sequence.hpp:1796-1816).

    Returns (keys uint64[S], valid bool[S], seedmap int64[S, 2]) where
    seedmap rows are (read_index, read_offset) — the SeedMap equivalent
    (ref: sequence.hpp:1148-1220).
    """
    # fast path: equal-length reads pack column-wise over strided views
    # (no (N, k) window intermediate — k passes over small columns)
    if seqs and not greedy_tail:
        L = len(seqs[0])
        if L >= k and all(len(s) == L for s in seqs):
            R = len(seqs)
            codes = ACGT_CODE[
                np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
            ].reshape(R, L)
            starts = np.arange(0, L - k + 1, step, dtype=np.int64)
            S = len(starts)
            keys = np.zeros(R * S, dtype=np.uint64)
            valid = np.ones(R * S, dtype=bool)
            for j in range(k):
                col = codes[:, starts + j].reshape(-1)
                valid &= col >= 0
                keys = (keys << np.uint64(2)) | np.where(
                    col < 0, 0, col
                ).astype(np.uint64)
            m = np.empty((R * S, 2), dtype=np.int64)
            m[:, 0] = np.repeat(np.arange(R), S)
            m[:, 1] = np.tile(starts, R)
            return keys, valid, m

    keys_parts = []
    valid_parts = []
    map_parts = []
    for ridx, seq in enumerate(seqs):
        codes = seq_to_codes(seq)
        L = len(codes)
        if L < k:
            continue
        starts = np.arange(0, L - k + 1, step, dtype=np.int64)
        if greedy_tail and len(starts) and starts[-1] != L - k:
            starts = np.append(starts, L - k)
        win = codes[starts[:, None] + np.arange(k)[None, :]]
        kk, vv = pack_kmers(win)
        keys_parts.append(kk)
        valid_parts.append(vv)
        m = np.empty((len(starts), 2), dtype=np.int64)
        m[:, 0] = ridx
        m[:, 1] = starts
        map_parts.append(m)
    if not keys_parts:
        return (
            np.zeros(0, dtype=np.uint64),
            np.zeros(0, dtype=bool),
            np.zeros((0, 2), dtype=np.int64),
        )
    return (
        np.concatenate(keys_parts),
        np.concatenate(valid_parts),
        np.concatenate(map_parts),
    )
