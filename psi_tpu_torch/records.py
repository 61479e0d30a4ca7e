"""Read/seed record sets and the reads-side k-mer index.

Replaces the reference's Records/StringSet/SeedMap stack
(ref: include/psi/sequence.hpp:1131-1332) with columnar arrays, and the
reads-side WOTD/ESA suffix trie (ref: include/psi/index.hpp:33-77) with a
*sorted packed k-mer array* + per-depth rank structure: descending the
virtual trie one character at a time is a rank-refined range narrowing on
the sorted keys — the same data-parallel shape as FM backward search.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from psi_tpu_torch.ops.kmers import extract_kmers, pack_kmers, seq_to_codes

BLOCK = 32  # rank checkpoint spacing: one 32-bit plane word per block


class Records:
    """A chunk of named sequences with a global record offset
    (ref: sequence.hpp:1131-1294; rec_offset semantics :1277-1289).

    Sequences live either as a list of Python strings (`seqs`) or in
    PACKED form — one contiguous uint8 byte array + int64 [R+1]
    offsets — which the native chunk path consumes without any
    per-read string round trips. `seqs` materializes lazily from the
    packed form for the string consumers (host mirrors, MEM path)."""

    def __init__(self, names: Sequence[str] = (), seqs: Sequence[str] = (),
                 rec_offset: int = 0, packed=None):
        self.names: List[str] = list(names)
        if packed is not None:
            data, offsets = packed
            self._packed = (
                np.ascontiguousarray(data, dtype=np.uint8),
                np.ascontiguousarray(offsets, dtype=np.int64),
            )
            self._seqs: List[str] | None = None
        else:
            self._seqs = list(seqs)
            self._packed = None
        self.rec_offset = rec_offset

    @property
    def seqs(self) -> List[str]:
        if self._seqs is None:
            data, off = self._packed
            b = data.tobytes()
            self._seqs = [
                b[off[i]: off[i + 1]].decode("ascii")
                for i in range(len(off) - 1)
            ]
        return self._seqs

    @seqs.setter
    def seqs(self, value):
        self._seqs = list(value)
        self._packed = None

    def packed_view(self):
        """(data uint8[T], offsets int64[R+1]) or None when the chunk
        holds strings only."""
        return self._packed

    def __len__(self) -> int:
        if self._seqs is None:
            return len(self._packed[1]) - 1
        return len(self._seqs)

    def clear(self):
        self.names = []
        self._seqs = []
        self._packed = None
        self.rec_offset = 0

    def length_sum(self) -> int:
        if self._seqs is None:
            return int(self._packed[1][-1])
        return sum(len(s) for s in self._seqs)

    def position_to_id(self, rec_id: int) -> int:
        return self.rec_offset + rec_id


class SeedSet:
    """Seeds extracted from a read chunk: packed keys + seed->read map
    (SeedMap equivalent, ref: sequence.hpp:1148-1220)."""

    def __init__(self, keys, valid, seedmap, k: int, rec_offset: int = 0):
        self.keys = keys          # uint64 [S]
        self.valid = valid        # bool [S] (False: contains N)
        self.seedmap = seedmap    # int64 [S, 2] (read_index, read_offset)
        self.k = k
        self.rec_offset = rec_offset

    def __len__(self) -> int:
        return len(self.keys)

    def read_id(self, seed_id: int) -> int:
        return self.rec_offset + int(self.seedmap[seed_id, 0])

    def read_offset(self, seed_id: int) -> int:
        return int(self.seedmap[seed_id, 1])


def seeding(reads: Records, k: int, step: int, greedy: bool = False) -> SeedSet:
    """Extract k-mers with `step` spacing from each read
    (ref: seeding() overloads, sequence.hpp:1688-1781; step==k gives the
    non-overlapping strategy, step==1 greedy-overlapping; greedy=True
    adds an end-anchored final window when the tail does not fit —
    GreedyNonOverlapping, ref: sequence.hpp:1796-1816)."""
    from psi_tpu_torch import native

    out = None
    pk = reads.packed_view() if hasattr(reads, "packed_view") else None
    if pk is not None:
        out = native.extract_kmers_packed(
            pk[0], pk[1], k, step, greedy_tail=greedy
        )
    if out is None:
        out = native.extract_kmers(reads.seqs, k, step, greedy_tail=greedy)
    if out is None:
        out = extract_kmers(reads.seqs, k, step, greedy_tail=greedy)
    keys, valid, seedmap = out
    return SeedSet(keys, valid, seedmap, k, reads.rec_offset)


class SeedsIndex:
    """Reads-side index: sorted packed k-mers + per-depth rank structure.

    Functional stand-in for the WOTD/ESA trie over seeds: a state (lo, hi)
    over the sorted key array is a trie node for the common prefix of
    depth d; `go_down` narrows by one character via per-depth rank.
    Within an equal-prefix range the depth-d characters are sorted, so

        new_lo = lo + #(chars_d[lo:hi) < c)
        new_hi = new_lo + #(chars_d[lo:hi) == c)

    computed from checkpointed per-depth symbol counts (int32 only — no
    64-bit emulation on device, any k <= 32).
    """

    def __init__(self, seeds: SeedSet):
        from psi_tpu_torch import native

        self.seeds = seeds
        self.k = seeds.k
        self.rec_offset = seeds.rec_offset
        keys = seeds.keys[seeds.valid]
        ids = np.nonzero(seeds.valid)[0].astype(np.int64)
        # stable sort by key carrying ids: native LSD radix when
        # available (one fused pass set), else argsort + two gathers
        if len(keys) and native.radix_sort_kv(
            keys, ids, 2 * seeds.k
        ) is not None:
            self.sorted_keys = keys
            self.seed_ids = ids
        else:
            order = np.argsort(keys, kind="stable")
            self.sorted_keys = keys[order]      # uint64 [V]
            self.seed_ids = ids[order]          # int64 [V] original index
        V = len(self.sorted_keys)
        self.size = V
        k = self.k
        nb = (V + BLOCK - 1) // BLOCK
        if V:
            filled = native.seed_index_fill(self.sorted_keys, k, BLOCK)
            if filled is not None:
                self.chars, self.occ, self.planes = filled
                return
        # NumPy fallback: per-depth char codes of the sorted keys
        # (row-by-row: avoids a broadcast (k, V) uint64 intermediate,
        # which is slow on this host)
        self.chars = np.zeros((k, V), dtype=np.uint8)
        three = np.uint64(3)
        for d in range(k):
            shift = np.uint64(2 * (k - 1 - d))
            self.chars[d] = ((self.sorted_keys >> shift) & three).astype(
                np.uint8
            )
        # rank checkpoints per depth: occ[d, b, c] = # of char c in chars[d, :b*BLOCK]
        self.occ = np.zeros((k, nb + 1, 4), dtype=np.int32)
        # per-depth 2-bit planes, one 32-bit word per block: device rank
        # = occ checkpoint + masked popcount (no [N, BLOCK] one-hot).
        # Padding beyond V never affects ranks (positions are <= V, the
        # prefix mask excludes pad bits); occ checkpoints stop at V.
        self.planes = np.zeros((k, nb + 1, 2), dtype=np.int32)
        if V:
            weights = np.uint32(1) << np.arange(BLOCK, dtype=np.uint32)
            padded = np.zeros(((nb + 1) * BLOCK,), dtype=np.uint32)
            for d in range(k):
                occ_d = native.occ_checkpoints(self.chars[d], BLOCK, 4)
                if occ_d is not None:
                    self.occ[d, : nb + 1] = occ_d[: nb + 1]
                else:
                    block_ends = np.minimum(
                        np.arange(1, nb + 1) * BLOCK, V
                    ) - 1
                    for c in range(4):
                        self.occ[d, 1:, c] = np.cumsum(
                            self.chars[d] == c
                        )[block_ends]
                padded[:V] = self.chars[d]
                sym = padded.reshape(-1, BLOCK)
                for p in range(2):
                    self.planes[d, :, p] = (
                        ((sym >> p) & 1) * weights[None, :]
                    ).sum(axis=1, dtype=np.uint32).view(np.int32)

    # --- host-side trie descent --------------------------------------------
    def root(self) -> Tuple[int, int]:
        return 0, self.size

    def go_down(self, lo: int, hi: int, depth: int, c: int) -> Tuple[int, int]:
        """Narrow range by char code c (0..3) at `depth`. Empty => (x, x)."""
        if lo >= hi:
            return lo, lo
        ch = self.chars[depth]
        new_lo = lo + int(np.searchsorted(ch[lo:hi], c, side="left"))
        new_hi = lo + int(np.searchsorted(ch[lo:hi], c, side="right"))
        return new_lo, new_hi

    def descend(self, codes: Sequence[int]) -> Tuple[int, int]:
        lo, hi = self.root()
        for d, c in enumerate(codes):
            lo, hi = self.go_down(lo, hi, d, int(c))
            if lo >= hi:
                break
        return lo, hi

    def occurrences(self, lo: int, hi: int) -> np.ndarray:
        """Original seed indices for a full-depth range."""
        return self.seed_ids[lo:hi]
