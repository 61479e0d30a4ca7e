"""FM-index over a concatenated string set, built for batched device queries.

TPU-native redesign of the reference FM layer (ref: include/psi/fmindex.hpp
wrapping sdsl::csa_wt, value semantics per fmindex.hpp:79-212): instead of
a wavelet tree + sampled SA walked by scalar code, the index is dense HBM
arrays —

  C[σ+1]         cumulative symbol counts
  occ[nb+1, σ]   occ checkpoints every B positions of the BWT
  bwt[n]         BWT symbols (uint8 codes)
  sa[n]          full suffix array (dense; locate = one gather instead of a
                 divergent LF walk — HBM is cheap on TPU relative to latency)
  str_starts[m+1] concatenated-text start of each string (sentinel-separated)

Alphabet: $=0 < A=1 < C=2 < G=3 < T=4 < N=5 (sentinel convention mirrors
SEQUENCE_DEFAULT_SENTINEL_CHAR usage, ref: include/psi/sequence.hpp:35).

Counting/locating patterns that contain no sentinel is independent of the
tie-order among equal sentinels, so a single '$' code is used.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

SIGMA = 6
CODE = np.full(256, 5, dtype=np.uint8)  # unknown -> N
CODE[ord("$")] = 0
CODE[ord("A")] = 1
CODE[ord("C")] = 2
CODE[ord("G")] = 3
CODE[ord("T")] = 4
CODE[ord("N")] = 5
CODE[ord("a")] = 1
CODE[ord("c")] = 2
CODE[ord("g")] = 3
CODE[ord("t")] = 4
CODE[ord("n")] = 5

DECODE = np.frombuffer(b"$ACGTN", dtype=np.uint8)

BLOCK = 128  # occ checkpoint spacing


def encode(text: str | bytes) -> np.ndarray:
    if isinstance(text, str):
        text = text.encode("ascii")
    return CODE[np.frombuffer(text, dtype=np.uint8)]


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Suffix array: native linear-time SA-IS (csrc/host/psi_host.cpp) with a
    vectorized prefix-doubling fallback (O(n log^2 n))."""
    from psi_tpu_torch import native

    sa = native.sais(np.asarray(codes, dtype=np.uint8))
    if sa is not None:
        return sa
    return _suffix_array_doubling(codes)


def _suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    n = len(codes)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    tmp = np.empty(n, dtype=np.int64)
    k = 1
    while True:
        # sort by (rank[i], rank[i+k]) using lexsort
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        sa = order
        # re-rank
        prev = sa[:-1]
        curr = sa[1:]
        diff = (rank[curr] != rank[prev]) | (second[curr] != second[prev])
        tmp[sa[0]] = 0
        tmp[curr] = np.cumsum(diff)
        rank, tmp = tmp.copy(), rank
        if rank[sa[-1]] == n - 1:
            break
        k <<= 1
    return sa


class FMIndex:
    """Dense-array FM index over a sentinel-separated string set.

    Default alphabet is the DNA map ($ACGTN); texts with other symbols get
    a generic byte alphabet (codemap built from the observed symbols) —
    mirroring the reference's genericity over SeqAn text types while the
    device kernels stay specialised to DNA.
    """

    def __init__(self, codes, sa, bwt, C, occ, str_starts, lengths,
                 codemap=None, sigma=SIGMA):
        self.codes = codes            # concatenated text codes incl sentinels
        self.sa = sa                  # int64[n]
        self.bwt = bwt                # uint8[n]
        self.C = C                    # int64[sigma+1]
        self.occ = occ                # int64[nblocks+1, sigma]
        self.str_starts = str_starts  # int64[m+1]
        self.lengths = lengths        # int64[m] (string lengths, no sentinel)
        self.codemap = CODE if codemap is None else codemap  # byte -> code
        self.sigma = sigma

    # --- construction -------------------------------------------------------
    @staticmethod
    def build_from_strings(strings: List[str]) -> "FMIndex":
        raw = [s.encode("ascii") if isinstance(s, str) else bytes(s) for s in strings]
        observed = set(b"".join(raw))
        if observed <= set(b"ACGTNacgtn"):
            codemap, sigma = CODE, SIGMA
        else:
            # generic byte alphabet; code 0 reserved for the sentinel
            symbols = sorted(observed)
            codemap = np.zeros(256, dtype=np.uint8)
            for i, sym in enumerate(symbols, start=1):
                codemap[sym] = i
            sigma = len(symbols) + 1
        parts = []
        starts = [0]
        lengths = []
        for s in raw:
            c = codemap[np.frombuffer(s, dtype=np.uint8)]
            parts.append(c)
            parts.append(np.zeros(1, dtype=np.uint8))  # sentinel
            lengths.append(len(c))
            starts.append(starts[-1] + len(c) + 1)
        if parts:
            codes = np.concatenate(parts)
        else:
            codes = np.zeros(0, dtype=np.uint8)
        return FMIndex.build_from_codes(
            codes,
            np.asarray(starts, dtype=np.int64),
            np.asarray(lengths, dtype=np.int64),
            codemap=codemap,
            sigma=sigma,
        )

    #: texts above this size build their SA sharded at string
    #: boundaries (parallel per-shard SA-IS + sentinel-terminated k-way
    #: heap merge; csrc/host/psi_host.cpp psi_sais_sharded)
    SHARDED_SA_MIN = int(2 ** 26)
    #: texts above this size (or with PSI_SA_DISK=1) use the
    #: BOUNDED-RAM build: per-shard SAs spill to disk, the merge streams
    #: the final SA to a file consumed as a memmap, and the BWT is
    #: extracted during the merge — peak RSS is text + bwt + the
    #: in-flight shards' workspace, independent of total size (the
    #: reference's external-memory sdsl build,
    #: ref: include/psi/fmindex.hpp:214-228)
    SA_DISK_MIN = int(float(os.environ.get("PSI_SA_DISK_MIN", 6e8)))

    @staticmethod
    def _shard_cuts(str_starts, n, t):
        """~equal-size shard boundaries snapped to string starts."""
        targets = np.linspace(0, n, t + 1)[1:-1]
        cuts = np.unique(
            str_starts[np.searchsorted(str_starts, targets, side="left")]
        )
        off = np.concatenate(([0], cuts, [n])).astype(np.int64)
        return np.unique(off)

    @staticmethod
    def build_from_codes(codes, str_starts, lengths, codemap=None,
                         sigma=SIGMA) -> "FMIndex":
        n = len(codes)
        sa = None
        bwt = None
        disk = os.environ.get("PSI_SA_DISK")
        use_disk = (
            disk not in (None, "", "0")
            or (disk is None and n >= FMIndex.SA_DISK_MIN)
        )
        if use_disk and len(lengths) > 1:
            from psi_tpu_torch import native

            # small shards keep the per-shard SA-IS workspace (~13 B/
            # char) bounded; ~128 Mchar each
            t = max(2, -(-n // (1 << 27)))
            off = FMIndex._shard_cuts(str_starts, n, t)
            if len(off) > 2:
                res = native.sais_disk(codes, off)
                if res is not None:
                    sa, bwt = res
        if sa is None and n >= FMIndex.SHARDED_SA_MIN and len(lengths) > 1:
            from psi_tpu_torch import native

            import multiprocessing

            t = max(2, min(8, multiprocessing.cpu_count()))
            off = FMIndex._shard_cuts(str_starts, n, t)
            if len(off) > 2:
                sa = native.sais_sharded(codes, off)
        if sa is None:
            sa = suffix_array(codes)
        if bwt is None and n:
            from psi_tpu_torch import native

            bwt = native.bwt_from_sa(codes, sa)
            if bwt is None:
                bwt = codes[(sa - 1) % n]
        elif bwt is None:
            bwt = np.zeros(0, dtype=np.uint8)
        # occ checkpoints: native one-pass scan, else per-symbol cumsum
        nblocks = (n + BLOCK - 1) // BLOCK
        occ = None
        if n:
            from psi_tpu_torch import native

            occ = native.occ_checkpoints(bwt, BLOCK, sigma)
        if occ is None:
            occ = np.zeros((nblocks + 1, sigma), dtype=np.int64)
            if n:
                block_ends = np.minimum(
                    np.arange(1, nblocks + 1) * BLOCK, n
                ) - 1
                for c in range(sigma):
                    csum_c = np.cumsum(bwt == c)
                    occ[1:, c] = csum_c[block_ends]
        # symbol counts from the occ table's last row (the BWT is a
        # permutation of the text) — np.bincount on the uint8 codes
        # would cast them to int64 internally, an 8 B/char transient
        # that dominates peak RSS at genome scale
        counts = occ[-1].astype(np.int64)
        C = np.zeros(sigma + 1, dtype=np.int64)
        np.cumsum(counts, out=C[1:])
        return FMIndex(codes, sa, bwt, C, occ, str_starts, lengths,
                       codemap=codemap, sigma=sigma)

    @property
    def size(self) -> int:
        return len(self.codes)

    def num_strings(self) -> int:
        return len(self.lengths)

    # --- queries (host/NumPy reference; device kernels in ops/fm.py) --------
    def rank(self, c: int, i: int) -> int:
        """# of occurrences of symbol c in bwt[0:i]."""
        b = i // BLOCK
        base = self.occ[b, c]
        lo = b * BLOCK
        if i > lo:
            base += int(np.count_nonzero(self.bwt[lo:i] == c))
        return int(base)

    def lf_step(self, c: int, lo: int, hi: int) -> Tuple[int, int]:
        return (
            int(self.C[c]) + self.rank(c, lo),
            int(self.C[c]) + self.rank(c, hi),
        )

    def backward_search(self, pattern: str) -> Tuple[int, int]:
        """SA range of the pattern; processes right-to-left."""
        lo, hi = 0, self.size
        for ch in reversed(pattern):
            c = int(self.codemap[ord(ch)])
            lo, hi = self.lf_step(c, lo, hi)
            if lo >= hi:
                return lo, lo
        return lo, hi

    def count(self, pattern: str) -> int:
        lo, hi = self.backward_search(pattern)
        return hi - lo

    def locate(self, lo: int, hi: int) -> np.ndarray:
        """Text positions for an SA range (dense SA gather)."""
        return self.sa[lo:hi]

    def text_pos_to_string(self, pos) -> Tuple[np.ndarray, np.ndarray]:
        """Map concatenated-text positions to (string_id, offset)."""
        pos = np.asarray(pos, dtype=np.int64)
        sid = np.searchsorted(self.str_starts, pos, side="right") - 1
        return sid, pos - self.str_starts[sid]

    def all_kmers(self, k: int, alphabet: Tuple[int, ...] = (1, 2, 3, 4)):
        """Enumerate all distinct k-mers present in the indexed text with
        their counts (the batched equivalent of the reference's next_kmer
        DFS enumeration, ref: include/psi/index_iter.hpp:630-652).

        Pruned level extension: length-(j+1) ranges are one LF step from
        the non-empty length-j ranges, so work is proportional to the
        number of distinct prefixes actually present. Returns
        (keys uint64 [D] packed 2-bit for the default alphabet — or
        code-digit base-sigma otherwise — in lexicographic order,
        counts int64 [D], lo int64 [D] SA range starts).
        """
        pos = {c: np.flatnonzero(self.bwt == c) for c in alphabet}
        keys = np.zeros(0, dtype=np.uint64)
        lo = np.zeros(0, dtype=np.int64)
        hi = np.zeros(0, dtype=np.int64)
        for ci, c in enumerate(alphabet):  # depth-1 seeds, lexicographic
            if self.C[c + 1] > self.C[c]:
                # digit = enumeration index (base-|alphabet| like deeper
                # levels; c - alphabet[0] breaks non-contiguous alphabets)
                keys = np.append(keys, np.uint64(ci))
                lo = np.append(lo, self.C[c])
                hi = np.append(hi, self.C[c + 1])
        base = np.uint64(len(alphabet))
        for level in range(1, k):
            # LF extension PREPENDS the symbol (backward search), so the
            # new symbol is the most significant key digit
            shift = base ** np.uint64(level)
            nk, nl, nh = [], [], []
            for ci, c in enumerate(alphabet):
                pc = pos[c]
                el = self.C[c] + np.searchsorted(pc, lo)
                eh = self.C[c] + np.searchsorted(pc, hi)
                keep = eh > el
                nk.append(keys[keep] + np.uint64(ci) * shift)
                nl.append(el[keep])
                nh.append(eh[keep])
            keys = np.concatenate(nk)
            lo = np.concatenate(nl)
            hi = np.concatenate(nh)
            order = np.argsort(keys, kind="stable")
            keys, lo, hi = keys[order], lo[order], hi[order]
        return keys, (hi - lo).astype(np.int64), lo

    def occurrences(self, pattern: str) -> List[Tuple[int, int]]:
        lo, hi = self.backward_search(pattern)
        sid, off = self.text_pos_to_string(self.locate(lo, hi))
        return sorted(zip(sid.tolist(), off.tolist()))

    # --- serialization ------------------------------------------------------
    _FIELDS = ("codes", "sa", "bwt", "C", "occ", "str_starts", "lengths",
               "codemap")

    def save(self, prefix: str, compress: bool = True) -> None:
        """Persist; `compress=False` writes per-array .npy files under
        ``<prefix>.fm/`` that load memory-mapped — the disk-backed-index
        analogue of the reference's DiskBased strings / external FM
        construction (ref: sequence.hpp:149-291, fmindex.hpp:214-228)."""
        if compress:
            np.savez_compressed(
                prefix + ".fm.npz",
                sigma=np.int64(self.sigma),
                **{f: getattr(self, f) for f in self._FIELDS},
            )
            return
        import os

        d = prefix + ".fm"
        os.makedirs(d, exist_ok=True)
        for f in self._FIELDS:
            np.save(os.path.join(d, f + ".npy"), getattr(self, f))
        np.save(os.path.join(d, "sigma.npy"), np.int64(self.sigma))

    @staticmethod
    def load(prefix: str, mmap: bool = False) -> "FMIndex":
        import os

        d = prefix + ".fm"
        if os.path.isdir(d):
            mode = "r" if mmap else None
            arrs = {
                f: np.load(os.path.join(d, f + ".npy"), mmap_mode=mode)
                for f in FMIndex._FIELDS
            }
            sigma = int(np.load(os.path.join(d, "sigma.npy")))
            return FMIndex(
                arrs["codes"], arrs["sa"], arrs["bwt"], arrs["C"],
                arrs["occ"], arrs["str_starts"], arrs["lengths"],
                codemap=np.asarray(arrs["codemap"]), sigma=sigma,
            )
        path = prefix + ".fm.npz"
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        z = np.load(path)
        return FMIndex(
            z["codes"], z["sa"], z["bwt"], z["C"], z["occ"],
            z["str_starts"], z["lengths"],
            codemap=np.asarray(z["codemap"]), sigma=int(z["sigma"]),
        )


class TopDownIter:
    """Virtual prefix-trie iterator over an FMIndex — the reference's
    Iter<TopDown<>> surface (ref: include/psi/fmindex.hpp:543-917):
    go_down(c) is one backward-search step (pattern extends at the
    FRONT), go_up pops the explicit history stack (IterHistory,
    fmindex.hpp:543-681), go_right moves to the next sibling edge,
    representative() returns the current pattern; count()/occurrences()
    query the current SA range.
    """

    def __init__(self, fm: FMIndex):
        self.fm = fm
        self.lo = 0
        self.hi = fm.size
        # history: (lo, hi, edge_char) per descent
        self._hist: List[Tuple[int, int, int]] = []

    def is_root(self) -> bool:
        return not self._hist

    def count(self) -> int:
        return max(self.hi - self.lo, 0)

    def depth(self) -> int:
        return len(self._hist)

    def representative(self) -> str:
        codes = [c for (_, _, c) in reversed(self._hist)]
        return bytes(DECODE[codes]).decode("ascii") if codes else ""

    def occurrences(self) -> np.ndarray:
        return self.fm.locate(self.lo, self.hi)

    def _try(self, c: int) -> bool:
        nlo, nhi = self.fm.lf_step(c, self.lo, self.hi)
        if nlo < nhi:
            self._hist.append((self.lo, self.hi, c))
            self.lo, self.hi = nlo, nhi
            return True
        return False

    def go_down(self, c=None) -> bool:
        """Descend the edge labelled c, or the lexicographically
        smallest existing edge when c is None (sentinel edges are not
        descended, mirroring pattern-search usage)."""
        if self.hi <= self.lo:
            return False
        if c is not None:
            code = int(self.fm.codemap[ord(c)]) if isinstance(c, str) else int(c)
            return self._try(code)
        for code in range(1, self.fm.sigma):
            if self._try(code):
                return True
        return False

    def go_right(self) -> bool:
        """Move to the next sibling edge (next larger char with a
        non-empty range at the parent)."""
        if not self._hist:
            return False
        plo, phi, c = self._hist.pop()
        self.lo, self.hi = plo, phi
        for code in range(c + 1, self.fm.sigma):
            if self._try(code):
                return True
        # restore (stay on the old edge like SeqAn's failed goRight)
        self._hist.append((plo, phi, c))
        self.lo, self.hi = self.fm.lf_step(c, plo, phi)
        return False

    def go_up(self) -> bool:
        if not self._hist:
            return False
        self.lo, self.hi, _ = self._hist.pop()
        return True
