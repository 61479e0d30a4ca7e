"""The plain reference that decides `correct`: every seed hit of a chunk,
worked out again from the GFA and the reads.

A hit is (node, offset, read, read offset): the seed of length k at that
offset of the read spells, with at most `mismatches` substitutions, a
walk of k characters through the graph that starts at that offset of
that node. psi's path index and its off-path traversal from the
uncovered loci together report every such walk, each at least once (a
walk on both picked paths, or on a path and off it, is reported once
for each); so the distinct hits of a chunk are exactly this set, and the
comparison is of sets. Seeds are taken every k bases from a read's start
(psikt's non-overlapping seeds); a seed with a base other than A, C, G,
T has no hit.

Plain PyTorch on whichever device it is given, and NumPy; it imports
nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

import numpy as np
import torch

CODE = np.full(256, -1, dtype=np.int64)
CODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)


class GfaGraph:
    """A forward-only GFA 1 graph (S and L lines) as flat arrays: labels
    concatenated in segment-name order, each node's first character
    (`start`, indexed by segment name) and its out-edges."""

    def __init__(self, path: str):
        names, labels, src, dst = [], [], [], []
        with open(path) as fh:
            for line in fh:
                f = line.rstrip("\n").split("\t")
                if f[0] == "S":
                    names.append(int(f[1]))
                    labels.append(f[2])
                elif f[0] == "L":
                    if f[2] != "+" or f[4] != "+":
                        raise ValueError(
                            "reference: reverse edges unsupported")
                    src.append(int(f[1]))
                    dst.append(int(f[3]))
        order = np.argsort(names)
        ids = np.asarray(names, dtype=np.int64)[order]
        lens = np.array([len(labels[i]) for i in order], dtype=np.int64)
        self.ids = ids
        self.start = np.zeros(int(ids.max()) + 2, dtype=np.int64)
        self.length = np.zeros_like(self.start)
        off = np.concatenate([[0], np.cumsum(lens)])
        self.start[ids] = off[:-1]
        self.length[ids] = lens
        text = "".join(labels[i] for i in order).encode("ascii")
        self.codes = CODE[np.frombuffer(text, dtype=np.uint8)]
        # per character: its node's position in id order, and whether it
        # ends the node
        self.node_of = np.repeat(np.arange(len(ids)), lens)
        self.is_end = np.zeros(len(self.codes), dtype=bool)
        self.is_end[off[1:] - 1] = True
        rank = {int(v): r for r, v in enumerate(ids)}
        s = np.array([rank[v] for v in src], dtype=np.int64)
        d = np.array([self.start[v] for v in dst], dtype=np.int64)
        eo = np.argsort(s, kind="stable")
        self.out_ptr = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(np.bincount(s, minlength=len(ids)), out=self.out_ptr[1:])
        self.out_first = d[eo]          # first character of each target

    @property
    def chars(self) -> int:
        return len(self.codes)


class DeviceGraph:
    """A GfaGraph's arrays on a device, and one character's step along
    every walk."""

    def __init__(self, g: GfaGraph, device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.codes, self.is_end, self.node_of = (
            t(g.codes), t(g.is_end), t(g.node_of))
        self.out_ptr, self.out_first = t(g.out_ptr), t(g.out_first)
        self.device = device

    def advance(self, cur: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The characters that follow each of `cur` on some walk: (index
        into `cur` of each successor, the successor). A node's last
        character is followed by the first of each out-neighbour."""
        end = self.is_end[cur]
        node = self.node_of[cur]
        deg = torch.where(end, self.out_ptr[node + 1] - self.out_ptr[node],
                          torch.ones_like(cur))
        rep = torch.repeat_interleave(
            torch.arange(len(cur), device=self.device), deg)
        j = (torch.arange(len(rep), device=self.device)
             - (torch.cumsum(deg, 0) - deg)[rep])
        pe = end[rep]
        edge = torch.where(pe, self.out_ptr[node[rep]] + j,
                           torch.zeros_like(j))
        last = max(len(self.out_first) - 1, 0)
        first = (self.out_first[edge.clamp(max=last)] if len(self.out_first)
                 else torch.zeros_like(edge))
        return rep, torch.where(pe, first, cur[rep] + 1)


class WalkTable:
    """Every walk of k characters in the graph: its 2-bit key and the
    character it starts at, sorted by key."""

    def __init__(self, g: GfaGraph, k: int, device):
        dg = DeviceGraph(g, device)
        start = torch.arange(g.chars, device=device)
        cur, key = start.clone(), dg.codes.clone()
        for _ in range(k - 1):
            rep, cur = dg.advance(cur)
            key = key[rep] * 4 + dg.codes[cur]
            start = start[rep]
        self.keys, order = torch.sort(key)
        self.start = start[order]
        self.k = k
        self.chars = g.chars


def seed_keys(reads: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Non-overlapping seeds of every read: (keys int64, read index,
    read offset); seeds holding another base than A, C, G, T left out."""
    n, length = reads.shape
    offs = np.arange(0, length - k + 1, k)
    codes = CODE[reads]                                   # [n, L]
    win = codes[:, offs[:, None] + np.arange(k)]          # [n, S, k]
    ok = (win >= 0).all(axis=2)
    w = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    keys = (np.where(win >= 0, win, 0) * w).sum(axis=2)
    ridx = np.repeat(np.arange(n), len(offs)).reshape(n, len(offs))
    roff = np.broadcast_to(offs, (n, len(offs)))
    return keys[ok], ridx[ok], roff[ok]


def ball(keys: torch.Tensor, k: int, mismatches: int) -> tuple[torch.Tensor,
                                                                torch.Tensor]:
    """The keys within `mismatches` (0 or 1) substitutions of each key:
    (keys, index of the key each came from)."""
    idx = torch.arange(len(keys), device=keys.device)
    if mismatches == 0:
        return keys, idx
    if mismatches != 1:
        raise ValueError("reference: at most one mismatch")
    out, src = [keys], [idx]
    for i in range(k):
        shift = 2 * (k - 1 - i)
        c = (keys >> shift) & 3
        for d in (1, 2, 3):
            out.append(keys + ((((c + d) & 3) - c) << shift))
            src.append(idx)
    return torch.cat(out), torch.cat(src)


class HitCoder:
    """One int64 per hit: (start character, read index, read offset)."""

    def __init__(self, chars: int, n_reads: int, read_len: int):
        self.off_bits = max(int(read_len).bit_length(), 1)
        self.read_bits = max(int(n_reads).bit_length(), 1)
        if (int(chars).bit_length() + self.read_bits + self.off_bits) > 62:
            raise ValueError("reference: hits do not fit 62 bits")

    def encode(self, pos, ridx, roff):
        return (pos << (self.read_bits + self.off_bits)) | \
            (ridx << self.off_bits) | roff


def chunk_hits(table: WalkTable, reads: np.ndarray, mismatches: int,
               coder: HitCoder, prefix: int = 0) -> torch.Tensor:
    """The sorted distinct hit codes of the reads. `prefix` > 0 compares
    only the first k - prefix characters of each seed and walk: the
    control, which breaks exact matching."""
    k, dev = table.k, table.keys.device
    keys, ridx, roff = (torch.as_tensor(a, device=dev)
                        for a in seed_keys(reads, k))
    q, src = ball(keys >> (2 * prefix), k - prefix, mismatches)
    wk = table.keys >> (2 * prefix)
    lo = torch.searchsorted(wk, q)
    hi = torch.searchsorted(wk, q, right=True)
    cnt = hi - lo
    rep = torch.repeat_interleave(torch.arange(len(q), device=dev), cnt)
    j = torch.arange(len(rep), device=dev) - (torch.cumsum(cnt, 0) - cnt)[rep]
    pos = table.start[lo[rep] + j]
    s = src[rep]
    return torch.unique(coder.encode(pos, ridx[s], roff[s]))


def program_hits(g: GfaGraph, cols: np.ndarray, base_read: int,
                 n_reads: int, read_len: int, k: int,
                 coder: HitCoder, device) -> tuple[torch.Tensor, int]:
    """The program's hit columns (node id, node offset, read id, read
    offset) of one chunk whose first read has id base_read, as sorted
    distinct codes, and the number of rows that name no possible hit (a
    node or offset out of range, a read of another chunk, an offset that
    starts no seed)."""
    c = torch.as_tensor(np.ascontiguousarray(cols), device=device)
    node, noff, rid, roff = c[:, 0], c[:, 1], c[:, 2] - base_read, c[:, 3]
    start = torch.as_tensor(g.start, device=device)
    length = torch.as_tensor(g.length, device=device)
    node_ok = (node >= 0) & (node < len(start))
    nd = torch.where(node_ok, node, torch.zeros_like(node))
    ok = (node_ok & (length[nd] > 0) & (noff >= 0) & (noff < length[nd])
          & (rid >= 0) & (rid < n_reads) & (roff >= 0)
          & (roff + k <= read_len) & (roff % k == 0))
    bad = int((~ok).sum())
    codes = coder.encode(start[nd[ok]] + noff[ok], rid[ok], roff[ok])
    return torch.unique(codes), bad


def compare(want: torch.Tensor, got: torch.Tensor) -> tuple[int, int]:
    """(missing, spurious): hits of `want` absent from `got`, and hits of
    `got` absent from `want`; both sorted and distinct."""
    if len(got) == 0 or len(want) == 0:
        return len(want), len(got)
    i = torch.searchsorted(got, want).clamp(max=len(got) - 1)
    found = int((got[i] == want).sum())
    return len(want) - found, len(got) - found
