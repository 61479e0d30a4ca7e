"""Streaming FASTQ/FASTA reader feeding fixed-shape read batches.

Replaces the reference's kseq++ streaming frontend
(ref: include/psi/sequence.hpp:1608-1624, src/psikt.cpp:257-263):
reads are consumed in chunks with a running record offset so read ids are
global across chunks.
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Tuple


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def iter_fastx(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) records from FASTQ or FASTA."""
    with _open(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            header = fh.readline().strip()
            name = header.split()[0] if header else ""
            seq_parts: List[str] = []
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    yield name, "".join(seq_parts)
                    name = line[1:].split()[0]
                    seq_parts = []
                else:
                    seq_parts.append(line)
            yield name, "".join(seq_parts)
        elif first == "@":
            name = fh.readline().strip().split()[0]
            while True:
                seq = fh.readline().rstrip("\n")
                plus = fh.readline()
                qual = fh.readline()
                if not qual:
                    if seq:
                        yield name, seq
                    return
                yield name, seq
                header = fh.readline()
                if not header:
                    return
                name = header.strip().lstrip("@").split()[0]
        else:
            raise ValueError(f"unrecognized sequence file format: {path}")


class FastxStream:
    """Chunked reader with a global record counter
    (counts() mirrors kseq++ SeqStreamIn usage for rec_offset).

    FASTQ files use the native single-pass scanner (csrc/host/psi_host.cpp)
    over the in-memory buffer when available; FASTA and exotic layouts
    fall back to the Python generator.
    """

    def __init__(self, path: str):
        self._count = 0
        self._buf = None
        self._pos = 0
        self._iter = None
        from psi_tpu_torch import native

        if native.available():
            with _open_binary(path) as fh:
                head = fh.read(1)
                if head == b"@":
                    self._buf = head + fh.read()
        if self._buf is None:
            self._iter = iter_fastx(path)
        self._path = path

    def counts(self) -> int:
        return self._count

    def read_chunk(self, n: int = 0) -> Tuple[List[str], List[str]]:
        """Read up to n records (all if n == 0). Returns (names, seqs)."""
        if self._buf is not None:
            from psi_tpu_torch import native

            max_records = n if n else 1 << 62
            remaining = memoryview(self._buf)[self._pos:]
            if not len(remaining):
                return [], []
            cap = min(max_records, max(1, len(remaining) // 4))
            out = native.fastq_scan(bytes(remaining), cap)
            names, seqs, consumed = out
            self._pos += consumed
            self._count += len(names)
            return names, seqs
        names: List[str] = []
        seqs: List[str] = []
        for name, seq in self._iter:
            names.append(name)
            seqs.append(seq)
            self._count += 1
            if n and len(names) == n:
                break
        return names, seqs

    def read_chunk_packed(self, n: int = 0):
        """Read up to n records as (names, (data uint8, offsets int64))
        — the packed Records form, with the sequence bytes gathered
        natively (no per-read Python strings). Falls back to
        read_chunk-derived packing when the native scanner or gather is
        unavailable."""
        import numpy as np

        if self._buf is not None:
            from psi_tpu_torch import native

            max_records = n if n else 1 << 62
            buf_np = np.frombuffer(self._buf, dtype=np.uint8)[self._pos:]
            if not len(buf_np):
                return [], None
            cap = min(max_records, max(1, len(buf_np) // 4))
            out = native.fastq_scan_packed(buf_np, cap)
            if out is not None:
                names, data, offsets, consumed = out
                self._pos += consumed
                self._count += len(names)
                return names, (data, offsets)
        names, seqs = self.read_chunk(n)
        if not names:
            return [], None
        text = "".join(seqs).encode("ascii")
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter((len(s) for s in seqs), dtype=np.int64,
                        count=len(seqs)),
            out=offsets[1:],
        )
        return names, (np.frombuffer(text, dtype=np.uint8), offsets)


def _open_binary(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastq(path: str, n: int = 0) -> Tuple[List[str], List[str]]:
    """Read up to n records from a FASTQ/FASTA file (all if n == 0)."""
    return FastxStream(path).read_chunk(n)
