"""Seed record — the output unit of the engine.

Mirrors the semantics of the reference seed record (ref: include/psi/seed.hpp:31-47):
``Seed{node_id, node_offset, read_id, read_offset, match_len, gocc}`` where
``gocc`` is the genome occurrence count of the seed's k-mer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Seed(NamedTuple):
    node_id: int
    node_offset: int
    read_id: int
    read_offset: int
    match_len: int
    gocc: int


#: Structured dtype for dense seed-hit batches (device-friendly columnar form).
SEED_DTYPE = np.dtype(
    [
        ("node_id", np.int64),
        ("node_offset", np.int64),
        ("read_id", np.int64),
        ("read_offset", np.int64),
        ("match_len", np.int64),
        ("gocc", np.int64),
    ]
)


def seeds_to_array(seeds) -> np.ndarray:
    """Pack an iterable of Seed tuples into a structured array."""
    return np.array([tuple(s) for s in seeds], dtype=SEED_DTYPE)


def sort_key(arr: np.ndarray) -> np.ndarray:
    """Canonical ordering for multiset comparison of hit sets.

    The reference emits hits in traversal order; equality of hit *multisets*
    (sorted by (read_id, read_offset, node_id, node_offset)) is the parity
    criterion (ref: binary tuple stream, src/psikt.cpp:172-181).
    """
    return np.lexsort(
        (arr["gocc"], arr["match_len"], arr["node_offset"], arr["node_id"],
         arr["read_offset"], arr["read_id"])
    )
