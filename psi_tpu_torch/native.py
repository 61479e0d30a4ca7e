"""ctypes bindings for the native host library (csrc/host/*.cpp).

`_build.build_host` compiles the library at first use into
build/psi_tpu_torch/libpsi_host.so. This binds only what this package
calls: SA construction and the BWT/occ fill (fmindex), path picking and
uncovered loci (seed_finder), the trie schedule (ops/fm_trie), FASTQ
scanning (io/fastq), k-mer extraction, radix sort and the seed-index
fill (records), the fused emission join (seed_finder), the distance-index
DPs (dindex), the GAF column scan (tools/alice) and the single-core
backward search that is the speed baseline (csrc/host/psi_fm.cpp). Every
entry point returns None when the library could not be built, and its
caller then takes its NumPy path; `load_error` says why.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from psi_tpu_torch import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: why the library is unavailable (None while it loads or is untried)
load_error: Optional[str] = None
#: the compiler command line the loaded library was built with
built_with: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, load_error, built_with
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path, built_with = _build.build_host()
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as exc:
            load_error = str(exc)
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.psi_sais.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.psi_sais.restype = None
        lib.psi_sais_sharded.argtypes = [
            u8p, ctypes.c_int64, i64p, ctypes.c_int64, i64p
        ]
        lib.psi_sais_sharded.restype = None
        lib.psi_sais_merge_disk.argtypes = [
            u8p, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_char_p, u8p, ctypes.c_int64,
        ]
        lib.psi_sais_merge_disk.restype = ctypes.c_int64
        lib.psi_bwt_from_sa.argtypes = [u8p, i64p, ctypes.c_int64, u8p]
        lib.psi_bwt_from_sa.restype = None
        lib.psi_occ_checkpoints.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p
        ]
        lib.psi_occ_checkpoints.restype = None
        lib.psi_fastq_scan.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p, i64p,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.psi_fastq_scan.restype = ctypes.c_int64
        lib.psi_gather_spans.argtypes = [u8p, i64p, i64p, ctypes.c_int64, u8p]
        lib.psi_gather_spans.restype = None
        lib.psi_uncovered_build.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p,
            ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.psi_uncovered_build.restype = ctypes.c_void_p
        lib.psi_uncovered_count.argtypes = [ctypes.c_void_p]
        lib.psi_uncovered_count.restype = ctypes.c_int64
        lib.psi_uncovered_export.argtypes = [ctypes.c_void_p, i64p, i64p]
        lib.psi_uncovered_export.restype = None
        lib.psi_uncovered_free.argtypes = [ctypes.c_void_p]
        lib.psi_uncovered_free.restype = None
        lib.psi_trie_schedule.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64
        ]
        lib.psi_trie_schedule.restype = ctypes.c_void_p
        lib.psi_trie_sizes.argtypes = [ctypes.c_void_p, i64p]
        lib.psi_trie_sizes.restype = None
        lib.psi_trie_level.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, i32p, i32p
        ]
        lib.psi_trie_level.restype = None
        lib.psi_trie_leaf_perm.argtypes = [ctypes.c_void_p, i32p]
        lib.psi_trie_leaf_perm.restype = None
        lib.psi_trie_frontier.argtypes = [ctypes.c_void_p, i64p]
        lib.psi_trie_frontier.restype = ctypes.c_int64
        lib.psi_trie_free.argtypes = [ctypes.c_void_p]
        lib.psi_trie_free.restype = None
        RAND_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int64)
        lib._RAND_FN = RAND_FN
        lib.psi_pick_paths.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p,
            ctypes.c_int64, i64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            RAND_FN,
        ]
        lib.psi_pick_paths.restype = ctypes.c_void_p
        lib.psi_pick_paths_count.argtypes = [ctypes.c_void_p]
        lib.psi_pick_paths_count.restype = ctypes.c_int64
        lib.psi_pick_paths_nodes_total.argtypes = [ctypes.c_void_p]
        lib.psi_pick_paths_nodes_total.restype = ctypes.c_int64
        lib.psi_pick_paths_export.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p
        ]
        lib.psi_pick_paths_export.restype = None
        lib.psi_pick_paths_free.argtypes = [ctypes.c_void_p]
        lib.psi_pick_paths_free.restype = None
        lib.psi_extract_kmers.argtypes = [
            u8p, i64p, i64p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u64p, u8p, i64p,
        ]
        lib.psi_extract_kmers.restype = None
        lib.psi_seed_index_fill.argtypes = [
            u64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, u8p, i32p, i32p,
        ]
        lib.psi_seed_index_fill.restype = None
        lib.psi_radix_sort_kv.argtypes = [
            u64p, i64p, ctypes.c_int64, ctypes.c_int32, u64p, i64p,
        ]
        lib.psi_radix_sort_kv.restype = None
        lib.psi_emit_join.argtypes = [
            i64p, i64p, ctypes.c_int64, i64p, i64p, i64p, i64p,
            i64p, i64p, i64p, ctypes.c_int64, i64p, i64p, i64p,
            i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p,
        ]
        lib.psi_emit_join.restype = None
        lib.psi_dindex_build.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p,
            ctypes.c_int64, i64p, i64p, ctypes.c_int64,
        ]
        lib.psi_dindex_build.restype = ctypes.c_void_p
        lib.psi_dindex_nnz.argtypes = [ctypes.c_void_p]
        lib.psi_dindex_nnz.restype = ctypes.c_int64
        lib.psi_dindex_export.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p
        ]
        lib.psi_dindex_export.restype = None
        lib.psi_dindex_free.argtypes = [ctypes.c_void_p]
        lib.psi_dindex_free.restype = None
        lib.psi_dindex_super.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p, ctypes.c_int64
        ]
        lib.psi_dindex_super.restype = ctypes.c_void_p
        lib.psi_gaf_scan.argtypes = [u8p, ctypes.c_int64]
        lib.psi_gaf_scan.restype = ctypes.c_void_p
        lib.psi_gaf_nrec.argtypes = [ctypes.c_void_p]
        lib.psi_gaf_nrec.restype = ctypes.c_int64
        lib.psi_gaf_ngroups.argtypes = [ctypes.c_void_p]
        lib.psi_gaf_ngroups.restype = ctypes.c_int64
        lib.psi_gaf_npathnodes.argtypes = [ctypes.c_void_p]
        lib.psi_gaf_npathnodes.restype = ctypes.c_int64
        lib.psi_gaf_export.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p, i64p, i64p
        ]
        lib.psi_gaf_export.restype = None
        lib.psi_gaf_free.argtypes = [ctypes.c_void_p]
        lib.psi_gaf_free.restype = None
        if hasattr(lib, "psi_fm_backward_batch"):
            lib.psi_fm_backward_batch.argtypes = [
                i32p, ctypes.c_int64, i32p, ctypes.c_int64,
                i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p,
            ]
            lib.psi_fm_backward_batch.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def sais(text_codes: np.ndarray) -> Optional[np.ndarray]:
    """Native SA-IS; returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text_codes, dtype=np.uint8)
    n = len(text)
    sa = np.empty(n, dtype=np.int64)
    lib.psi_sais(text, n, sa)
    return sa


def sais_sharded(
    text_codes: np.ndarray, shard_off: np.ndarray
) -> Optional[np.ndarray]:
    """Parallel sharded SA (shards must end at a sentinel); None when
    the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text_codes, dtype=np.uint8)
    shard_off = np.ascontiguousarray(shard_off, dtype=np.int64)
    n = len(text)
    sa = np.empty(n, dtype=np.int64)
    lib.psi_sais_sharded(text, n, shard_off, len(shard_off) - 1, sa)
    return sa


def sais_disk(
    text_codes: np.ndarray,
    shard_off: np.ndarray,
    tmpdir: Optional[str] = None,
    workers: int = 0,
    bufelems: int = 1 << 20,
):
    """Bounded-RAM sharded SA build: per-shard SA-IS spilled to a
    shards file, then a k-way heap merge streaming the merged SA to
    disk with the BWT filled on the fly. Peak RSS = text + bwt + the
    in-flight shards' SA-IS workspace, independent of total text size.

    Returns (sa_memmap, bwt) or None without the library. The on-disk
    SA file is unlinked after mapping (lives until the memmap closes).
    """
    import tempfile

    lib = _load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text_codes, dtype=np.uint8)
    shard_off = np.ascontiguousarray(shard_off, dtype=np.int64)
    n = len(text)
    nshards = len(shard_off) - 1
    if workers <= 0:
        env_w = os.environ.get("PSI_SA_WORKERS")
        workers = (
            int(env_w) if env_w
            else min(2, max(os.cpu_count() or 1, 1))
        )
    tmpdir = tmpdir or os.environ.get("PSI_SA_TMP") or tempfile.gettempdir()
    shards_path = os.path.join(tmpdir, f"psi_sa_shards_{os.getpid()}.bin")
    out_path = os.path.join(tmpdir, f"psi_sa_merged_{os.getpid()}.bin")
    fd = os.open(shards_path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o600)
    try:
        def build_one(s):
            a, b = int(shard_off[s]), int(shard_off[s + 1])
            buf = np.empty(b - a, dtype=np.int64)
            lib.psi_sais(text[a:b], b - a, buf)
            buf += a
            view = memoryview(buf).cast("B")
            off_b = a * 8
            while len(view):
                w = os.pwrite(fd, view, off_b)
                view = view[w:]
                off_b += w

        if workers > 1 and nshards > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(build_one, range(nshards)))
        else:
            for s in range(nshards):
                build_one(s)
        os.fsync(fd)
    finally:
        os.close(fd)
    try:
        bwt = np.empty(n, dtype=np.uint8)
        rc = lib.psi_sais_merge_disk(
            text, n, shard_off, nshards,
            shards_path.encode(), out_path.encode(), bwt, bufelems,
        )
        if rc != 0:
            return None
    finally:
        os.unlink(shards_path)
    sa = np.memmap(out_path, dtype=np.int64, mode="r", shape=(n,))
    os.unlink(out_path)  # the mapping keeps the inode alive
    return sa, bwt


def bwt_from_sa(text_codes: np.ndarray, sa: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    text = np.ascontiguousarray(text_codes, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    bwt = np.empty(len(text), dtype=np.uint8)
    lib.psi_bwt_from_sa(text, sa, len(text), bwt)
    return bwt


def occ_checkpoints(bwt: np.ndarray, block: int, sigma: int):
    """Native one-pass occ checkpoint table; None without the library."""
    lib = _load()
    if lib is None:
        return None
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    n = len(bwt)
    nblocks = (n + block - 1) // block
    occ = np.zeros((nblocks + 1, sigma), dtype=np.int64)
    lib.psi_occ_checkpoints(bwt, n, block, sigma, occ)
    return occ


def uncovered_loci(node_len, out_indptr, out_indices, paths_nodes,
                   paths_indptr, k: int, step: int):
    """Native uncovered-loci detection; returns (node_ids, offsets) or
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    n = len(node_len)
    handle = lib.psi_uncovered_build(
        n,
        np.ascontiguousarray(node_len, dtype=np.int64),
        np.ascontiguousarray(out_indptr, dtype=np.int64),
        np.ascontiguousarray(out_indices, dtype=np.int64),
        len(paths_indptr) - 1,
        np.ascontiguousarray(paths_nodes, dtype=np.int64),
        np.ascontiguousarray(paths_indptr, dtype=np.int64),
        k,
        step,
    )
    try:
        count = lib.psi_uncovered_count(handle)
        node_ids = np.empty(count, dtype=np.int64)
        offsets = np.empty(count, dtype=np.int64)
        lib.psi_uncovered_export(handle, node_ids, offsets)
    finally:
        lib.psi_uncovered_free(handle)
    return node_ids, offsets


def pick_paths(node_len, out_indptr, out_indices, region_starts, n: int,
               context: int, patched: bool, rng):
    """Native path picking; returns (indptr, nodes, lefts, rights) or
    None without the library. `rng` is a numpy RandomState driving the
    tie-break callback (identical draw sequence to the Python picker)."""
    lib = _load()
    if lib is None:
        return None

    def _draw(n_choices):
        return int(rng.randint(0, n_choices))

    cb = lib._RAND_FN(_draw)
    handle = lib.psi_pick_paths(
        len(node_len),
        np.ascontiguousarray(node_len, dtype=np.int64),
        np.ascontiguousarray(out_indptr, dtype=np.int64),
        np.ascontiguousarray(out_indices, dtype=np.int64),
        len(region_starts),
        np.ascontiguousarray(region_starts, dtype=np.int64),
        n, context, int(patched), cb,
    )
    try:
        count = lib.psi_pick_paths_count(handle)
        total = lib.psi_pick_paths_nodes_total(handle)
        indptr = np.empty(count + 1, dtype=np.int64)
        nodes = np.empty(total, dtype=np.int64)
        lefts = np.empty(count, dtype=np.int64)
        rights = np.empty(count, dtype=np.int64)
        lib.psi_pick_paths_export(handle, indptr, nodes, lefts, rights)
    finally:
        lib.psi_pick_paths_free(handle)
    return indptr, nodes, lefts, rights


def trie_schedule(keys: np.ndarray, k: int, frontier_level: int = 0):
    """Native trie child-schedule (pattern-order frontier + counting
    sort, no per-level argsorts). Returns (parents, chars, leaf_perm,
    frontier_rows) or None without the library. parents/chars are
    tuples of int32 arrays, one per level 1..k, in pattern order;
    leaf_perm[i] = leaf slot of sorted-key i; frontier_rows = the
    level-`frontier_level` prefix values in pattern order (None when
    frontier_level == 0), for ftab seeding."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    handle = lib.psi_trie_schedule(keys, n, k, frontier_level)
    try:
        sizes = np.empty(k, dtype=np.int64)
        lib.psi_trie_sizes(handle, sizes)
        parents, chars = [], []
        for j in range(1, k + 1):
            F = int(sizes[j - 1])
            p = np.empty(F, dtype=np.int32)
            c = np.empty(F, dtype=np.int32)
            lib.psi_trie_level(handle, j, p, c)
            parents.append(p)
            chars.append(c)
        leaf_perm = np.empty(n, dtype=np.int32)
        lib.psi_trie_leaf_perm(handle, leaf_perm)
        rows = None
        if 0 < frontier_level < k:
            rows = np.empty(int(sizes[frontier_level - 1]), dtype=np.int64)
            lib.psi_trie_frontier(handle, rows)
    finally:
        lib.psi_trie_free(handle)
    return tuple(parents), tuple(chars), leaf_perm, rows


def fastq_scan(buf: bytes, max_records: int):
    """Scan FASTQ records in a buffer; returns
    (names, seqs, consumed_bytes) or None without the library."""
    lib = _load()
    if lib is None:
        return None
    data = np.frombuffer(buf, dtype=np.uint8)
    ns = np.empty(max_records, dtype=np.int64)
    nl = np.empty(max_records, dtype=np.int64)
    ss = np.empty(max_records, dtype=np.int64)
    sl = np.empty(max_records, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    nrec = lib.psi_fastq_scan(
        data, len(data), max_records, ns, nl, ss, sl, ctypes.byref(consumed)
    )
    names = [buf[ns[i]: ns[i] + nl[i]].decode("ascii") for i in range(nrec)]
    seqs = [buf[ss[i]: ss[i] + sl[i]].decode("ascii") for i in range(nrec)]
    return names, seqs, consumed.value


def fastq_scan_packed(buf: np.ndarray, max_records: int):
    """Scan FASTQ records from a uint8 buffer view; returns
    (names, data uint8[T], offsets int64[R+1], consumed) with the
    sequence bytes packed contiguously (psi_gather_spans, no per-read
    Python string round trips), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(buf, dtype=np.uint8)
    ns = np.empty(max_records, dtype=np.int64)
    nl = np.empty(max_records, dtype=np.int64)
    ss = np.empty(max_records, dtype=np.int64)
    sl = np.empty(max_records, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    nrec = lib.psi_fastq_scan(
        data, len(data), max_records, ns, nl, ss, sl,
        ctypes.byref(consumed)
    )
    ns, nl, ss, sl = ns[:nrec], nl[:nrec], ss[:nrec], sl[:nrec]
    offsets = np.zeros(nrec + 1, dtype=np.int64)
    np.cumsum(sl, out=offsets[1:])
    packed = np.empty(int(offsets[-1]), dtype=np.uint8)
    if nrec:
        lib.psi_gather_spans(data, ss, sl, nrec, packed)
    names = [
        bytes(data[ns[i]: ns[i] + nl[i]]).decode("ascii")
        for i in range(nrec)
    ]
    return names, packed, offsets, consumed.value


def extract_kmers(seqs, k: int, step: int, greedy_tail: bool = False):
    """Native rolling k-mer extraction (psi_chunk.cpp). Returns
    (keys uint64[S], valid bool[S], seedmap int64[S, 2]) with the same
    window enumeration as ops/kmers.extract_kmers, or None without the
    library."""
    if _load() is None:
        return None
    R = len(seqs)
    text = "".join(seqs).encode("ascii")
    data = np.frombuffer(text, dtype=np.uint8)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=R)
    offsets = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return _extract_kmers_core(data, offsets, k, step, greedy_tail)


def extract_kmers_packed(data: np.ndarray, offsets: np.ndarray, k: int,
                         step: int, greedy_tail: bool = False):
    """extract_kmers over a packed chunk (concatenated uint8 sequence
    bytes + int64 [R+1] offsets): no per-read Python strings, no join.
    Or None without the library."""
    if _load() is None:
        return None
    return _extract_kmers_core(
        np.ascontiguousarray(data, dtype=np.uint8),
        np.ascontiguousarray(offsets, dtype=np.int64),
        k, step, greedy_tail,
    )


def _extract_kmers_core(data, offsets, k, step, greedy_tail):
    lib = _load()
    R = len(offsets) - 1
    lens = offsets[1:] - offsets[:-1]
    nwin = np.where(lens >= k, (lens - k) // step + 1, 0)
    if greedy_tail:
        # end-anchored final window when the last regular start missed
        # the tail (len - k not on the step grid and at least 1 window)
        tail = (nwin > 0) & ((nwin - 1) * step != lens - k)
        nwin = nwin + tail.astype(np.int64)
    out_off = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(nwin, out=out_off[1:])
    S = int(out_off[-1])
    keys = np.empty(S, dtype=np.uint64)
    valid = np.empty(S, dtype=np.uint8)
    seedmap = np.empty(S * 2, dtype=np.int64)
    lib.psi_extract_kmers(
        data, offsets, out_off, R, k, step, int(greedy_tail),
        keys, valid, seedmap,
    )
    return keys, valid.astype(bool), seedmap.reshape(S, 2)


def seed_index_fill(sorted_keys: np.ndarray, k: int, block: int):
    """Native per-depth chars/occ/planes fill over the sorted key
    array (psi_chunk.cpp). Returns (chars, occ, planes) matching
    records.SeedsIndex layouts, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    V = len(sorted_keys)
    nb = (V + block - 1) // block
    sk = np.ascontiguousarray(sorted_keys, dtype=np.uint64)
    chars = np.empty((k, V), dtype=np.uint8)
    occ = np.empty((k, nb + 1, 4), dtype=np.int32)
    planes = np.empty((k, nb + 1, 2), dtype=np.int32)
    lib.psi_seed_index_fill(sk, V, k, block, nb, chars, occ, planes)
    return chars, occ, planes


def radix_sort_kv(keys: np.ndarray, ids: np.ndarray, key_bits: int):
    """Stable in-place LSD radix sort of (keys, ids) by key
    (psi_chunk.cpp). Returns True on success, None without the
    library (caller falls back to np.argsort)."""
    lib = _load()
    if lib is None:
        return None
    n = len(keys)
    tmp_k = np.empty(n, dtype=np.uint64)
    tmp_i = np.empty(n, dtype=np.int64)
    lib.psi_radix_sort_kv(keys, ids, n, key_bits, tmp_k, tmp_i)
    return True


def emit_join(counts, emit_idx, inv, origin, occ_start_u, gpos_stream,
              pm_starts, pm_ids, pm_base, uniq_start, uniq_end,
              seed_ids, seedmap, rec_offset: int, k: int,
              out_off, out_rows: np.ndarray):
    """Fused chain join + seed cross-product + SEED_DTYPE fill
    (psi_chunk.cpp). out_rows is an int64 [total, 6] view of the
    destination structured array. Returns True, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None

    def c64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    lib.psi_emit_join(
        c64(counts), c64(emit_idx), len(emit_idx), c64(inv),
        c64(origin), c64(occ_start_u), c64(gpos_stream),
        c64(pm_starts), c64(pm_ids), c64(pm_base), len(pm_starts),
        c64(uniq_start), c64(uniq_end), c64(seed_ids),
        c64(seedmap).reshape(-1), rec_offset, k, c64(out_off),
        out_rows.reshape(-1),
    )
    return True


def dindex_build(node_len, out_indptr, out_indices, dmax: int):
    """Native distance-index build; returns (src_indptr, dst, lo, hi)
    or None without the library."""
    lib = _load()
    if lib is None:
        return None
    n = len(node_len)
    node_len = np.ascontiguousarray(node_len, dtype=np.int64)
    indptr = np.ascontiguousarray(out_indptr, dtype=np.int64)
    indices = np.ascontiguousarray(out_indices, dtype=np.int64)
    dummy = np.zeros(1, dtype=np.int64)
    handle = lib.psi_dindex_build(
        n, node_len, indptr, indices, 0, dummy, dummy, dmax
    )
    try:
        nnz = lib.psi_dindex_nnz(handle)
        src_indptr = np.empty(n + 1, dtype=np.int64)
        dst = np.empty(nnz, dtype=np.int64)
        lo = np.empty(nnz, dtype=np.int64)
        hi = np.empty(nnz, dtype=np.int64)
        lib.psi_dindex_export(handle, src_indptr, dst, lo, hi)
    finally:
        lib.psi_dindex_free(handle)
    return src_indptr, dst, lo, hi


def dindex_super_build(sup_len, sup_indptr, sup_indices, dmax: int):
    """Native supernode-DAG distance DP; returns (src_indptr, dst, lo,
    hi) over supernode pairs, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    S = len(sup_len)
    handle = lib.psi_dindex_super(
        S,
        np.ascontiguousarray(sup_len, dtype=np.int64),
        np.ascontiguousarray(sup_indptr, dtype=np.int64),
        np.ascontiguousarray(sup_indices, dtype=np.int64),
        dmax,
    )
    if not handle:
        return None  # cyclic (caller falls back to the BFS builder)
    try:
        nnz = lib.psi_dindex_nnz(handle)
        src_indptr = np.empty(S + 1, dtype=np.int64)
        dst = np.empty(nnz, dtype=np.int64)
        lo = np.empty(nnz, dtype=np.int64)
        hi = np.empty(nnz, dtype=np.int64)
        lib.psi_dindex_export(handle, src_indptr, dst, lo, hi)
    finally:
        lib.psi_dindex_free(handle)
    return src_indptr, dst, lo, hi


def gaf_scan(buf: bytes):
    """One-pass GAF column scan for alice dstats. Returns (group, ord,
    pstart, pend, path_indptr, path_coords, n_groups) int64 arrays —
    group = pair-group id per record in first-appearance order — or
    None without the library."""
    lib = _load()
    if lib is None:
        return None
    data = np.frombuffer(buf, dtype=np.uint8)
    if len(data) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, np.zeros(1, dtype=np.int64), z, 0
    handle = lib.psi_gaf_scan(data, len(data))
    try:
        nrec = lib.psi_gaf_nrec(handle)
        ngroups = lib.psi_gaf_ngroups(handle)
        npn = lib.psi_gaf_npathnodes(handle)
        group = np.empty(nrec, dtype=np.int64)
        ordv = np.empty(nrec, dtype=np.int64)
        pstart = np.empty(nrec, dtype=np.int64)
        pend = np.empty(nrec, dtype=np.int64)
        indptr = np.empty(nrec + 1, dtype=np.int64)
        coords = np.empty(npn, dtype=np.int64)
        lib.psi_gaf_export(handle, group, ordv, pstart, pend, indptr, coords)
    finally:
        lib.psi_gaf_free(handle)
    return group, ordv, pstart, pend, indptr, coords, int(ngroups)


def fm_backward_batch(payload: np.ndarray, C: np.ndarray, n: int,
                      codes: np.ndarray):
    """Single-core C++ backward search over the checkpointed bit-plane
    payload (csrc/host/psi_fm.cpp, the speed baseline). payload: int32
    [16, nbpad] (ops/fm_stream.payload_host); codes: int32 [N, k], fed
    column 0 first as the trie search feeds its keys, symbols 1..4.
    Returns (lo, hi, nonempty) or None without the library."""
    lib = _load()
    if lib is None or not hasattr(lib, "psi_fm_backward_batch"):
        return None
    payload = np.ascontiguousarray(payload, dtype=np.int32)
    C = np.ascontiguousarray(C, dtype=np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    N, k = codes.shape
    lo = np.empty(N, dtype=np.int32)
    hi = np.empty(N, dtype=np.int32)
    nonempty = lib.psi_fm_backward_batch(
        payload.reshape(-1), payload.shape[1], C, n,
        codes.reshape(-1), N, k, lo, hi,
    )
    return lo, hi, int(nonempty)
