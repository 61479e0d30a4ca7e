"""Device probes of the distance index (the query half of DiVerG's
accelerator offload, ref: include/psi/seed_finder.hpp:783-790; counterpart
of psi_tpu/ops/dindex_probe.py, with the same names).

The index stores one composite int64 sorted key per interval row
(dindex._pair_keys). A probe for query q answers: does the LAST row with
key <= qkey belong to q's (src, dst) pair and intersect [s_lo, s_hi]?
The keys stay whole int64 here: torch has int64 on the card, where
psi_tpu splits them into two 31-bit halves because JAX's x64 is off.

Tables (`ProbeTables`): pk int64 [n] sorted, and int32 [n] columns src,
dst, iv_lo, iv_hi. `make_tables` also builds, once per upload, what the
kernel reads: the four columns as one 16-byte record a row (`rows`, the
columns become views of it) and a two-level key directory (`top`, `sub`,
`shift`; see `directory`): a query's top bucket, by its key's high bits,
gives the rows to search, or, where the bucket holds more than
SPLIT_ROWS rows, a sub-bucket of about SUB_ROWS rows by the next bits.
Queries: qkey int64 [B], and int32 [B] q_src, q_dst, s_lo, s_hi. Every
probe returns bool [B].

  probe_bisect        searchsorted-right of qkey over pk, then the checks
                      at the found row: on CUDA tensors the kernel
                      csrc/dindex_probe.cu (the directory, a bisection over
                      a few rows and one record read: some three and a
                      half 32-byte sectors a query), counted in
                      `.launches`; on CPU tensors its plain version
  probe_bisect_plain  psi_tpu's fixed-trip bisection in torch operators,
                      the kernel's plain version
  probe_sort          psi_tpu's sort-merge form in torch operators on
                      either device: one stable sort of rows ++ queries
                      (rows first, so at equal keys a row sorts before a
                      query), a cumsum and a scatter-max
  directory_search    the kernel's search through the directory in torch
                      operators: r for each query, and the reads it makes

psi_tpu's probe_bisect and probe_sort are plain XLA, not Pallas kernels,
so the kernel has no TPU counterpart. In eager torch the bisection is
some ten operations a step and the sort form about ten a batch; the
kernel is one launch. PSI_DINDEX_PROBE picks the variant
(dindex._probe_pairs_device); the port's default is bisect.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from psi_tpu_torch import _build

#: log2 of the most top buckets of the key directory (16 bytes each)
DIR_BITS = 20
#: a top bucket of more rows than this splits again
SPLIT_ROWS = 16
#: the rows a sub-bucket aims at: a bucket of c rows splits into
#: 2^ceil(log2(c / SUB_ROWS)) sub-buckets (2 to 2^16)
SUB_ROWS = 2
#: the kernel bisects to this many rows, then loads and counts them
SCAN_ROWS = 4


class ProbeTables(NamedTuple):
    pk: torch.Tensor      # int64 [n] sorted composite row keys
    src: torch.Tensor     # int32 [n] source row (supernode or node)
    dst: torch.Tensor     # int32 [n]
    iv_lo: torch.Tensor   # int32 [n]
    iv_hi: torch.Tensor   # int32 [n]
    #: int32 [n, 4]: (src, dst, iv_lo, iv_hi) of each row, 16 bytes
    rows: torch.Tensor | None = None
    #: int32 [nb, 4]: one entry a top bucket (see `directory`)
    top: torch.Tensor | None = None
    #: int32: the split buckets' sub-directories, one after another
    sub: torch.Tensor | None = None
    #: a key k lies in top bucket (k >> shift) - (pk[0] >> shift)
    shift: int = 0


def key_buckets(pk: torch.Tensor, bits: int) -> tuple[torch.Tensor, int]:
    """Top buckets of sorted int64 keys (n >= 1): (starts int64 [nb + 1],
    the first row of each and then n; shift), with shift the least that
    puts the keys in at most 2^bits buckets of 2^shift keys each, aligned
    at multiples of 2^shift."""
    k0, k1 = (int(k) for k in pk[[0, -1]].tolist())
    shift = max(0, (k1 - k0).bit_length() - bits)
    while (k1 >> shift) - (k0 >> shift) >= 1 << bits:
        shift += 1
    nb = (k1 >> shift) - (k0 >> shift) + 1
    bucket = (pk >> shift) - (k0 >> shift)
    return torch.searchsorted(bucket, torch.arange(
        nb + 1, dtype=torch.int64, device=pk.device)), shift


def directory(pk: torch.Tensor, bits: int | None = None,
              split: int = SPLIT_ROWS, per: int = SUB_ROWS
              ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The two-level key directory of sorted int64 keys, on their device:
    (top int32 [nb, 4], sub int32, shift). Top bucket j (key_buckets, at
    most 2^bits of them; by default 2^min(DIR_BITS, bit_length(n) + 1))
    has the entry

      (first row, end, -1, 0)               up to `split` rows
      (first row, sub offset, off, s | m << 8)   more: split again

    A split bucket's rows go to 2^m sub-buckets, m = ceil(log2(rows /
    per)), by sid(k) = ((k - edge) >> s) - off, edge = the bucket's lowest
    key value j's range starts at, s the least (and at least shift - 31,
    so that off fits) that puts the bucket's keys in 2^m, off = sid's
    offset of its first key; sub[offset + i] is the first row of
    sub-bucket i, and sub[offset + 2^m] the bucket's end. Any sorted
    table: skewed keys only make some bucket large."""
    n, dev = pk.shape[0], pk.device
    if n == 0:
        return (torch.zeros((0, 4), dtype=torch.int32, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), 0)
    if n >= 1 << 31:
        raise ValueError(f"directory: {n} rows do not fit int32 rows")
    if bits is None:
        bits = min(DIR_BITS, n.bit_length() + 1)
    starts, shift = key_buckets(pk, bits)
    lo, hi = starts[:-1], starts[1:]
    top = torch.stack([lo, hi, torch.full_like(lo, -1),
                       torch.zeros_like(lo)], 1)
    j = torch.nonzero(hi - lo > split).flatten()
    sub = torch.zeros(1, dtype=torch.int64, device=dev)
    if j.numel():
        c = hi[j] - lo[j]
        m = torch.ceil(torch.log2(c.double() / per)).long().clamp(1, 16)
        edge = (pk[lo[j]] >> shift) << shift
        first, last = pk[lo[j]] - edge, pk[hi[j] - 1] - edge
        s = torch.full_like(c, max(0, shift - 31))
        while True:
            wide = (last >> s) - (first >> s) >= (1 << m)
            if not bool(wide.any()):
                break
            s += wide.long()
        off = first >> s
        size = (1 << m) + 1
        base = torch.cumsum(size, 0) - size
        top[j, 1], top[j, 2], top[j, 3] = base, off, s | (m << 8)
        # each split row's sub-bucket as a key ordered across buckets;
        # before[i]: the split rows of the buckets before split bucket i
        before = torch.cumsum(c, 0) - c
        owner = torch.repeat_interleave(torch.arange(j.numel(), device=dev),
                                        c)
        row = lo[j][owner] + torch.arange(owner.numel(), device=dev) - \
            before[owner]
        gkey = base[owner] + ((pk[row] - edge[owner]) >> s[owner]) - off[owner]
        ent = torch.repeat_interleave(torch.arange(j.numel(), device=dev),
                                      size)
        slot = torch.arange(ent.numel(), device=dev)
        sub = lo[j][ent] + torch.searchsorted(gkey, slot) - before[ent]
    return (top.to(torch.int32).contiguous(),
            sub.to(torch.int32).contiguous(), shift)


def make_tables(pk: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                iv_lo: torch.Tensor, iv_hi: torch.Tensor) -> ProbeTables:
    """ProbeTables with the row records and the key directory on pk's
    device (the columns int32 [n], moved there): what probe_bisect's
    kernel reads."""
    rows = torch.stack([c.to(torch.int32) for c in (src, dst, iv_lo, iv_hi)],
                       dim=1).to(pk.device)
    top, sub, shift = directory(pk)
    return ProbeTables(pk, *rows.unbind(1), rows=rows, top=top, sub=sub,
                       shift=shift)


def directory_search(t: ProbeTables, qkey: torch.Tensor,
                     trace: list | None = None) -> torch.Tensor:
    """The kernel's search in torch operators: each query's top bucket
    (the first or the last for a key outside the table) and, where it
    split, sub-bucket; a bisection over those rows down to SCAN_ROWS, then
    a count of the keys left. Returns r, the searchsorted-right of qkey
    over pk (int64 [B]); with a list `trace`, appends (table, entries) for
    each read the kernel makes: ("top", bucket), ("sub", entry) twice
    and ("pk", row) for each key, -1 where a query reads none."""
    n = t.pk.shape[0]
    if n == 0 or qkey.shape[0] == 0:
        return torch.zeros(qkey.shape[0], dtype=torch.int64,
                           device=qkey.device)
    k0 = t.pk[0]
    qc = qkey.clamp(k0, t.pk[-1])
    b = (qc >> t.shift) - (k0 >> t.shift)
    e = t.top[b].long()
    split = e[:, 2] >= 0
    s, m = e[:, 3] & 0xFF, e[:, 3] >> 8
    edge = ((k0 >> t.shift) + b) << t.shift
    sid = (((qc - edge) >> s) - e[:, 2]).clamp(min=0)
    sid = torch.minimum(sid, (1 << m) - 1)
    at = torch.where(split, e[:, 1] + sid, 0)
    sub = t.sub.long()
    lo = torch.where(split, sub[at], e[:, 0])
    hi = torch.where(split, sub[(at + 1).clamp(max=sub.numel() - 1)],
                     e[:, 1])
    if trace is not None:
        trace += [("top", b), ("sub", torch.where(split, at, -1)),
                  ("sub", torch.where(split, at + 1, -1))]
    for _ in range(int((hi - lo).max()).bit_length()):
        live = hi - lo > SCAN_ROWS
        mid = torch.div(lo + hi, 2, rounding_mode="floor").clamp(0, n - 1)
        le = t.pk[mid] <= qkey
        lo = torch.where(live & le, mid + 1, lo)
        hi = torch.where(live & ~le, mid, hi)
        if trace is not None:
            trace.append(("pk", torch.where(live, mid, -1)))
    count = torch.zeros_like(lo)
    for i in range(SCAN_ROWS):
        there = lo + i < hi
        row = (lo + i).clamp(max=n - 1)
        count += there & (t.pk[row] <= qkey)
        if trace is not None:
            trace.append(("pk", torch.where(there, row, -1)))
    return lo + count


def _checks(t: ProbeTables, r, q_src, q_dst, s_lo, s_hi) -> torch.Tensor:
    """The row checks at rc = clip(r - 1, 0, n - 1), r = searchsorted-right
    (int64 [B]): the row exists, is the queried pair's and intersects."""
    rc = (r - 1).clamp(0, t.pk.shape[0] - 1)
    return ((r >= 1) & (t.src[rc] == q_src) & (t.dst[rc] == q_dst)
            & (t.iv_hi[rc] >= s_lo) & (t.iv_lo[rc] <= s_hi))


def probe_bisect_plain(t: ProbeTables, qkey, q_src, q_dst, s_lo,
                       s_hi) -> torch.Tensor:
    """Plain PyTorch version of csrc/dindex_probe.cu: psi_tpu's
    fixed-trip bisection (bit_length(n) steps, a lane stops once its
    range is empty), then the checks."""
    n = t.pk.shape[0]
    if n == 0:
        return torch.zeros(qkey.shape[0], dtype=torch.bool,
                           device=qkey.device)
    lo = torch.zeros(qkey.shape[0], dtype=torch.int64, device=qkey.device)
    hi = torch.full_like(lo, n)
    for _ in range(max(n.bit_length(), 1)):
        live = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor").clamp(0, n - 1)
        le = t.pk[mid] <= qkey
        lo = torch.where(live & le, mid + 1, lo)
        hi = torch.where(live & ~le, mid, hi)
    return _checks(t, lo, q_src, q_dst, s_lo, s_hi)


def probe_sort(t: ProbeTables, qkey, q_src, q_dst, s_lo,
               s_hi) -> torch.Tensor:
    """Merge-by-sort searchsorted (psi_tpu's probe_sort): a stable sort of
    the keys of rows ++ queries places rows first at equal keys, so a
    query at merged slot i has r = i - (queries at or before i) + 1."""
    n, B = t.pk.shape[0], qkey.shape[0]
    dev = qkey.device
    if n == 0:
        return torch.zeros(B, dtype=torch.bool, device=dev)
    order = torch.sort(torch.cat([t.pk, qkey]), stable=True).indices
    tag = order >= n
    r_at_slot = (torch.arange(n + B, dtype=torch.int64, device=dev)
                 - torch.cumsum(tag, 0) + 1)
    qslot = torch.where(tag, order - n, torch.full_like(order, B))
    r = torch.zeros(B + 1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, qslot, r_at_slot, reduce="amax")[:B]
    return _checks(t, r, q_src, q_dst, s_lo, s_hi)


_PROBE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int64] + \
    [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]


def _check_probe(name: str, dev: torch.device, t: ProbeTables, qkey,
                 tables: dict, **queries) -> None:
    """Tables and queries for a kernel: contiguous on `dev`, pk and qkey
    int64 [n] and [B], the int32 `tables` of n rows and the queries
    [B]."""
    for arg, x in (("pk", t.pk), ("qkey", qkey)):
        if x.device != dev or x.dtype != torch.int64 or not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous int64 on "
                             f"{dev}")
    _build.check_int32(name, dev, **tables, **queries)
    if (t.pk.dim() != 1 or qkey.dim() != 1
            or any(c.shape[0] != t.pk.shape[0] for c in tables.values())
            or any(q.shape != qkey.shape for q in queries.values())):
        raise ValueError(f"{name}: table columns must be [n] and query "
                         f"columns [B]")


def probe_bisect(t: ProbeTables, qkey, q_src, q_dst, s_lo,
                 s_hi) -> torch.Tensor:
    """Searchsorted-right of each qkey over pk and the checks at the
    found row, bool [B], in one launch on the card (none when n or B is
    0: the answer is all false, or empty). On the card the tables must
    come from make_tables."""
    dev = qkey.device
    if dev.type == "cpu":
        return probe_bisect_plain(t, qkey, q_src, q_dst, s_lo, s_hi)
    if dev.type != "cuda":
        raise ValueError(f"probe_bisect: unsupported device {dev}")
    if t.rows is None or t.top is None or t.sub is None:
        raise ValueError("probe_bisect: the tables have no row records or "
                         "key directory (build them with make_tables)")
    _check_probe("probe_bisect", dev, t, qkey, {"rows": t.rows},
                 q_src=q_src, q_dst=q_dst, s_lo=s_lo, s_hi=s_hi)
    _build.check_int32("probe_bisect", dev, top=t.top, sub=t.sub)
    n, B = t.pk.shape[0], qkey.shape[0]
    if n == 0 or B == 0:
        return torch.zeros(B, dtype=torch.bool, device=dev)
    if (t.rows.shape[1:] != (4,) or t.top.dim() != 2
            or t.top.shape[0] < 1 or t.top.shape[1:] != (4,)
            or t.rows.data_ptr() % 16 or t.top.data_ptr() % 16
            or not 0 <= t.shift < 64):
        raise ValueError("probe_bisect: rows [n, 4] and the directory's top "
                         "[nb, 4] (nb >= 1) must be 16-byte aligned")
    out = torch.empty(B, dtype=torch.bool, device=dev)
    _build.launch(
        "psi_dindex_probe", _PROBE_ARGTYPES, dev,
        t.pk.data_ptr(), t.rows.data_ptr(), t.top.data_ptr(),
        t.sub.data_ptr(), t.shift, t.top.shape[0], n, qkey.data_ptr(),
        q_src.data_ptr(), q_dst.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(),
        out.data_ptr(), B, _build.stream_ptr(dev),
    )
    probe_bisect.launches += 1
    return out


probe_bisect.launches = 0
