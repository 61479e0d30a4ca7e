"""Device probes of the distance index (the query half of DiVerG's
accelerator offload, ref: include/psi/seed_finder.hpp:783-790; counterpart
of psi_tpu/ops/dindex_probe.py, with the same names).

The index stores one composite int64 sorted key per interval row
(dindex._pair_keys). A probe for query q answers: does the LAST row with
key <= qkey belong to q's (src, dst) pair and intersect [s_lo, s_hi]?
The keys stay whole int64 here: torch has int64 on the card, where
psi_tpu splits them into two 31-bit halves because JAX's x64 is off.

Tables (`ProbeTables`): pk int64 [n] sorted, and int32 [n] columns src,
dst, iv_lo, iv_hi. Queries: qkey int64 [B], and int32 [B] q_src, q_dst,
s_lo, s_hi. Every function returns bool [B].

  probe_bisect        searchsorted-right of qkey over pk, then the checks
                      at the found row: on CUDA tensors the kernel
                      csrc/dindex_probe.cu (one thread per query), counted
                      in `.launches`; on CPU tensors its plain version
  probe_bisect_plain  psi_tpu's fixed-trip bisection in torch operators,
                      the kernel's plain version
  probe_sort          psi_tpu's sort-merge form in torch operators on
                      either device: one stable sort of rows ++ queries
                      (rows first, so at equal keys a row sorts before a
                      query), a cumsum and a scatter-max

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


class ProbeTables(NamedTuple):
    pk: torch.Tensor      # int64 [n] sorted composite row keys
    src: torch.Tensor     # int32 [n] source row (supernode or node)
    dst: torch.Tensor     # int32 [n]
    iv_lo: torch.Tensor   # int32 [n]
    iv_hi: torch.Tensor   # int32 [n]


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


_PROBE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + \
    [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]


def _check_probe(dev: torch.device, t: ProbeTables, qkey, **queries) -> None:
    """Tables and queries for the kernel: contiguous on `dev`, pk and qkey
    int64, the rest int32, the table columns [n] and the queries [B]."""
    for name, x in (("pk", t.pk), ("qkey", qkey)):
        if x.device != dev or x.dtype != torch.int64 or not x.is_contiguous():
            raise ValueError(f"probe_bisect: {name} must be contiguous int64 "
                             f"on {dev}")
    cols = dict(zip(("src", "dst", "iv_lo", "iv_hi"), t[1:]))
    _build.check_int32("probe_bisect", dev, **cols, **queries)
    if (t.pk.dim() != 1 or any(c.shape != t.pk.shape for c in cols.values())
            or qkey.dim() != 1
            or any(q.shape != qkey.shape for q in queries.values())):
        raise ValueError("probe_bisect: table columns must be [n] and "
                         "query columns [B]")


def probe_bisect(t: ProbeTables, qkey, q_src, q_dst, s_lo,
                 s_hi) -> torch.Tensor:
    """Searchsorted-right of each qkey over pk and the checks at the
    found row, bool [B], in one launch on the card (none when n or B is
    0: the answer is all false, or empty)."""
    dev = qkey.device
    if dev.type == "cpu":
        return probe_bisect_plain(t, qkey, q_src, q_dst, s_lo, s_hi)
    if dev.type != "cuda":
        raise ValueError(f"probe_bisect: unsupported device {dev}")
    _check_probe(dev, t, qkey, q_src=q_src, q_dst=q_dst, s_lo=s_lo,
                 s_hi=s_hi)
    n, B = t.pk.shape[0], qkey.shape[0]
    if n == 0 or B == 0:
        return torch.zeros(B, dtype=torch.bool, device=dev)
    out = torch.empty(B, dtype=torch.bool, device=dev)
    _build.launch(
        "psi_dindex_probe", _PROBE_ARGTYPES,
        t.pk.data_ptr(), t.src.data_ptr(), t.dst.data_ptr(),
        t.iv_lo.data_ptr(), t.iv_hi.data_ptr(), n, qkey.data_ptr(),
        q_src.data_ptr(), q_dst.data_ptr(), s_lo.data_ptr(), s_hi.data_ptr(),
        out.data_ptr(), B, _build.stream_ptr(dev),
    )
    probe_bisect.launches += 1
    return out


probe_bisect.launches = 0
