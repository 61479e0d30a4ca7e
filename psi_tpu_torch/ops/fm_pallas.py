"""Occ-row gathers over the dense per-position occ table.

Counterpart of psi_tpu/ops/fm_pallas.py (the module keeps its name, as
fm_fused and fm_stream did). One backward-search step over a dense occ
table is, for every query,

    new_lo = C[c] + occ[lo, c-1]
    new_hi = C[c] + occ[hi, c-1]

so its only memory work is one word of lo's occ row and one of hi's.
Two wrappers over csrc/occ_gather.cu, each running its kernel for CUDA
tensors and counting those launches in `.launches`, its plain PyTorch
version for CPU tensors, and raising on any other device (neither falls
back):

  gather_occ_rows  psi_occ_gather   whole rows at positions, a 16-byte
                                    piece of a row per lane
  lf_pair          psi_occ_lf_pair  the step above for every key, a
                                    lane pair per key, one launch per step

psi_tpu's two Pallas kernels (`_step_kernel` behind `gather_occ_rows`, and
the windowed kernel behind `gather_occ_rows_blocked`) differ only in how
rows reach VMEM, so both map onto the row gather; `lf_pair` folds into
the gather what `backward_search_pallas` does with `_step_kernel`'s rows.
The tables both take: psi_tpu's padded `[n+1, 8]` (`occ_dense_padded`)
and `to_device`'s dense `[n+1, 4]` layout (ops/fm.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from psi_tpu_torch import _build
from psi_tpu_torch.device import resolve

#: row widths the kernel takes (int32 lanes): to_device's dense layout and
#: psi_tpu's padded table
WIDTHS = (4, 8)

_OCC_GATHER_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_OCC_LF_PAIR_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p]


def gather_occ_rows_plain(occ: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of csrc/occ_gather.cu."""
    return occ[positions.long()]


def gather_occ_rows(occ: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rows of an int32 occ table [R, W] (W in WIDTHS) at int32
    positions [M] in [0, R): int32 [M, W]. Positions are not range-checked
    on the device."""
    dev = positions.device
    if dev.type == "cpu":
        return gather_occ_rows_plain(occ, positions)
    if dev.type != "cuda":
        raise ValueError(f"gather_occ_rows: unsupported device {dev}")
    _build.check_int32("gather_occ_rows", dev, occ=occ, positions=positions)
    if occ.dim() != 2 or occ.shape[1] not in WIDTHS:
        raise ValueError(f"gather_occ_rows: occ must be [R, W] with W in "
                         f"{WIDTHS}, not {tuple(occ.shape)}")
    if positions.dim() != 1:
        raise ValueError("gather_occ_rows: positions must be [M]")
    if occ.data_ptr() % 16:
        raise ValueError("gather_occ_rows: occ is not 16-byte aligned")
    m = positions.shape[0]
    rows = torch.empty((m, occ.shape[1]), dtype=torch.int32, device=dev)
    if m == 0:
        return rows
    _build.launch(
        "psi_occ_gather", _OCC_GATHER_ARGTYPES, dev,
        occ.data_ptr(), occ.shape[1], positions.data_ptr(), rows.data_ptr(),
        m, _build.stream_ptr(dev),
    )
    gather_occ_rows.launches += 1
    return rows


gather_occ_rows.launches = 0


def check_codes(codes: torch.Tensor) -> None:
    """Raise unless every code is an ACGT code 1..4. psi_tpu's XLA gathers
    clamp other codes to a neighbouring column; the engine never sends
    them (keys_to_codes gives 1..4, find_mems_device clips), so the port
    rejects them instead of copying the clamp."""
    if codes.numel() and not bool(((codes >= 1) & (codes <= 4)).all()):
        bad = codes[(codes < 1) | (codes > 4)][:4].tolist()
        raise ValueError(f"codes must be ACGT codes 1..4; got {bad}")


def lf_pair_plain(occ: torch.Tensor, C: torch.Tensor, c: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of csrc/occ_gather.cu's psi_occ_lf_pair: one
    row gather of the concatenated positions, then column c-1 and C[c]."""
    m = lo.shape[0]
    rows = gather_occ_rows_plain(occ, torch.cat([lo, hi]))
    col = (c.long() - 1).repeat(2)[:, None]
    occ_c = rows.gather(1, col)[:, 0]
    base = C[c.long()]
    return base + occ_c[:m], base + occ_c[m:]


def lf_pair(occ: torch.Tensor, C: torch.Tensor, c: torch.Tensor,
            lo: torch.Tensor, hi: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LF step of lo and hi on a dense occ table [R, W] (W in
    WIDTHS): (C[c] + occ[lo, c-1], C[c] + occ[hi, c-1]), int32 [M] each,
    in one launch. c holds codes 1..4 and lo, hi positions in [0, R);
    neither is checked on the device."""
    dev = lo.device
    if dev.type == "cpu":
        return lf_pair_plain(occ, C, c, lo, hi)
    if dev.type != "cuda":
        raise ValueError(f"lf_pair: unsupported device {dev}")
    _build.check_int32("lf_pair", dev, occ=occ, C=C, c=c, lo=lo, hi=hi)
    if occ.dim() != 2 or occ.shape[1] not in WIDTHS:
        raise ValueError(f"lf_pair: occ must be [R, W] with W in {WIDTHS}, "
                         f"not {tuple(occ.shape)}")
    if lo.dim() != 1 or not lo.shape == hi.shape == c.shape:
        raise ValueError("lf_pair: c, lo and hi must be [M] each")
    m = lo.shape[0]
    lo_out = torch.empty(m, dtype=torch.int32, device=dev)
    hi_out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return lo_out, hi_out
    _build.launch(
        "psi_occ_lf_pair", _OCC_LF_PAIR_ARGTYPES, dev,
        occ.data_ptr(), occ.shape[1], C.data_ptr(), c.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), lo_out.data_ptr(), hi_out.data_ptr(),
        m, _build.stream_ptr(dev),
    )
    lf_pair.launches += 1
    return lo_out, hi_out


lf_pair.launches = 0


def backward_search_pallas(occ_padded: torch.Tensor, C: torch.Tensor, n: int,
                           codes: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full k-step backward search over int32 code rows [N, k] (fed
    column 0 first) from the whole text [0, n), one `lf_pair` launch per
    step: (lo, hi) int32 [N]. Empty ranges keep stepping (they
    stay empty; compare hi - lo, and lo only where hi > lo)."""
    check_codes(codes)
    N = codes.shape[0]
    dev = codes.device
    lo = torch.zeros(N, dtype=torch.int32, device=dev)
    hi = torch.full((N,), int(n), dtype=torch.int32, device=dev)
    for c in codes.t().contiguous():
        lo, hi = lf_pair(occ_padded, C, c, lo, hi)
    return lo, hi


def gather_occ_rows_blocked(occ_padded_np: np.ndarray, positions: np.ndarray,
                            device: torch.device | str | None = None
                            ) -> np.ndarray:
    """psi_tpu's blocked gather, numpy in and numpy out: positions [M] ->
    occ rows [M, W]. The positions are stable-sorted on the device (the
    card unless `device` names the CPU), gathered in sorted order by
    `gather_occ_rows`, and scattered back to their input order.

    psi_tpu also cuts the sorted pointers into groups of at most GROUP
    (512) inside H_ROWS (2048)-row windows (`partition_pointers`) and pads
    the table to whole windows, so that each group's window fits VMEM.
    That staging has no counterpart on the card and is not carried over:
    the sort is all that remains of it."""
    dev = resolve("cuda") if device is None else torch.device(device)
    occ = torch.from_numpy(np.ascontiguousarray(occ_padded_np,
                                                dtype=np.int32)).to(dev)
    pos = torch.from_numpy(np.ascontiguousarray(positions,
                                                dtype=np.int32)).to(dev)
    sorted_pos, order = torch.sort(pos, stable=True)
    out = torch.empty((pos.shape[0], occ.shape[1]), dtype=torch.int32,
                      device=dev)
    out[order] = gather_occ_rows(occ, sorted_pos)
    return out.cpu().numpy()


def occ_dense_padded(fm) -> np.ndarray:
    """Host: dense per-position occ padded to 8 int32 lanes."""
    n = fm.size
    dense = np.zeros((n + 1, 8), dtype=np.int32)
    for c in range(1, 5):
        dense[1:, c - 1] = np.cumsum(fm.bwt == c, dtype=np.int32)
    return dense
