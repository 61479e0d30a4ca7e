"""Device timing on the card and the sector counts its bounds rest on,
shared by chip_smoke.py and tools/gchar3.py.

  cuda_ms        mean device ms of a callable over many runs (CUDA events
                 around the whole batch, a spin kernel queued first)
  bracketed_ms   mean device ms of one kernel launched right after a
                 set-up launch, events around that kernel alone
  card_line      the card's name and power limit as nvidia-smi gives them
  r4_sectors     distinct 32-byte sectors of a rank table that compact's
                 words land on
  row_sectors    distinct 32-byte sectors of an occ table that gathered
                 rows lie in
  probe_sectors  32-byte sectors of the tables that one query of the
                 distance index's probe kernel reads

The timing functions need a CUDA device: none falls back to a host
clock. A scattered 4-byte read from a table past L2 costs the card the
whole 32-byte sector around it, so the bounds count sectors there.
"""

from __future__ import annotations

import subprocess

#: cycles of the spin kernel that holds the stream while a timed batch is
#: enqueued: about 0.25 s at the H100's clocks, far longer than the host
#: takes to enqueue the ~1000 launches CUDA queues ahead, and the wall time
#: each timing spends waiting
SPIN_CYCLES = 500_000_000
#: H100 SXM peak HBM bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` runs, by CUDA events
    after one warm-up run. A spin kernel queued first holds the stream
    until every run is enqueued, so the host's launch overhead between
    launches is not counted (keep reps x launches per run well under the
    ~1000 launches CUDA queues ahead)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bracketed_ms(setup, kernel, n: int, reps: int) -> float:
    """Mean device milliseconds of kernel(j, setup(j)) over j in range(n)
    and `reps` rounds, each launched right after setup(j) (whose result it
    takes) with a pair of CUDA events around the kernel alone: the time of
    a kernel that finds in L2 what the launch before it wrote. A spin
    kernel queued first holds the stream while the rounds are enqueued
    (keep reps x n x (launches + 2) well under ~1000)."""
    import torch

    for j in range(n):
        kernel(j, setup(j))
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(SPIN_CYCLES)
    for _ in range(reps):
        for j in range(n):
            made = setup(j)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            kernel(j, made)
            end.record()
            pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


def card_line() -> str:
    """`name, power limit` of the first card, from nvidia-smi; raises if
    nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def distinct_sectors(byte_addr) -> int:
    """Distinct 32-byte sectors that the byte addresses (a tensor) fall
    in."""
    import torch

    return int(torch.unique(byte_addr.long() >> 5).numel())


def r4_sectors(mprev: int, parents, chars) -> int:
    """Distinct sectors of one int32 [4, Mprev] rank table that compact's
    words (char - 1, parent) land on; r4lo and r4hi have the same."""
    return distinct_sectors(4 * ((chars.long() - 1) * mprev + parents.long()))


def row_sectors(width: int, pos) -> int:
    """Distinct sectors of an int32 [R, width] table (width 4 or 8) that
    the rows at the positions lie in: a row of 16 or 32 bytes lies in
    one."""
    return distinct_sectors(4 * width * pos.long())


def probe_sectors(t, qkey) -> float:
    """Mean distinct 32-byte sectors of the tables that a query of
    probe_bisect's kernel reads, as ops/dindex_probe.directory_search
    replays its search: the top entry of its bucket, the two
    sub-directory entries where the bucket splits, the keys of its
    bisection and count, and the row record at r - 1. The query's own
    columns, streamed, and the first key, which every query reads, are not
    counted."""
    import torch

    from psi_tpu_torch.ops import dindex_probe

    trace = []
    r = dindex_probe.directory_search(t, qkey, trace)
    trace.append(("rows", torch.where(r >= 1, r - 1, -1)))
    width = {"top": 16, "sub": 4, "pk": 8, "rows": 16}
    tables = list(width)
    space = 1 << 40      # one address space per table
    cols = [torch.where(i >= 0, tables.index(name) * space
                        + ((width[name] * i) >> 5), -1)
            for name, i in trace]
    s = torch.stack(cols, 1).sort(1).values
    first = int((s[:, 0] >= 0).sum())
    rest = int(((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum())
    return (first + rest) / max(qkey.numel(), 1)
