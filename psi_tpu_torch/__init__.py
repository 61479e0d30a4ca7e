"""psi_tpu_torch — the psi_tpu seed-finding engine on PyTorch and CUDA.

A second package beside `psi_tpu`, which stays the reference it is held
against. Module names mirror `psi_tpu`'s so each counterpart is easy to
find:

  device.py        -- resolves `--device {cuda,cpu}` (no silent fallback)
  _build.py        -- compiles csrc/*.cu (nvcc) and csrc/host/*.cpp (g++)
  native.py        -- ctypes bindings of the native host library
  convert.py       -- psi_tpu state (as numpy) -> this package's tensors
  ops/fm_stream.py -- rank payloads; rank4_pair, rank4, compact and rank
                      kernels; backward_search_sorted
  ops/fm_fused.py  -- the one-level trie extension kernel (main path)
  ops/fm.py        -- ftab, dense SA upload, SA-position mapping arrays
  ops/fm_trie.py   -- trie schedule, prepare, level routes, expand + locate
  ops/traverse.py  -- the host WalkTree (off-path route)
  seed_finder.py   -- SeedFinder: psi_tpu's host lifecycle, these routes
  parallel/        -- the device mesh, the sharded query pipeline and the
                      multi-process runtime (gloo) with the sharded index
  graft.py         -- a batched search and the multi-device dry run
  cli.py           -- the psikt chunk loop with `--device` and `--devices`
  tools/           -- psi_tpu's tool CLIs (pindexctl, loci_stats, sloci,
                      ggsim, dindexctl, alice), the multi-process worker
                      and the chip sweeps

The host layers (graph, graphiter, pathutil, pathset, fmindex, records,
seed, stats, simulate, io, ops/kmers, tools/ggsim) are copies of
psi_tpu's with their imports pointed here (ops/kmers' expand_hamming
dedups only from two mismatches, where keys repeat), and csrc/host/
holds copies of the native C++ they call. This package imports neither
jax nor psi_tpu.
"""

__version__ = "0.1.0"
