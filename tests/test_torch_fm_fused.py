"""psi_tpu_torch.ops.fm_fused against psi_tpu.ops.fm_fused: the trie-level
kernel's plain version (over the per-char rank words payloadC), chained over
every level, against the fused Pallas kernel (interpret mode), on
identical state given through psi_tpu_torch.convert; and one level at
the edges of a rank against the host FM index. int32 throughout:
equality is exact over all Npad slots."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from psi_tpu.fmindex import FMIndex
from psi_tpu.ops import fm as jfm
from psi_tpu.ops import fm_fused as jfused
from psi_tpu.ops import fm_stream as jfs
from psi_tpu.ops import fm_trie as jtrie
from psi_tpu_torch import convert
from psi_tpu_torch.ops import fm_fused, fm_stream
from tests.test_torch_fm_stream import EDGES, _edge_pairs, _edge_select

CPU = torch.device("cpu")
K = 12


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(23)
    s = "".join(rng.choice(list("ACGT"), size=40_000))
    fm = FMIndex.build_from_strings([s[::-1], s[7_000:19_000][::-1]])
    lut = {c: i for i, c in enumerate("ACGT")}
    present = [
        sum(lut[ch] << (2 * (K - 1 - j)) for j, ch in enumerate(s[p:p + K]))
        for p in range(0, len(s) - K, 37)
    ]
    keys = np.unique(np.concatenate([
        rng.randint(0, 4 ** K, size=2000).astype(np.uint64),
        np.asarray(present, dtype=np.uint64),
    ]))
    ftab = jfm.build_ftab(fm, 5)
    prep = jtrie.prepare(keys, K, ftab, to_device=False, wire="plain",
                         pack=False)
    return fm, keys, prep


@pytest.fixture
def small_tiles(monkeypatch):
    """psi_tpu's fused kernel with one 1024-child slab per grid step and
    one unrolled parent window (its PSI_FSLABS / PSI_FUSED_PUNROLL knobs,
    read at import): the same results, and a trace small enough for
    interpret mode. The module is reloaded back afterwards."""
    monkeypatch.setenv("PSI_FSLABS", "1")
    monkeypatch.setenv("PSI_FUSED_PUNROLL", "1")
    yield importlib.reload(jfused)
    monkeypatch.delenv("PSI_FSLABS")
    monkeypatch.delenv("PSI_FUSED_PUNROLL")
    importlib.reload(jfused)


def test_trie_fused_matches_pallas(setup, small_tiles):
    fm, _, prep = setup
    ref = jfs.build_stream_arrays(fm)
    assert ref.payloadW is not None
    jlo, jhi = small_tiles.trie_fused(
        ref, jnp.asarray(prep.parents), jnp.asarray(prep.chars),
        jnp.asarray(prep.lo0), jnp.asarray(prep.hi0), interpret=True,
    )
    arr = convert.stream_arrays(ref, CPU)
    tp = convert.prepared_trie(prep, CPU)
    n0 = fm_fused.trie_level.launches
    lo, hi = fm_fused.trie_fused(arr, tp.parents, tp.chars, tp.lo0, tp.hi0)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert (hi > lo).any()
    assert fm_fused.trie_level.launches == n0    # CPU: plain version


def test_trie_level_is_one_lf_step(setup):
    """One level from the root [0, n) gives the single-char SA ranges."""
    fm, _, _ = setup
    arr = fm_stream.build_stream_arrays(fm, CPU)
    parent = torch.zeros(4, dtype=torch.int32)
    char = torch.arange(1, 5, dtype=torch.int32)
    root_lo = torch.zeros(1, dtype=torch.int32)
    root_hi = torch.full((1,), fm.size, dtype=torch.int32)
    lo, hi = fm_fused.trie_level_plain(arr.payloadC, arr.C, parent, char,
                                       root_lo, root_hi)
    for c in range(1, 5):
        assert (int(lo[c - 1]), int(hi[c - 1])) == fm.lf_step(c, 0, fm.size)


@pytest.mark.parametrize("edge", EDGES)
def test_trie_level_plain_edges(setup, edge):
    """One level through trie_level on the CPU (its plain version) from a
    frontier of edge pairs, each parent's four children in c-major order
    as the schedule lays them out: every child is C[c] + the host FM
    index's rank at its parent's lo and hi."""
    fm, _, _ = setup
    arr = fm_stream.build_stream_arrays(fm, CPU)
    _, lo, hi = _edge_select(edge, *_edge_pairs(fm.size,
                                                np.random.RandomState(7)),
                             fm.size)
    m = len(lo)
    parent = torch.arange(m, dtype=torch.int32).repeat(4)
    char = torch.arange(1, 5, dtype=torch.int32).repeat_interleave(m)
    out = (torch.empty(4 * m, dtype=torch.int32),
           torch.empty(4 * m, dtype=torch.int32))
    n0 = fm_fused.trie_level.launches
    fm_fused.trie_level(arr.payloadC, arr.C, parent, char, lo, hi, *out)
    assert fm_fused.trie_level.launches == n0    # CPU: plain version
    plain = fm_fused.trie_level_plain(arr.payloadC, arr.C, parent, char, lo,
                                      hi)
    for got, want in zip(out, plain):
        assert torch.equal(got, want)
    want = [fm.lf_step(int(c), int(lo[p]), int(hi[p]))
            for p, c in zip(parent, char)]
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), want)
