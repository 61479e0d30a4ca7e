"""The port's Hamming ball (`ops/kmers.expand_hamming`) against psi_tpu's:
both returned arrays bit-equal, dtypes included, at every radius the
route takes and past it, and where keys collide across origins (k = 4).
A ball of radius 3 at k = 32 is ~0.9 M rows a key, seconds in psi_tpu's
sort, so that case is left out."""

import numpy as np
import pytest

from psi_tpu.ops.kmers import expand_hamming as jexpand_hamming
from psi_tpu_torch.ops.kmers import expand_hamming


def _keys(k, m):
    """Up to 300 seeded keys, fewer where the ball (up to (3k)^m rows a
    key) would pass ~300,000 rows."""
    ball = sum((3 * k) ** i for i in range(m + 1))
    rng = np.random.default_rng(1000 * k + m)
    hi = np.iinfo(np.uint64).max if k == 32 else (1 << 2 * k) - 1
    n = max(1, min(300, 300_000 // ball))
    return rng.integers(0, hi, size=n, dtype=np.uint64, endpoint=True)


#: (k, m): every radius at k = 4, 20, 32 but (32, 3)
CASES = [(k, m) for k in (4, 20, 32) for m in (0, 1, 2, 3)
         if (k, m) != (32, 3)]


@pytest.mark.parametrize("k, m", CASES)
def test_expand_hamming_matches_psi_tpu(k, m):
    keys = _keys(k, m)
    got, want = expand_hamming(keys, k, m), jexpand_hamming(keys, k, m)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if k == 4:      # one key in the balls of several origins
        assert len(np.unique(got[0])) < len(got[0])
