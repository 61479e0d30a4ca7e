"""The yardsticks of chip_smoke.py and tools/timing.py, on the CPU: the
sector counts their bounds rest on against a brute-force count, the
work functions built on them, the vector checks the wrappers run before
a launch, and the bacterial cell's writers and LF-step replay."""

import numpy as np
import pytest
import torch

import chip_smoke
from psi_tpu_torch.fmindex import FMIndex
from psi_tpu_torch.io import load_graph
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_stream
from psi_tpu_torch.simulate import make_pangenome_graph
from psi_tpu_torch.tools import bacterial, timing


def _sectors(byte_addrs) -> int:
    """Distinct 32-byte sectors, one address at a time."""
    return len({int(a) // 32 for a in byte_addrs})


def _i32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


def _schedule(mprev, m, seed):
    """Children c-major with ascending parents, as the trie schedule
    orders them, and some parents shared (duplicate words)."""
    rng = np.random.RandomState(seed)
    chars = np.sort(rng.randint(1, 5, size=m))
    parents = np.concatenate([np.sort(rng.randint(0, mprev, size=int(n)))
                              for n in np.bincount(chars, minlength=5)[1:]])
    return parents, chars


@pytest.mark.parametrize("mprev,m,seed", [(1, 4, 0), (37, 100, 1),
                                          (5000, 20000, 2), (8192, 8192, 3)])
def test_r4_sectors_match_brute_force(mprev, m, seed):
    parents, chars = _schedule(mprev, m, seed)
    want = _sectors(4 * ((c - 1) * mprev + p) for c, p in zip(chars, parents))
    assert timing.r4_sectors(mprev, _i32(parents), _i32(chars)) == want
    r4lo = torch.zeros((4, mprev), dtype=torch.int32)
    nbytes, ops = chip_smoke.compact_sector_work(r4lo, _i32(parents),
                                                 _i32(chars))
    # parents and chars in, lo' and hi' out, a sector of r4lo and of r4hi
    assert nbytes == 16 * m + 2 * 32 * want
    assert ops == 6 * m


@pytest.mark.parametrize("order", ["scattered", "sorted"])
@pytest.mark.parametrize("width", [4, 8])
def test_row_sectors_match_brute_force(width, order):
    rng = np.random.RandomState(width)
    rows = 10_001
    pos = np.concatenate([rng.randint(0, rows, size=6000), [0, rows - 1] * 3,
                          np.full(50, 17)])
    if order == "sorted":
        pos = np.sort(pos)
    want = _sectors(4 * width * p for p in pos)
    assert timing.row_sectors(width, _i32(pos)) == want
    occ = torch.zeros((rows, width), dtype=torch.int32)
    nbytes, ops = chip_smoke.occ_gather_sector_work(occ, _i32(pos))
    # positions in, every row out, one sector per distinct table sector
    assert nbytes == 4 * len(pos) + 4 * width * len(pos) + 32 * want
    assert ops == 4 * len(pos)
    # the byte bound counts each distinct row once instead
    assert chip_smoke.occ_gather_work(occ, _i32(pos))[0] == (
        4 * len(pos) + 4 * width * (len(pos) + len(set(pos.tolist()))))


@pytest.mark.parametrize("width", [4, 8])
def test_occ_sectors_match_brute_force(width):
    """occ_lf_pair's count: the sectors of the (lo, c) and (hi, c)
    words."""
    rng = np.random.RandomState(20 + width)
    lo = rng.randint(0, 9000, size=3000)
    hi = np.minimum(lo + rng.choice([0, 1, 2, 9, 300], size=3000), 9000)
    c = rng.randint(1, 5, size=3000)
    want = _sectors(4 * (p * width + ch - 1)
                    for p, ch in zip(np.concatenate([lo, hi]),
                                     np.concatenate([c, c])))
    occ = torch.zeros((9001, width), dtype=torch.int32)
    assert chip_smoke.occ_sectors(occ, _i32(c), _i32(lo), _i32(hi)) == want


def test_check_vectors():
    """Pairs need 8-byte aligned bases, other vectors none; shapes must
    agree."""
    t = torch.zeros(64, dtype=torch.int32)
    cpu = t.device
    fm_stream.check_vectors("k", cpu, pairs=("a",), a=t[2:34], b=t[1:33])
    with pytest.raises(ValueError, match="k: a is not 8-byte aligned"):
        fm_stream.check_vectors("k", cpu, pairs=("a",), a=t[1:33])
    with pytest.raises(ValueError, match=r"a, b must be \[M\] each"):
        fm_stream.check_vectors("k", cpu, a=t[:32], b=t[:16])
    with pytest.raises(ValueError, match="int32"):
        fm_stream.check_vectors("k", cpu, a=t.long())
    with pytest.raises(ValueError, match="contiguous"):
        fm_stream.check_vectors("k", cpu, a=t[::2])


def test_bacterial_gfa_round_trip(tmp_path):
    graph = make_pangenome_graph(4000, 0.02, seed=3)
    path = str(tmp_path / "g.gfa")
    bacterial.write_gfa(graph, path)
    back = load_graph(path, cache=False)
    assert back.node_count == graph.node_count
    assert back.labels.tobytes() == graph.labels.tobytes()
    assert [list(nodes) for _, nodes in back.paths] == [
        list(nodes) for _, nodes in graph.paths]


def test_bacterial_reads_are_seeded(tmp_path):
    rng = np.random.RandomState(1)
    haps = ["".join(rng.choice(list("ACGT"), size=n)) for n in (900, 1500)]
    paths = [str(tmp_path / f"r{i}.fastq") for i in range(3)]
    for path, seed in zip(paths, (5, 5, 6)):
        bacterial.write_reads(haps, path, 40, seed=seed)
    text = [open(p, "rb").read() for p in paths]
    assert text[0] == text[1] and text[0] != text[2]
    lines = text[0].split(b"\n")
    seqs = lines[1::4][:40]
    assert len(seqs) == 40
    assert all(len(s) == bacterial.READ_LEN and set(s) <= set(b"ACGT")
               for s in seqs)


def test_bacterial_lf_steps_replay_the_search():
    """lf_steps gives one (chars, lo, hi) per column after the ftab's,
    and its final ranges are backward_search_codes'."""
    rng = np.random.RandomState(4)
    s = "".join(rng.choice(list("ACGT"), size=6000))
    fm = FMIndex.build_from_strings([s[::-1]])
    k, p = 10, 4
    arrays = fm_ops.to_device(fm, torch.device("cpu"), dense_occ=True,
                              ftab_bits=p)
    starts = rng.randint(0, len(s) - k, 300)
    present = [[" ACGT".index(ch) for ch in s[i:i + k]] for i in starts]
    codes = torch.from_numpy(np.concatenate(
        [present, rng.randint(1, 5, (200, k))]).astype(np.int32))
    steps, (lo, hi) = bacterial.lf_steps(arrays, codes, p)
    assert len(steps) == k - p
    for j, (c, _, _) in enumerate(steps):
        assert torch.equal(c, codes[:, p + j])
    want_lo, want_hi = fm_ops.backward_search_codes(arrays, codes)
    assert torch.equal(hi - lo, want_hi - want_lo)
    found = want_hi > want_lo
    assert torch.equal(lo[found], want_lo[found])
    assert int(found.sum()) > 0


@pytest.mark.parametrize("n_used,n2,cap", [(7050, 34, 1 << 18),
                                           (0, 0, 16), (40, 90, 64)])
def test_approx_step_work_counts_live_parents_and_survivors(n_used, n2, cap):
    """traverse_step_approx's bound counts per live parent its 24 bytes
    of state and its 32-byte lo4 / hi4 row, and 24 bytes per survivor
    inside the cap; the whole-cap figure writes every slot of the cap."""
    nbytes, ops, cap_bytes = chip_smoke.approx_step_work(n_used, n2, cap)
    live = min(n_used, cap)
    assert nbytes == (24 + 32) * live + 24 * min(n2, cap)
    assert cap_bytes == (16 + 32) * live + 24 * cap
    assert ops == 40 * live
    assert nbytes <= cap_bytes + 8 * live


def test_approx_step_inputs_make_the_mm1_shape(tmp_path, monkeypatch):
    """[approx-step]'s inputs at a small reference: a finder with one
    substitution a seed, its loci, and a 2,000-read chunk's seeds index
    that the approximate traversal runs over on the CPU."""
    from psi_tpu_torch.ops import traverse as trav

    monkeypatch.setattr(chip_smoke, "MM1_REF_LEN", 200_000)
    finder, index = chip_smoke.approx_step_inputs(str(tmp_path), "cpu")
    n = len(finder.starting_loci)
    assert finder.seed_mismatches == 1 and finder.seed_len == 20
    assert n > 0 and index.size == chip_smoke.MM1_CHUNK * 100 // 20
    cap = 1 << (4 * n - 1).bit_length()
    sn, so = finder._get_loci_device(cap)
    out = trav.traverse_device_approx(
        finder._get_graph_arrays(), trav.seeds_to_device(index, "cpu"),
        sn, so, n, finder.seed_len, cap, 1)
    assert out[0].shape == (cap,) and int(out[3]) >= 0
