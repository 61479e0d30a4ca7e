"""psi_tpu_torch.parallel.distributed against psi_tpu.parallel.distributed
on the CPU (psi_tpu on the conftest mesh of 8 virtual devices, the port
on virtual shards of the CPU): the stacked sharded index, component-
sharded counting with its alive mask (one lf_pair a step per shard),
the 2-D data x shard count, the per-shard locate merge and the
component partition, all exact; the one-process runtime helpers; and
`_build.launch`, which runs every kernel with its tensors' device
current."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from psi_tpu.fmindex import FMIndex as JFMIndex
from psi_tpu.parallel import distributed as jdist
from psi_tpu.parallel.mesh import device_mesh as jdevice_mesh
from psi_tpu.seed_finder import SeedFinder as JSeedFinder
from psi_tpu.graph import Graph as JGraph
from psi_tpu_torch import _build
from psi_tpu_torch.fmindex import FMIndex
from psi_tpu_torch.graph import Graph
from psi_tpu_torch.ops.fm import keys_to_codes
from psi_tpu_torch.ops.kmers import pack_kmers, seq_to_codes
from psi_tpu_torch.parallel import distributed as dist
from psi_tpu_torch.parallel import mesh
from psi_tpu_torch.seed_finder import SeedFinder

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _need_devices():
    if jax.device_count() < 8:
        pytest.skip("needs the virtual 8-device CPU mesh")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tensors, which are small:
    the suite runs several workers on the machine's cores, and idle
    intra-op threads spinning in every worker slow them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shards(seed, n_shards, size=300, n_kmers=40, n_random=10, k=10):
    """Per-shard strings (disjoint "components"), both packages' FM
    indexes of them, and code rows of k-mers drawn from them plus random
    ones."""
    rng = np.random.RandomState(seed)
    groups = [["".join(rng.choice(list("ACGT"), size=size))
               for _ in range(2)] for _ in range(n_shards)]
    fms = [FMIndex.build_from_strings([s[::-1] for s in g]) for g in groups]
    jfms = [JFMIndex.build_from_strings([s[::-1] for s in g])
            for g in groups]
    every = [s for g in groups for s in g]
    kmers = []
    for _ in range(n_kmers):
        s = every[rng.randint(len(every))]
        st = rng.randint(0, len(s) - k + 1)
        kmers.append(s[st: st + k])
    kmers += ["".join(rng.choice(list("ACGT"), size=k))
              for _ in range(n_random)]
    keys, _ = pack_kmers(np.stack([seq_to_codes(x) for x in kmers]))
    fm_all = JFMIndex.build_from_strings([s[::-1] for s in every])
    expect = np.array([fm_all.count(km[::-1]) for km in kmers])
    return fms, jfms, kmers, keys_to_codes(keys, k), expect, fm_all


@pytest.mark.parametrize("S,named", [(4, False), (8, False), (2, True)])
def test_sharded_count_and_locate_match_psi_tpu(S, named):
    """Totals, per-shard lo/hi and the locate merge, against psi_tpu's and
    the global count; `named` places two shards on one device named
    twice."""
    fms, jfms, kmers, codes, expect, fm_all = _shards(S, S)
    m = (mesh.device_mesh(axes=("shard",), devices=["cpu", "cpu"]) if named
         else mesh.device_mesh(S, axes=("shard",), platform="cpu"))
    arrays = dist.build_sharded_index(fms, m)
    jarrays = jdist.build_sharded_index(
        jfms, jdevice_mesh(S, axes=("shard",)))
    for got, want in ((arrays.occ_dense, jarrays.occ_dense),
                      (arrays.C, jarrays.C), (arrays.sa, jarrays.sa)):
        np.testing.assert_array_equal(
            np.stack([t.numpy() for t in got]), np.asarray(want))
    np.testing.assert_array_equal(arrays.sizes, np.asarray(jarrays.sizes))
    total, lo, hi = dist.sharded_count(m, arrays, codes)
    jtotal, jlo, jhi = jdist.sharded_count(
        jarrays.sa.sharding.mesh, jarrays, codes)
    np.testing.assert_array_equal(total, expect)
    np.testing.assert_array_equal(total, jtotal)
    np.testing.assert_array_equal(hi - lo, jhi - jlo)
    np.testing.assert_array_equal(lo[hi > lo], jlo[jhi > jlo])
    got = dist.sharded_locate(arrays, lo, hi, int(total.max()))
    want = jdist.sharded_locate(jarrays, jlo, jhi, int(jtotal.max()))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    shard_idx, query_idx, pos = got
    for qi, km in enumerate(kmers):
        mine = sorted(
            (2 * int(s_i) + int(sid[0]), int(off[0]))
            for s_i, q_i, p in zip(shard_idx, query_idx, pos) if q_i == qi
            for sid, off in [fms[s_i].text_pos_to_string([p])])
        assert mine == fm_all.occurrences(km[::-1]), km


def test_sharded_count_2d_matches_psi_tpu():
    """Queries over 'data' (37 rows, padded to the axis), the index over
    'shard', one device per tile; summed over shard only."""
    fms, jfms, _, codes, expect, _ = _shards(0, 4, n_kmers=37, n_random=0)
    m2 = mesh.device_mesh(8, axes=("data", "shard"), platform="cpu",
                          shape=(2, 4))
    total = dist.sharded_count_2d(
        m2, dist.build_sharded_index(fms, m2, axis="shard"), codes)
    jm2 = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "shard"))
    jtotal = jdist.sharded_count_2d(
        jm2, jdist.build_sharded_index(jfms, jm2, axis="shard"), codes)
    np.testing.assert_array_equal(total, expect)
    np.testing.assert_array_equal(total, jtotal)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_partition_paths_by_component_matches_psi_tpu(n_shards):
    """Three components of unequal length, two paths picked in each:
    psi_tpu's shards and components, every component on one shard."""
    rng = np.random.RandomState(12)
    nodes, edges, paths = {}, [], []
    nid = 0
    for c, length in enumerate((900, 400, 650)):
        seq = "".join(rng.choice(list("ACGT"), size=length))
        a, b, alt, d = nid + 1, nid + 2, nid + 3, nid + 4
        nodes.update({a: seq[: length // 2], b: seq[length // 2:],
                      alt: "ACGTTGCA", d: seq[:40]})
        edges += [(a, b), (a, alt), (alt, b), (b, d)]
        paths.append((f"ref{c}", [a, b, d]))
        nid += 4
    parts = dict(nodes=nodes, edges=edges, paths=paths)

    def partition(finder_cls, graph_cls, module):
        g = graph_cls.from_parts(**parts)
        kw = {"device": "cpu"} if finder_cls is SeedFinder else {}
        f = finder_cls(g, 12, **kw)
        f.pick_paths(2, patched=False)
        f.index_paths()
        return module.partition_paths_by_component(g, f.pindex, n_shards)

    per_shard, comp = partition(SeedFinder, Graph, dist)
    assert (per_shard, comp) == partition(JSeedFinder, JGraph, jdist)
    assert sorted(i for s in per_shard for i in s) == list(range(len(comp)))
    owners = {}
    for s, idxs in enumerate(per_shard):
        for i in idxs:
            owners.setdefault(comp[i], set()).add(s)
    assert len(owners) == 3 and all(len(v) == 1 for v in owners.values())


def test_runtime_helpers_one_process():
    """Without a process group: one process of rank 0, the gather and the
    sum are the identity, and initialize_multihost without an address
    does nothing; put_global places one copy per distinct device or
    each position's block."""
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    np.testing.assert_array_equal(dist.process_allgather(x), x)
    np.testing.assert_array_equal(dist.process_sum(x), x)
    assert dist.initialize_multihost() is None
    dist.barrier()
    m = mesh.device_mesh(3, platform="cpu")
    rep = dist.put_global(x, m)
    assert rep[0] is rep[1] is rep[2]
    blocks = dist.put_global(x, m, "data")
    for p in range(3):
        np.testing.assert_array_equal(blocks[p].numpy(), x[p: p + 1])
    with pytest.raises(ValueError, match="blocks"):
        dist.put_global(x, mesh.device_mesh(2, platform="cpu"), "data")


def test_launch_enters_the_device(monkeypatch):
    """_build.launch makes the launch's device current around the C call
    (so a kernel on cuda:1 runs there, whichever device was current),
    and every kernel wrapper passes its tensors' device."""
    events = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    def call(name, argtypes, restype, *args):
        events.append(("call", name, args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(_build, "call", call)
    dev = torch.device("cuda", 1)
    _build.launch("psi_trie_level", [], dev, 7, 8)
    assert events == [("enter", dev), ("call", "psi_trie_level", (7, 8)),
                      ("exit", dev)]
    # every launch site passes `dev`, the device of the wrapper's tensors
    sites = 0
    for path in sorted((REPO / "psi_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and ast.unparse(node.func) == "_build.launch"):
                    sites += 1
                    assert ast.unparse(node.args[2]) == "dev", path
                    src = ast.unparse(fn)
                    assert "dev = " in src and ".device" in src, fn.name
    assert sites == 13
