"""psi_tpu_torch: it imports and runs with neither jax nor psi_tpu, the
device rule and the card default, the kernel and host-library builds,
and wrapper dispatch by device."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from psi_tpu_torch import _build, native
from psi_tpu_torch.device import resolve
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import dindex_probe, fm_fused, fm_pallas, fm_stream
from psi_tpu_torch.ops import fm_trie
from psi_tpu_torch.ops import traverse as trav
from psi_tpu_torch.seed_finder import SeedFinder
from psi_tpu_torch.simulate import make_pangenome_graph

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "psi_tpu_torch"


def test_package_never_imports_jax():
    """No module of the port, nor chip_smoke.py, imports jax or psi_tpu
    (the reference): the port keeps its own copies. No module of the
    package imports chip_smoke.py either: what chip_smoke.py shares with
    the package's tools lives in psi_tpu_torch/tools."""
    for path in [*sorted(PKG.rglob("*.py")), REPO / "chip_smoke.py"]:
        in_pkg = path.parent != REPO
        banned = ("jax", "psi_tpu") + (("chip_smoke",) if in_pkg else ())
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                # nor does a module of the package edit sys.path
                assert not (in_pkg and isinstance(node, ast.Attribute)
                            and ast.unparse(node) == "sys.path"), path
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"


_JAX_BLOCKED_RUN = textwrap.dedent("""
    import os
    import sys
    sys.modules["jax"] = None        # any `import jax` now raises
    sys.modules["psi_tpu"] = None    # and any import of the reference
    import numpy as np
    import psi_tpu_torch
    import psi_tpu_torch.cli
    from psi_tpu_torch.graphiter import HaplotyperRandomIter
    from psi_tpu_torch.pathutil import Path, sequence
    from psi_tpu_torch.records import Records
    from psi_tpu_torch.simulate import make_pangenome_graph
    from psi_tpu_torch.seed_finder import SeedFinder

    g = make_pangenome_graph(4000, 0.03, seed=4)
    itr = HaplotyperRandomIter(g, seed=9)
    hap = Path(g)
    while not itr.at_end():
        hap.push_back(itr.value)
        itr.next()
    hs = sequence(hap)
    rng = np.random.RandomState(2)
    starts = rng.randint(0, len(hs) - 60, 120)
    reads = Records([f"r{i}" for i in range(120)],
                    [hs[p:p + 60] for p in starts])
    finder = SeedFinder(g, 12, device="cpu")
    finder.create_path_index(1, patched=False)
    seeds = finder.get_seeds(reads)
    index = finder.index_reads(seeds)
    finder.prepare_onpath(index)
    on, off = finder.seeds_all_arrays(seeds, index, split=True)
    assert len(on) > 0 and len(off) > 0, (len(on), len(off))
    mesh_finder = SeedFinder(g, 12, device="cpu", devices=2)  # the mesh
    mesh_finder.create_path_index(1, patched=False)
    assert mesh_finder._get_mesh().shape == {"data": 2}
    mseeds = mesh_finder.get_seeds(reads)
    mindex = mesh_finder.index_reads(mseeds)
    mesh_finder.prepare_onpath(mindex)
    m_on, m_off = mesh_finder.seeds_all_arrays(mseeds, mindex, split=True)
    assert (len(m_on), len(m_off)) == (len(on), len(off))
    import psi_tpu_torch.graft
    import psi_tpu_torch.parallel.distributed
    import psi_tpu_torch.tools.multihost_worker
    os.environ["PSI_TRAV_CACHE"] = "0"       # the device traversal
    from psi_tpu_torch.ops import traverse as trav
    steps = []
    step = trav.traverse_step
    trav.traverse_step = lambda *a: steps.append(a[2]) or step(*a)
    dev_on, dev_off = finder.seeds_all_arrays(seeds, index, split=True)
    trav.traverse_step = step
    assert len(dev_off) == len(off), (len(dev_off), len(off))
    assert steps == list(range(12)), steps   # one traverse_step a depth
    host = []
    finder.seeds_off_paths(seeds, index, host.append, device=False)
    assert len(host) == len(off), (len(host), len(off))
    mems = finder.find_mems_arrays(reads)    # the MEM API
    assert len(mems) > 0
    finder.seed_mismatches = 1               # the mismatch routes
    mm_index = finder.index_reads(seeds)     # planned by the query
    mm_on, mm_off = finder.seeds_all_arrays(seeds, mm_index, split=True)
    assert len(mm_on) > len(on) and len(mm_off) > len(off)
    finder.create_distance_index(100, 300)   # the distance index
    os.environ["PSI_DINDEX_BUILD"] = "device"
    from psi_tpu_torch.dindex import DistanceIndex
    dev_idx = DistanceIndex.build(g, 100, 300, device="cpu")
    assert (dev_idx.dst == finder.dindex.dst).all() and len(dev_idx.dst)
    v = rng.randint(1, g.node_count + 1, 500)
    u = rng.randint(1, g.node_count + 1, 500)
    o = np.zeros(500, dtype=np.int64)
    ok = dev_idx.verify_batch_device(g, v, o, u, o, device="cpu")
    assert (ok == finder.dindex.verify_batch(g, v, o, u, o)).all()
    from psi_tpu_torch.tools import alice, dindexctl, pairs
    loaded = [m for m, v in sys.modules.items()
              if v is not None and m.split(".")[0] in ("jax", "psi_tpu")]
    assert not loaded, loaded
    print("ok", len(on), len(off))
""")


_TOOL_IMPORT = textwrap.dedent("""
    import sys
    for name in ("jax", "psi_tpu", "chip_smoke"):
        sys.modules[name] = None     # any import of these now raises
    import importlib
    mod = importlib.import_module(sys.argv[1])
    missing = [f for f in sys.argv[2:] if not callable(getattr(mod, f))]
    assert not missing, missing
    print("ok")
""")


@pytest.mark.parametrize("module,names", [
    ("psi_tpu_torch.tools.timing",
     ["cuda_ms", "bracketed_ms", "card_line", "r4_sectors", "row_sectors",
      "probe_sectors"]),
    ("psi_tpu_torch.tools.bacterial",
     ["write_gfa", "write_reads", "make_data", "first_chunk_index",
      "lf_steps"]),
    ("psi_tpu_torch.tools.dense", ["make_dense", "offpath_inputs"]),
    ("psi_tpu_torch.tools.pairs",
     ["hap_coords", "sample_pairs", "loci", "write_gaf"]),
    ("psi_tpu_torch.tools.dindexctl", ["main"]),
    ("psi_tpu_torch.tools.pindexctl", ["main"]),
    ("psi_tpu_torch.tools.loci_stats", ["main"]),
    ("psi_tpu_torch.tools.sloci", ["main"]),
    ("psi_tpu_torch.tools.ggsim",
     ["main", "simulate_haplotypes", "reads_dist", "revcomp",
      "impose_error"]),
    ("psi_tpu_torch.native", ["fm_backward_batch"]),
    ("psi_tpu_torch.ops.fm_stream", ["payload_host"]),
    ("psi_tpu_torch.tools.alice", ["main", "cmd_dstats", "cmd_analyse"]),
    ("psi_tpu_torch.ops.dindex_build", ["build_super_device"]),
    ("psi_tpu_torch.ops.dindex_probe",
     ["probe_bisect", "probe_bisect_plain", "probe_sort", "make_tables",
      "directory", "key_buckets", "directory_search"]),
    ("psi_tpu_torch.parallel.mesh",
     ["device_mesh", "replicate", "shard_batch", "sharded_backward_search",
      "make_train_step", "prepare_trie_sharded", "sharded_trie_search",
      "sharded_expand_locate", "sharded_traverse_dispatch",
      "sharded_traverse_collect", "sharded_traverse"]),
    ("psi_tpu_torch.parallel.distributed",
     ["initialize_multihost", "process_count", "process_index",
      "process_allgather", "put_global", "build_sharded_index",
      "sharded_count", "sharded_count_2d", "sharded_locate",
      "partition_paths_by_component"]),
    ("psi_tpu_torch.graft", ["entry", "dryrun_multichip"]),
    ("psi_tpu_torch.tools.multihost_worker", ["main"]),
    ("psi_tpu_torch.tools.chr_scale",
     ["main", "run", "make_graph", "make_finder", "build_index",
      "label_text", "draw_reads", "write_gfa", "write_fastq"]),
    ("psi_tpu_torch.tools.gchar3",
     ["main", "run", "make_graph", "make_finder", "build_index",
      "draw_reads", "check_artifact", "warm_query", "launches"]),
])
def test_tools_import_alone(module, names):
    """The timing helpers, the bacterial and dense cells, the pair
    workload, the tool CLIs (dindexctl, alice, pindexctl,
    loci_stats, sloci, ggsim), the native baseline's binding and payload,
    the distance index's device modules, the multi-device modules
    (parallel/), graft.py, the multi-process worker, the chr-scale run
    and the 3 Gchar run import and have their functions with jax,
    psi_tpu and chip_smoke blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _TOOL_IMPORT, module, *names], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"


def test_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_BLOCKED_RUN], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok ")


def test_device_rule(monkeypatch):
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("cuda")


def test_entry_points_default_to_the_card(monkeypatch):
    """SeedFinder, prepare, count_kmers_device and the blocked occ
    gather run on the card unless told otherwise, so without one they
    raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = make_pangenome_graph(2000, 0.02, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeedFinder(graph, 12)
    keys = np.arange(0, 4 ** 8, 97, dtype=np.uint64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fm_trie.prepare(keys, 8)
    finder = SeedFinder(graph, 12, device="cpu")
    assert finder.device.type == "cpu"
    assert fm_trie.prepare(keys, 8, device="cpu").parents.device.type == "cpu"
    finder.create_path_index(1, patched=False)
    fm = finder.pindex.fm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fm_ops.count_kmers_device(fm, keys, 8)
    counts = fm_ops.count_kmers_device(fm, keys, 8, device="cpu")
    assert counts.shape == keys.shape and counts.sum() > 0
    occ8 = fm_pallas.occ_dense_padded(fm)
    pos = np.arange(0, fm.size, 7, dtype=np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fm_pallas.gather_occ_rows_blocked(occ8, pos)
    np.testing.assert_array_equal(
        fm_pallas.gather_occ_rows_blocked(occ8, pos, device="cpu"), occ8[pos])


def test_chr_scale_runs_on_the_card_by_default(monkeypatch):
    """tools/chr_scale runs on the card unless --device cpu is given:
    without one it raises before it builds the graph."""
    from psi_tpu_torch.tools import chr_scale

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(chr_scale, "make_graph", None)   # never reached
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chr_scale.main(["0.01", "10"])


def test_gchar3_runs_on_the_card_by_default(monkeypatch):
    """tools/gchar3 runs on the card unless --device cpu is given:
    without one it raises before it builds the graph."""
    from psi_tpu_torch.tools import gchar3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gchar3, "make_graph", None)   # never reached
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gchar3.main(["0.001", "--n-reads", "10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gchar3.make_finder(object())


def _isolated_build(monkeypatch, tmp_path, nvcc_script=None):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "NVCC_ROOTS", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if nvcc_script is None:
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        return None
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + nvcc_script)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(nvcc))
    return tmp_path / "calls"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    _isolated_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_failure_raises(monkeypatch, tmp_path):
    _isolated_build(monkeypatch, tmp_path, "echo 'bad kernel' >&2\nexit 2\n")
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed.*bad kernel"):
        _build.build()
    assert not (tmp_path / "build" / "libkernels.so").exists()


def test_build_targets_sm90a_once_per_source_hash(monkeypatch, tmp_path):
    """Every csrc/*.cu (traverse_step.cu, traverse_step_approx.cu,
    dindex_probe.cu and trie_schedule.cu too) is compiled for sm_90a by
    its own nvcc process, then linked once; the same sources do not
    rebuild."""
    # a stand-in nvcc that logs its arguments and writes its -o target
    calls = _isolated_build(monkeypatch, tmp_path, (
        f'echo "$@" >> {tmp_path / "calls"}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'
    ))
    lib = _build.build()
    assert lib == tmp_path / "build" / "libkernels.so" and lib.exists()
    assert _build.build() == lib               # same sources: no rebuild
    lines = calls.read_text().splitlines()
    sources = ("trie_level.cu", "rank4_pair.cu", "compact.cu", "rank4.cu",
               "rank.cu", "occ_gather.cu", "range_refine.cu", "status.cu",
               "traverse_step.cu", "traverse_step_approx.cu",
               "dindex_probe.cu", "trie_schedule.cu")
    # one compile per source, all for sm_90a, then one link
    assert len(lines) == len(sources) + 1
    for line in lines:
        assert "arch=compute_90a,code=sm_90a" in line
    compiled = sorted(line.split()[-1].rsplit("/", 1)[-1]
                      for line in lines[:-1])
    assert compiled == sorted(sources)
    assert "-shared" in lines[-1] and "-c" not in lines[-1].split()


def test_host_library_builds_and_loads(monkeypatch, tmp_path):
    """The native host library is compiled from csrc/host by the first
    C++ compiler on PATH, once per source hash, and binds."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib, cmd = _build.build_host()
    assert lib == tmp_path / "build" / "libpsi_host.so" and lib.exists()
    assert "-O3" in cmd and "-march=native" in cmd and "-std=c++17" in cmd
    mtime = lib.stat().st_mtime_ns
    assert _build.build_host()[0].stat().st_mtime_ns == mtime
    assert native.available(), native.load_error
    monkeypatch.setattr(_build, "CXX_NAMES", ("no-such-c++",))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.build_host()


def test_wrappers_raise_on_devices_without_a_kernel():
    t = torch.zeros(8192, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fm_fused.trie_level(t.reshape(4, -1, 2), t, t, t, t, t, t, t)
    arrays = fm_stream.StreamArrays(t.reshape(16, -1), t.reshape(-1, 8),
                                    t.reshape(4, -1, 2), t, 0, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        fm_stream.rank4_pair_stream(arrays, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        fm_stream.compact_children(t.reshape(4, -1), t.reshape(4, -1), t,
                                   t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        fm_stream.rank4_stream(arrays, t)
    with pytest.raises(ValueError, match="unsupported device"):
        fm_stream.rank_stream(arrays, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        fm_stream.rank_lf_pair(arrays, t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        fm_pallas.gather_occ_rows(t.reshape(-1, 8), t)
    with pytest.raises(ValueError, match="unsupported device"):
        fm_pallas.lf_pair(t.reshape(-1, 8), t, t, t, t)
    seeds = trav.SeedsArrays(t.reshape(2, -1, 4), t[:4096].reshape(2, -1, 2),
                             100)
    with pytest.raises(ValueError, match="unsupported device"):
        trav.range_refine4(seeds, 0, t, t)
    state = trav.TraverseState(t, t, t, t, t, t[0].bool(), t[:3].long())
    graph = trav.GraphArrays(t, t, t, t, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        trav.traverse_step(graph, seeds, 0, state, 1, 8192)
    approx = trav.ApproxState(t, t, t, t, t, t, t[0].bool())
    with pytest.raises(ValueError, match="unsupported device"):
        trav.traverse_step_approx(graph, seeds, 0, approx, 1, 8192)
    tabs = dindex_probe.ProbeTables(t.long(), t, t, t, t)
    with pytest.raises(ValueError, match="unsupported device"):
        dindex_probe.probe_bisect(tabs, t.long(), t, t, t, t)
