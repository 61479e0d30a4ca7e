"""SeedFinder on PyTorch (counterpart of psi_tpu/seed_finder.py).

The host lifecycle is psi_tpu's, copied: path picking and indexing,
uncovered loci and their persistence, seeding and the reads-side index,
the seed join and emission. The device routes are this package's:

  * on-path, the chain, the one route: the chunk's plan (`OnpathPlan`:
    distinct seed k-mers, under --mismatches their Hamming ball, and the
    trie schedule, on the card csrc/trie_schedule.cu), built once a chunk
    by `prepare_onpath` on the producer thread -> ftab-seeded frontier ->
    level kernels -> counts download -> expand + locate on the device at
    the exact total -> gpos download -> the join into hit rows (native
    psi_emit_join when the host library is loaded, else NumPy);
  * off-path, psi_tpu's routes chosen as psi_tpu chooses them: the
    WalkTree (built once per loci set, probed per chunk on the finder's
    device) when there are no mismatches, PSI_TRAV_CACHE is on and the
    tree fits PSI_TRAV_CACHE_CAP, and otherwise the per-chunk frontier
    traversal on the device (`traverse_device`, csrc/traverse_step.cu, or
    with --mismatches `traverse_device_approx` and range_refine4,
    csrc/range_refine.cu), dispatched before the on-path route and
    collected after it;
    `seeds_off_paths(device=False)` runs the host BFS mirror;
  * the MEM library API (`find_mems_arrays`, `seeds_on_paths_seqs`): the
    lockstep MEM automaton on the device over the rank layout
    (`_get_fm_arrays`; csrc/occ_gather.cu's occ_lf_pair on the dense occ
    table), locate on the host;
  * the distance index (`create_distance_index`, `verify_distance`, its
    artifact saved and loaded with the path index): psi_tpu's lifecycle
    over this package's dindex.py, built on the finder's device under
    PSI_DINDEX_BUILD=device;
  * on a device mesh (`devices`, PSI_DEVICES; parallel/mesh.py), the
    on-path trie and chain sharded over the distinct keys and the
    off-path traversal sharded over the loci, each shard on its device
    with the single-device kernels; on a multi-process mesh each process
    emits its own shards' hits (PSI_MH_EMIT=shard, the default) or the
    whole stream (full).

The card unless `device` names the CPU; `devices` picks how many devices
of that type the query pipeline spans (one, the default on the CPU and
with one card, takes the single-device routes).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from psi_tpu_torch.device import resolve
from psi_tpu_torch.dindex import DistanceIndex
from psi_tpu_torch.fmindex import SIGMA
from psi_tpu_torch.graph import Graph, Position
from psi_tpu_torch.graphiter import BacktrackerIter, BFSIter, HaplotyperIter
from psi_tpu_torch.graphiter import extend_to_k
from psi_tpu_torch.ops import fm as fm_ops
from psi_tpu_torch.ops import fm_stream, fm_trie
from psi_tpu_torch.ops import traverse as trav
from psi_tpu_torch.pathset import PathIndex, get_uniq_haplotype
from psi_tpu_torch.pathutil import Path, trim_back
from psi_tpu_torch.records import Records, SeedSet, SeedsIndex, seeding
from psi_tpu_torch.seed import SEED_DTYPE, Seed
from psi_tpu_torch import stats as run_stats
from psi_tpu_torch.stats import NoStats, ProgressEnum, SeedFinderStats


class OnpathPlan(NamedTuple):
    """A chunk's on-path plan (`SeedFinder._plan_onpath`), built once a
    chunk: by `prepare_onpath` on the producer thread, or by the query."""

    uniq_start: np.ndarray  # [U] first sorted seed of each distinct k-mer
    uniq_end: np.ndarray    # [U] one past its last
    origin: np.ndarray      # int64 [S] distinct k-mer of each search key
    uniq: np.ndarray        # uint64 [N] the distinct search keys, sorted
    inv: np.ndarray         # [S] each search key's row of uniq
    #: fm_trie.PreparedTrie, or parallel.mesh.ShardedPreparedTrie on a mesh
    trie: object


class SeedFinder:
    """(ref: seed_finder.hpp:930-942 ctor; query methods are const /
    side-effect-free so chunks can be processed concurrently)."""

    def __init__(
        self,
        graph: Graph,
        seed_len: int,
        gocc_threshold: int = 0,
        max_mem: int = 0,
        seed_mismatches: int = 0,
        stats: Optional[SeedFinderStats] = None,
        rng_seed: int = 0,
        devices: Optional[object] = None,
        device: torch.device | str | None = None,
    ):
        #: the query device: the card unless the caller names the CPU
        self.device = resolve("cuda") if device is None else torch.device(device)
        self.graph = graph
        self.seed_len = seed_len
        self.gocc_threshold = gocc_threshold
        self.max_mem = max_mem
        self.seed_mismatches = seed_mismatches
        self.stats = stats if stats is not None else NoStats()
        self.pindex = PathIndex(graph)
        self.starting_loci: List[Position] = []
        self.dindex = DistanceIndex(0, 0)
        self.d = (0, 0)
        self._rng_seed = rng_seed
        #: device-mesh request: None = env PSI_DEVICES (default: every
        #: visible card on cuda, one device on the CPU); "auto" = every
        #: device of the finder's type; int N = the first N; a sequence
        #: of devices of the finder's type (it may name a card twice)
        self._devices_req = devices
        self._mesh = None
        self._mesh_repl = {}
        # device-side caches (built lazily)
        self._sa = None          # the dense SA, all the chain reads
        self._fm_arrays = None   # rank layout (MEM API)
        self._path_map = None
        self._map_arrays = None
        self._stream_arrays = None
        self._ftab_np = None
        self._graph_arrays = None
        # (fingerprint, WalkTree | False, DeviceWalkTree | None)
        self._trav_tree = None
        self._loci_np = None    # (n, (node ids, offsets), {cap: on device})
        #: the last single-device traversal's final cap and its attempts
        #: (the cap doubles on overflow)
        self.last_traversal = None
        self._prep_lock = threading.Lock()

    # === device mesh (multi-device scale-out, SURVEY §2.3) ==================
    def _get_mesh(self):
        """Lazy 1-D "data" mesh of devices of the finder's type. The query
        pipeline (on-path trie search and chain, off-path traversal)
        shards over it whenever it spans > 1 device — the reference's
        single-process chunk loop (ref: src/psikt.cpp:183-209) scaled
        out. Selection: the `devices` ctor arg, else PSI_DEVICES ("auto"
        or a count), else every card on cuda / one device on the CPU
        (virtual CPU meshes are opt-in); capped at the devices there are
        (over every process)."""
        if self._mesh is False:
            return None
        if self._mesh is None:
            from psi_tpu_torch.parallel import mesh as mesh_mod

            req = self._devices_req
            if req is None:
                req = os.environ.get("PSI_DEVICES")
            platform = self.device.type
            if isinstance(req, (list, tuple)):
                devs = [torch.device(d) for d in req]
                kinds = {d.type for d in devs}
                if kinds != {platform}:
                    raise ValueError(
                        f"devices {[str(d) for d in devs]}: a mesh holds "
                        f"devices of the finder's type ({platform}) only")
                mesh = mesh_mod.device_mesh(devices=devs)
            else:
                # None: every device there is (counted over every process)
                if req is None:
                    n = None if platform == "cuda" else 1
                else:
                    n = None if str(req) == "auto" else int(req)
                mesh = None
                if n is None or n > 1:
                    total = mesh_mod.device_count(platform)
                    n = total if n is None else min(n, total)
                    if n > 1:
                        mesh = mesh_mod.device_mesh(n, platform=platform)
            if mesh is None or mesh.size <= 1:
                self._mesh = False
                return None
            self._mesh = mesh
        return self._mesh

    def _get_mesh_repl(self, mesh, name: str, build):
        """Per-mesh cache of replicated device arrays (index arrays are
        placed once per distinct device, not per chunk)."""
        key = (id(mesh), name)
        if key not in self._mesh_repl:
            from psi_tpu_torch.parallel.mesh import replicate

            self._mesh_repl[key] = replicate(mesh, build())
        return self._mesh_repl[key]

    @staticmethod
    def _mh_emit_sharded() -> bool:
        """Process-sharded emission (multi-process mesh only): each
        process fetches/joins/emits only its own shards' hits; merging is
        concatenation of disjoint streams. On by default; PSI_MH_EMIT=full
        makes every process compute the full stream."""
        from psi_tpu_torch.parallel.distributed import process_count

        if process_count() <= 1:
            return False
        return os.environ.get("PSI_MH_EMIT", "shard") != "full"

    # === path picking =======================================================
    def _set_context(self, context: int, patched: bool) -> int:
        """(ref: seed_finder.hpp:1772-1787)"""
        if not patched:
            context = 0
        if patched and context == 0:
            context = self.seed_len
        self.pindex.set_context(context)
        return context

    def pick_paths(
        self,
        n: int,
        patched: bool = True,
        context: int = 0,
        progress: Optional[Callable[[str, int], None]] = None,
    ):
        """Pick n paths per region / reference path
        (ref: seed_finder.hpp:1138-1167)."""
        if n == 0:
            return
        if self.graph.get_path_count() == 0:
            raise RuntimeError("no reference path found in the input graph")
        self.stats.set_progress(ProgressEnum.SELECT_PATHS)
        with self.stats.timeit_ts("pick-paths"):
            context = self._set_context(context, patched)
            from psi_tpu_torch import native

            if native.available() and not os.environ.get("PSI_PY_PICK"):
                region_starts = np.array(
                    [int(nodes[0]) for _, (name, nodes) in
                     self.graph.for_each_path()],
                    dtype=np.int64,
                )
                res = native.pick_paths(
                    np.diff(self.graph.label_offsets),
                    self.graph.out_indptr,
                    self.graph.out_indices,
                    region_starts,
                    n, context, patched,
                    np.random.RandomState(self._rng_seed),
                )
                if res is not None:
                    indptr, nodes_flat, lefts, rights = res
                    for i in range(len(lefts)):
                        self.pindex.push_back(
                            Path(
                                self.graph,
                                nodes_flat[indptr[i]: indptr[i + 1]].tolist(),
                                int(lefts[i]),
                                int(rights[i]),
                            )
                        )
                    return
            hp = HaplotyperIter(
                self.graph, rng=np.random.RandomState(self._rng_seed)
            )
            for path_rank, (name, nodes) in self.graph.for_each_path():
                start = int(nodes[0])
                hp.reset(start)
                for i in range(n):
                    if progress:
                        progress(name, i + 1)
                    get_uniq_haplotype(self.pindex, hp, context, patched)

    def _reset_index_caches(self):
        self._build_path_map()
        self._sa = None
        self._fm_arrays = None
        self._map_arrays = None
        self._stream_arrays = None
        self._ftab_np = None
        self._mesh_repl = {}

    def index_paths(self):
        """(ref: seed_finder.hpp:1169-1176)"""
        self.stats.set_progress(ProgressEnum.CREATE_PINDEX)
        with self.stats.timeit_ts("index-paths"):
            self.pindex.create_index()
            self._reset_index_caches()

    def _build_path_map(self):
        """Flat arrays mapping a global forward path position to
        (node_id, node_offset): the batched equivalent of
        Path::rank/select (ref: pathindex.hpp:360-416)."""
        pset = self.pindex.get_paths_set()
        lengths = np.array([p.get_sequence_len() for p in pset], dtype=np.int64)
        seq_off = np.zeros(len(pset) + 1, dtype=np.int64)
        np.cumsum(lengths, out=seq_off[1:])
        starts_l, ids_l, base_l = [], [], []
        for pidx, path in enumerate(pset):
            node_starts = path._node_starts()[:-1] + seq_off[pidx]
            starts_l.append(node_starts)
            ids_l.append(np.asarray(path.get_nodes(), dtype=np.int64))
            base = np.zeros(len(path.get_nodes()), dtype=np.int64)
            if len(base):
                base[0] = path.get_head_offset()
            base_l.append(base)
        self._path_map = {
            "lengths": lengths,
            "seq_off": seq_off,
            "starts": np.concatenate(starts_l) if starts_l else np.zeros(0, np.int64),
            "ids": np.concatenate(ids_l) if ids_l else np.zeros(0, np.int64),
            "base": np.concatenate(base_l) if base_l else np.zeros(0, np.int64),
        }

    # === uncovered loci =====================================================
    def add_start(self, node_id: int, offset: int = None):
        if offset is None:
            self.starting_loci.append(node_id)  # Position instance
        else:
            self.starting_loci.append(Position(node_id, offset))
        self.stats.total_loci = len(self.starting_loci)

    def get_starting_loci(self) -> List[Position]:
        return self.starting_loci

    def set_starting_loci(self, loci):
        self.starting_loci = list(loci)

    def add_uncovered_loci(self, step: int = 1):
        """Detect loci whose k-context is not fully covered by the path set
        (exact mirror of ref: seed_finder.hpp:1481-1541). Uses the native
        OpenMP scanner (csrc/host/psi_uncovered.cpp) when available."""
        pathset = self.pindex.get_paths_set()
        if len(pathset) == 0:
            self.add_all_loci(step)
            return
        self.stats.set_progress(ProgressEnum.FIND_UNCOVERED)

        from psi_tpu_torch import native

        if native.available():
            with self.stats.timeit_ts("find-uncovered"):
                paths_nodes = []
                paths_indptr = [0]
                for p in pathset:
                    paths_nodes.extend(p.get_nodes())
                    paths_indptr.append(len(paths_nodes))
                res = native.uncovered_loci(
                    np.diff(self.graph.label_offsets),
                    self.graph.out_indptr,
                    self.graph.out_indices,
                    np.asarray(paths_nodes, dtype=np.int64),
                    np.asarray(paths_indptr, dtype=np.int64),
                    self.seed_len,
                    step,
                )
                if res is not None:
                    node_ids, offsets = res
                    for nid, off in zip(node_ids, offsets):
                        self.add_start(int(nid), int(off))
                    return
        self._add_uncovered_loci_py(step)

    def _add_uncovered_loci_py(self, step: int = 1):
        pathset = self.pindex.get_paths_set()
        with self.stats.timeit_ts("find-uncovered"):
            g = self.graph
            k = self.seed_len
            bt = BacktrackerIter(g)
            trav_path = Path(g)
            bv_starts = np.zeros(g.max_node_len(), dtype=bool)

            for rank in range(1, g.node_count + 1):
                nid = g.rank_to_id(rank)
                label_len = g.node_length(nid)
                offset = label_len

                bt.reset(nid)
                while not bt.at_end() and offset != 0:
                    extend_to_k(trav_path, bt, offset - 1 + k)
                    current_path = None
                    if trav_path.get_sequence_len() >= k:
                        current_path = Path(
                            g, list(trav_path.get_nodes()),
                            trav_path.left, trav_path.right,
                        )
                    while (
                        current_path is not None
                        and current_path.get_sequence_len() != 0
                        and not pathset.covered_by(current_path.get_nodes())
                    ):
                        trimmed_len = current_path.get_sequence_len() - g.node_length(
                            current_path.get_nodes()[-1]
                        )
                        if trimmed_len <= k - 1:
                            offset = 0
                            break
                        offset = trimmed_len - k + 1
                        trim_back(current_path)
                    f = offset
                    while (
                        f < label_len
                        and f + k < trav_path.get_sequence_len() + 1
                    ):
                        bv_starts[f] = True
                        f += step

                    bt.backtrack()
                    trim_back(trav_path, bt.value if bt.value is not None else 0)

                for f in range(label_len):
                    if bv_starts[f]:
                        bv_starts[f] = False
                        self.add_start(nid, f)

                trav_path.clear()

    def add_all_loci(self, step: int = 1):
        """Step-preserving all-loci fallback via BFS levels
        (ref: seed_finder.hpp:1543-1585)."""
        self.stats.set_progress(ProgressEnum.FIND_UNCOVERED)
        with self.stats.timeit_ts("find-uncovered"):
            bfs = BFSIter(self.graph)
            prenode_remain = 0
            remain_estimate = 0
            prenode_level = 0
            while not bfs.at_end():
                if prenode_level != bfs.level():
                    prenode_remain = remain_estimate
                    remain_estimate = 0
                    prenode_level = bfs.level()
                seq_len = self.graph.node_length(bfs.value)
                cursor = (step - prenode_remain) % step
                while cursor < seq_len:
                    self.add_start(bfs.value, cursor)
                    cursor += step
                if step - prenode_remain > seq_len:
                    new_remain = prenode_remain + seq_len
                else:
                    new_remain = (seq_len - step + prenode_remain) % step
                if remain_estimate < new_remain:
                    remain_estimate = new_remain
                bfs.next()

    def get_nof_uniq_nodes(self) -> int:
        return len({l.node_id() for l in self.starting_loci})

    def nof_uncovered_kmers(self) -> int:
        """Audit: count k-mer loci not covered by the path set, over the
        nodes that carry starting loci (exact mirror of
        ref: seed_finder.hpp:1587-1635). On the host; no device work."""
        if not self.starting_loci:
            return 0
        with self.stats.timeit_ts("count-uncovered-kmer"):
            g = self.graph
            k = self.seed_len
            pathset = self.pindex.get_paths_set()
            bt = BacktrackerIter(g)
            trav_path = Path(g)
            uncovered = 0
            prev_id = 0
            for locus in self.starting_loci:
                if prev_id == locus.node_id():
                    continue
                prev_id = locus.node_id()
                label_len = g.node_length(locus.node_id())
                bt.reset(locus.node_id())
                while not bt.at_end():
                    offset = label_len
                    extend_to_k(trav_path, bt, offset - 1 + k)
                    current_path = None
                    if trav_path.get_sequence_len() >= k:
                        current_path = Path(
                            g, list(trav_path.get_nodes()),
                            trav_path.left, trav_path.right,
                        )
                    while (
                        current_path is not None
                        and current_path.get_sequence_len() != 0
                        and not pathset.covered_by(current_path.get_nodes())
                    ):
                        trimmed_len = (
                            current_path.get_sequence_len()
                            - g.node_length(current_path.get_nodes()[-1])
                        )
                        if trimmed_len <= k - 1:
                            offset = 0
                            break
                        offset = trimmed_len - k + 1
                        trim_back(current_path)
                    uncovered += label_len - offset
                    ub = trav_path.get_sequence_len() + 1 - k
                    if offset < ub < label_len:
                        uncovered -= ub - offset
                    bt.backtrack()
                    trim_back(
                        trav_path, bt.value if bt.value is not None else 0
                    )
                trav_path.clear()
            return uncovered

    # === distance index =====================================================
    def create_distance_index(
        self, dmin: int, dmax: int, per_component: bool = True
    ):
        """(ref: seed_finder.hpp:1193-1265). PSI_DINDEX_BUILD=device
        builds on the finder's device."""
        if dmin == 0 or (dmax != 0 and dmax < dmin):
            return
        if dmax == 0:
            dmax = dmin
        self.stats.set_progress(ProgressEnum.CREATE_DINDEX)
        with self.stats.timeit_ts("index-distances"):
            self.dindex = DistanceIndex.build(
                self.graph, dmin, dmax, per_component, device=self.device
            )
            self.d = (dmin, dmax)

    def verify_distance(self, v: int, o: int, u: int, p: int) -> bool:
        with self.stats.timeit_ts("query-dindex"):
            return self.dindex.verify(self.graph, v, o, u, p)

    def save_distance_index(self, prefix: str) -> bool:
        if self.dindex.empty and self.d == (0, 0):
            return True
        with self.stats.timeit_ts("save-dindex"):
            self.dindex.save(self.get_dindex_path(prefix, *self.d))
        return True

    def open_distance_index(self, prefix: str, dmin: int = 0, dmax: int = 0) -> bool:
        if dmax == 0:
            dmax = dmin
        self.d = (dmin, dmax)
        path = self.get_dindex_path(prefix, dmin, dmax)
        if not os.path.exists(path):
            return False
        with self.stats.timeit_ts("load-dindex"):
            self.dindex = DistanceIndex.load(path)
        return True

    # === artifact paths (naming parity, ref: seed_finder.hpp:877-892) ======
    @staticmethod
    def get_dindex_path(prefix: str, dmin: int, dmax: int) -> str:
        return f"{prefix}_dist_mat_m{dmin}M{dmax}.npz"

    @staticmethod
    def get_sloci_filepath(prefix: str, seed_len: int, step: int) -> str:
        return f"{prefix}_loci_e{step}l{seed_len}"

    # === starting loci persistence ==========================================
    def save_starts(self, prefix: str, seed_len: int, step: int) -> bool:
        """Store in *external* (coordinate) ids
        (ref: seed_finder.hpp:1659-1679)."""
        path = self.get_sloci_filepath(prefix, seed_len, step)
        self.stats.set_progress(ProgressEnum.WRITE_STARTS)

        def coord(nid):  # identity for ids outside the graph (mirrors gum)
            return self.graph.coordinate_id(nid) if self.graph.has_node(nid) else nid

        with self.stats.timeit_ts("save-starts"):
            arr = np.array(
                [(coord(l.node_id()), l.offset()) for l in self.starting_loci],
                dtype=np.int64,
            ).reshape(-1, 2)
            np.save(path + ".npy", arr)
        return True

    def open_starts(self, prefix: str, seed_len: int, step: int) -> bool:
        path = self.get_sloci_filepath(prefix, seed_len, step) + ".npy"
        if not os.path.exists(path):
            return False
        self.stats.set_progress(ProgressEnum.LOAD_STARTS)

        def internal(cid):
            try:
                return self.graph.id_by_coordinate(cid)
            except KeyError:
                return cid

        with self.stats.timeit_ts("load-starts"):
            arr = np.load(path)
            self.starting_loci = [
                Position(internal(int(c)), int(o)) for c, o in arr
            ]
        return True

    # === full index lifecycle ==============================================
    def create_path_index(
        self,
        n: int,
        patched: bool = True,
        context: int = 0,
        step_size: int = 1,
        dmin: int = 0,
        dmax: int = 0,
        per_component: bool = True,
    ):
        """(ref: seed_finder.hpp:1330-1355)"""
        self.pick_paths(n, patched, context)
        self.index_paths()
        self.add_uncovered_loci(step_size)
        self.create_distance_index(dmin, dmax, per_component)

    def serialize_path_index(self, prefix: str, step_size: int = 1) -> bool:
        if not prefix:
            return False
        self.stats.set_progress(ProgressEnum.WRITE_PINDEX)
        with self.stats.timeit_ts("save-pindex"):
            self.pindex.save(prefix)
        return (
            self.save_starts(prefix, self.seed_len, step_size)
            and self.save_distance_index(prefix)
        )

    def load_path_index(
        self,
        prefix: str,
        context: int = 0,
        step_size: int = 1,
        dmin: int = 0,
        dmax: int = 0,
    ) -> bool:
        """Transparently rebuilds missing starts/dindex artifacts
        (ref: seed_finder.hpp:1396-1413)."""
        if not prefix:
            return False
        self.stats.set_progress(ProgressEnum.LOAD_PINDEX)
        with self.stats.timeit_ts("load-pindex"):
            self.pindex.set_context(context)
            if not self.pindex.load(prefix):
                return False
            self._reset_index_caches()
        if not self.open_starts(prefix, self.seed_len, step_size):
            self.add_uncovered_loci(step_size)
            self.save_starts(prefix, self.seed_len, step_size)
        if not self.open_distance_index(prefix, dmin, dmax):
            self.create_distance_index(dmin, dmax, True)
            self.save_distance_index(prefix)
        return True

    # === per-chunk query machinery ==========================================
    def get_seeds(self, reads: Records, distance: int = 0) -> SeedSet:
        """(ref: seed_finder.hpp:1099-1109; distance==0 -> non-overlapping)"""
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.SEED_CHUNK)
        with self.stats.timeit_ts("seeding", reads.rec_offset):
            if distance == 0:
                distance = self.seed_len
            return seeding(reads, self.seed_len, distance)

    def index_reads(self, seeds: SeedSet) -> SeedsIndex:
        """(ref: seed_finder.hpp:1089-1097)"""
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.INDEX_CHUNK)
        with self.stats.timeit_ts("index-reads", seeds.rec_offset):
            return SeedsIndex(seeds)

    #: dense per-position occ table budget (bytes); texts whose dense
    #: table fits use the gather-only rank
    DENSE_OCC_BUDGET = int(os.environ.get("PSI_DENSE_OCC_BUDGET", 2 << 30))
    #: largest prefix-table depth (4**p SA-range rows; 11 -> 32 MB)
    FTAB_MAX_BITS = int(os.environ.get("PSI_FTAB_MAX_BITS", 11))

    def _ftab_bits(self) -> int:
        """Prefix-table depth: one ftab gather replaces the first p LF
        steps of every k-mer query. Sized so the table never dwarfs the
        text (p <= log4 n) and never exceeds the seed length."""
        env = os.environ.get("PSI_FTAB_BITS")
        if env is not None:
            # clamp: depths beyond the seed length are never consulted,
            # and 4**p rows past ~13 would swamp host memory
            return max(min(int(env), self.seed_len, 13), 0)
        n = self.pindex.fm.size
        log4 = max((int(n).bit_length() - 1) // 2, 0)
        return max(min(self.FTAB_MAX_BITS, self.seed_len, log4), 0)

    # --- device state caches ---------------------------------------------
    def _get_sa(self):
        """The dense SA on the device: all the chain route reads."""
        if self._sa is None and self.pindex.fm is not None:
            self._sa = fm_ops.sa_to_device(self.pindex.fm, self.device)
        return self._sa

    def _get_fm_arrays(self):
        """The rank layout, built at the first MEM call (the chain never
        pays for it) around the cached SA.

        psi_tpu picks the layout by platform: dense on its CPU backend,
        bit-planes on the TPU, where XLA serializes gathers from a big
        table. On the H100 a dense rank is one 4-byte load from HBM
        (csrc/occ_gather.cu), and a 10 Mbp table is 160 MB of 80 GB,
        so both devices take the dense layout within DENSE_OCC_BUDGET and
        the bit planes beyond it."""
        fm = self.pindex.fm
        if self._fm_arrays is None and fm is not None:
            dense = fm.size * 16 <= self.DENSE_OCC_BUDGET
            arrays = fm_ops.to_device(fm, self.device, dense_occ=dense,
                                      bitplanes=not dense, sa=self._get_sa())
            ftab = self._get_ftab()
            if ftab is not None and fm.size and fm.sigma == SIGMA:
                arrays = arrays._replace(
                    ftab=torch.from_numpy(ftab).to(self.device))
            self._fm_arrays = arrays
        return self._fm_arrays

    def _get_stream_arrays(self):
        if self._stream_arrays is None:
            self._stream_arrays = fm_stream.build_stream_arrays(
                self.pindex.fm, self.device
            )
        return self._stream_arrays

    def _get_ftab(self):
        """Lazy prefix table; thread-safe (the producer thread calls it)."""
        if self._ftab_np is None:
            with self._prep_lock:
                if self._ftab_np is None:
                    bits = self._ftab_bits()
                    with self.stats.timeit_ts("build-ftab"):
                        self._ftab_np = (
                            fm_ops.build_ftab(self.pindex.fm, bits)
                            if bits
                            else False
                        )
        return self._ftab_np if self._ftab_np is not False else None

    def _get_map_arrays(self):
        if self._map_arrays is None and self._path_map is not None:
            self._map_arrays = fm_ops.map_to_device(
                self.pindex.fm, self._path_map, self.device
            )
        return self._map_arrays

    # --- on-path route ----------------------------------------------------
    def _onpath_search_keys(self, index: SeedsIndex):
        """The deterministic key pipeline of the on-path route: distinct
        seed k-mers (+ Hamming-ball expansion under --mismatches) and
        the maps back to seed groups: (uniq_start, search_keys, origin)."""
        uniq_keys, uniq_start = np.unique(index.sorted_keys, return_index=True)
        if self.seed_mismatches:
            from psi_tpu_torch.ops.kmers import expand_hamming

            search_keys, origin = expand_hamming(
                uniq_keys, self.seed_len, self.seed_mismatches
            )
        else:
            search_keys = uniq_keys
            origin = np.arange(len(uniq_keys), dtype=np.int64)
        return uniq_start, search_keys, origin

    def _plan_onpath(self, index: SeedsIndex) -> OnpathPlan:
        """The chunk's on-path plan: the key pipeline, the distinct search
        keys and the trie plan over them, sharded when the finder has a
        mesh. fm_trie.prepare times its parts as plan-schedule and
        plan-upload (per shard on a mesh)."""
        with self.stats.timeit_ts("plan-keys"):
            uniq_start, search_keys, origin = self._onpath_search_keys(index)
            uniq_end = np.append(uniq_start[1:], index.size)
            if self.seed_mismatches:
                uniq, inv = np.unique(search_keys, return_inverse=True)
                run_stats.count("plan-ball-keys", len(uniq))
            else:   # exact seeds: already the distinct keys, sorted
                uniq, inv = search_keys, np.arange(len(search_keys))
        mesh = self._get_mesh()
        if mesh is not None:
            from psi_tpu_torch.parallel.mesh import prepare_trie_sharded

            trie = prepare_trie_sharded(
                mesh, uniq, self.seed_len, self.pindex.fm.size,
                self._get_ftab(),
            )
        else:
            trie = fm_trie.prepare(
                uniq, self.seed_len, self._get_ftab(), device=self.device
            )
        return OnpathPlan(uniq_start, uniq_end, origin, uniq, inv, trie)

    def prepare_onpath(self, index) -> None:
        """Build the chunk's on-path plan and keep it on the index for the
        query; runs on the CLI's producer thread, overlapped with the
        previous chunk's queries."""
        if index.size == 0:
            return
        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return
        with self.stats.timeit_ts("prepare-onpath", index.rec_offset):
            index._onpath_prep = self._plan_onpath(index)

    def _onpath_chain(self, plan: OnpathPlan, thr: int):
        """Trie search -> counts download -> device expand + locate over
        the device-resident lo/hi -> one global position per hit.
        Returns (counts[search order], emit mask, locate), where locate()
        gives the join's (emit mask, occ_start_u, gpos_stream)."""
        mesh = self._get_mesh()
        if mesh is not None:
            return self._onpath_chain_sharded(plan, thr, mesh)
        k = self.seed_len
        prepared = plan.trie
        lo_d, hi_d = fm_trie._trie_device(
            self._get_stream_arrays(), prepared.parents, prepared.chars,
            prepared.lo0, prepared.hi0,
        )
        counts_pat = run_stats.download(hi_d - lo_d).numpy().astype(np.int64)
        leaf_perm = prepared.leaf_perm
        counts = counts_pat[leaf_perm][plan.inv]
        thr32 = int(min(thr, np.iinfo(np.int32).max))
        emit = (counts > 0) & (counts <= thr32)

        def locate():
            n_leaves = len(plan.uniq)
            valid = np.arange(len(counts_pat)) < n_leaves
            w_pat = np.where(
                valid & (counts_pat > 0) & (counts_pat <= thr32),
                counts_pat, 0,
            )
            maps = self._get_map_arrays()
            gpos_d, _ = fm_trie.expand_locate(
                self._get_sa(),
                maps.str_starts, maps.lengths, maps.seq_off,
                lo_d, hi_d, n_leaves, thr32, k, cap=int(w_pat.sum()),
            )
            gpos_stream = run_stats.download(gpos_d).numpy().astype(np.int64)
            occ_start_u = (np.cumsum(w_pat) - w_pat)[leaf_perm]
            return emit, occ_start_u, gpos_stream

        return counts, emit, locate

    def _onpath_chain_sharded(self, plan: OnpathPlan, thr: int, mesh):
        """The device-chained on-path route on a multi-device mesh: the
        trie kernels run per shard over the per-shard plans, only counts
        come down, and each shard then expands + locates its own
        device-resident ranges against its copy of the SA (gpos-only
        download per shard, at cap = max(16, next_pow2(max shard
        total))). Same transfer profile per device as the single-device
        chain, and the same join follows."""
        from psi_tpu_torch.parallel import mesh as mesh_mod
        from psi_tpu_torch.parallel.distributed import process_allgather

        k = self.seed_len
        prepared = plan.trie
        sarr_r = self._get_mesh_repl(mesh, "sarr", self._get_stream_arrays)
        lo_d, hi_d, counts_d = mesh_mod._sharded_trie_device(
            mesh, sarr_r, prepared, with_counts=True,
        )
        local = mesh.local_positions()
        counts2 = process_allgather(np.stack(
            [run_stats.download(counts_d[p]).numpy() for p in local]))
        D = mesh.shape["data"]
        Npad = counts2.shape[1]
        per = prepared.per
        N = prepared.n
        counts_u = np.zeros(N, dtype=np.int64)
        for d in range(D):
            if prepared.sizes[d]:
                sl = slice(d * per, d * per + prepared.sizes[d])
                counts_u[sl] = counts2[d][prepared.leaf_perms[d]]
        counts = counts_u[plan.inv].astype(np.int64)
        thr32 = int(min(thr, np.iinfo(np.int32).max))
        emit = (counts > 0) & (counts <= thr32)

        def locate():
            w2 = np.zeros((D, Npad), dtype=np.int64)
            for d in range(D):
                valid_d = np.arange(Npad) < prepared.sizes[d]
                w2[d] = np.where(
                    valid_d & (counts2[d] > 0) & (counts2[d] <= thr32),
                    counts2[d], 0,
                )
            tot_d = w2.sum(axis=1)
            cap = max(16, 1 << (int(tot_d.max()) - 1).bit_length())
            maps = self._get_map_arrays()
            sa_r = self._get_mesh_repl(mesh, "sa", self._get_sa)
            maps_r = self._get_mesh_repl(
                mesh, "maps",
                lambda: (maps.str_starts, maps.lengths, maps.seq_off),
            )
            local_only = self._mh_emit_sharded()
            str_r, len_r, off_r = ([None if m is None else m[i]
                                    for m in maps_r] for i in range(3))
            gpos2 = mesh_mod.sharded_expand_locate(
                mesh, sa_r, str_r, len_r, off_r, lo_d, hi_d,
                np.asarray(prepared.sizes), thr32, k, cap,
                local_only=local_only,
            )
            if local_only:
                gpos2, local_ds = gpos2
            else:
                local_ds = np.ones(D, dtype=bool)
            # local-only: the gpos stream holds only this process's
            # shards; keys of other shards are masked out of the emit
            # set, so the join never reads a missing shard's positions
            # and the emitted hit stream is this process's disjoint
            # slice of the global one
            tot_emit = np.where(local_ds, tot_d, 0)
            base_d = np.cumsum(tot_emit) - tot_emit
            gpos_stream = np.concatenate(
                [gpos2[d, : tot_emit[d]] for d in range(D)]
            ).astype(np.int64)
            occ_start_u = np.zeros(N, dtype=np.int64)
            local_key = np.zeros(N, dtype=bool)
            for d in range(D):
                if prepared.sizes[d]:
                    sl = slice(d * per, d * per + prepared.sizes[d])
                    occ_start_u[sl] = (
                        (np.cumsum(w2[d]) - w2[d])[prepared.leaf_perms[d]]
                        + base_d[d]
                    )
                    local_key[sl] = local_ds[d]
            emit_loc = emit if local_ds.all() else emit & local_key[plan.inv]
            return emit_loc, occ_start_u, gpos_stream

        return counts, emit, locate

    def _chain_join(self, plan: OnpathPlan, counts, emit, occ_start_u,
                    gpos_stream, index, seeds) -> np.ndarray:
        """The deterministic seed join, as SEED_DTYPE rows: the device's
        gpos stream is ordered by (pattern slot, SA rank), so each emitted
        search key's occurrences are its distinct key's segment, located
        from counts alone; each occurrence is mapped to (node, offset) by
        a search of the path map and crossed with its k-mer's seeds. One
        native pass (psi_emit_join, OpenMP) where the host library is
        loaded; else NumPy, in the same row order."""
        from psi_tpu_torch import native

        pm = self._path_map
        k = self.seed_len
        emit_idx = np.nonzero(emit)[0]
        widths = counts[emit_idx].astype(np.int64)
        seed_counts = plan.uniq_end - plan.uniq_start
        if native.available():
            ns = seed_counts[plan.origin[emit_idx]].astype(np.int64)
            out_off = np.zeros(len(emit_idx) + 1, dtype=np.int64)
            np.cumsum(widths * ns, out=out_off[1:])
            total = int(out_off[-1])
            out = np.empty(total, dtype=SEED_DTYPE)
            if total:
                ok = native.emit_join(
                    counts, emit_idx, plan.inv, plan.origin, occ_start_u,
                    gpos_stream, pm["starts"], pm["ids"], pm["base"],
                    plan.uniq_start, plan.uniq_end, index.seed_ids,
                    seeds.seedmap, int(seeds.rec_offset), int(k),
                    out_off, out.view(np.int64).reshape(total, 6),
                )
                if not ok:
                    # not an assert: under python -O a stripped assert
                    # would silently emit the uninitialized np.empty rows
                    # as hits
                    raise RuntimeError("native emit_join vanished mid-run")
            return out
        total = int(widths.sum())
        occ_rows = np.repeat(np.arange(len(widths)), widths)
        within = np.arange(total) - np.repeat(
            np.cumsum(widths) - widths, widths
        )
        row_per_occ = emit_idx[occ_rows]
        gpos = gpos_stream[occ_start_u[plan.inv[row_per_occ]] + within]
        entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
        node_ids = pm["ids"][entry]
        node_offs = gpos - pm["starts"][entry] + pm["base"][entry]
        # cross product: repeat each occurrence by its k-mer's seed count
        ui_per_occ = plan.origin[row_per_occ]
        n_seeds_per_ui = seed_counts[ui_per_occ]
        rep_nodes = np.repeat(node_ids, n_seeds_per_ui)
        rep_offs = np.repeat(node_offs, n_seeds_per_ui)
        rep_gocc = np.repeat(counts[row_per_occ], n_seeds_per_ui)
        starts_rep = np.repeat(plan.uniq_start[ui_per_occ], n_seeds_per_ui)
        within = np.arange(len(rep_nodes)) - np.repeat(
            np.cumsum(n_seeds_per_ui) - n_seeds_per_ui, n_seeds_per_ui
        )
        seed_sel = index.seed_ids[starts_rep + within]
        out = np.empty(len(rep_nodes), dtype=SEED_DTYPE)
        out["node_id"] = rep_nodes
        out["node_offset"] = rep_offs
        out["read_id"] = seeds.rec_offset + seeds.seedmap[seed_sel, 0]
        out["read_offset"] = seeds.seedmap[seed_sel, 1]
        out["match_len"] = k
        out["gocc"] = rep_gocc
        return out

    # === seeds on paths (FM route) ==========================================
    def seeds_on_paths(
        self,
        seeds: SeedSet,
        index: SeedsIndex,
        callback: Callable[[Seed], None],
    ):
        """Batched equivalent of the dual-iterator kmer_exact_matches
        (ref: seed_finder.hpp:1426-1457 driving index_iter.hpp:808-852):
        every distinct seed k-mer is counted/located in the path FM index
        in one device batch; hits are the cross product of path
        occurrences x matching seeds, gocc = path-side occurrence count,
        filtered by gocc_threshold.
        """
        context = self.pindex.get_context()
        if context != 0 and context < self.seed_len:
            raise RuntimeError("seed length should not be larger than context size")
        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return
        self.stats.set_progress(ProgressEnum.READY)
        tstats = self.stats.get_this_thread_stats()
        tstats.set_progress(ProgressEnum.FIND_ON_PATHS)
        with self.stats.timeit_ts("seeds-on-paths", seeds.rec_offset):
            arr = self._seeds_on_paths_impl(seeds, index)
            if arr is not None:
                _emit_rows(arr, callback)

    def seeds_on_paths_arrays(self, seeds, index):
        """Columnar variant: structured SEED_DTYPE array (bulk path)."""
        with self.stats.timeit_ts("seeds-on-paths", seeds.rec_offset):
            return self._seeds_on_paths_impl(seeds, index)

    def _seeds_on_paths_impl(self, seeds, index):
        tstats = self.stats.get_this_thread_stats()
        if index.size == 0:
            return None
        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return None
        with self.stats.timeit_ts("onpath-keys"):
            # the producer's plan; a caller that skipped prepare_onpath
            # has it built here
            plan = getattr(index, "_onpath_prep", None)
            if plan is None:
                plan = self._plan_onpath(index)
        thr = (self.gocc_threshold if self.gocc_threshold
               else np.iinfo(np.int64).max)
        # the trie search, its counts and what they emit
        with self.stats.timeit_ts("onpath-trie"):
            counts, emit, locate = self._onpath_chain(plan, thr)
            skipped = (counts > 0) & ~emit
            tstats.add_seed_gocc_bulk(int(counts[emit].sum()),
                                      int(emit.sum()))
            tstats.inc_gocc_skips(int(skipped.sum()))
        if not emit.any():
            return None
        with self.stats.timeit_ts("onpath-locate"):
            emit, occ_start_u, gpos_stream = locate()
        with self.stats.timeit_ts("onpath-join"):
            return self._chain_join(plan, counts, emit, occ_start_u,
                                    gpos_stream, index, seeds)

    # === MEM query path (library API, ref: seed_finder.hpp:1459-1479) ======
    def seeds_on_paths_seq(
        self, sequence: str, callback: Callable[[Seed], None]
    ):
        """find_mems over the path index on the host, one read
        (ref: index_iter.hpp:854-906)."""
        if self.pindex.fm is None or self.pindex.fm.size == 0:
            return
        self.stats.set_progress(ProgressEnum.READY)
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.FIND_MEMS)
        with self.stats.timeit_ts("query-paths"):
            self._find_mems_impl(sequence, callback)

    def _find_mems_impl(self, sequence: str, callback):
        fm = self.pindex.fm
        pm = self._path_map
        k = self.seed_len
        thr = self.gocc_threshold if self.gocc_threshold else float("inf")
        max_mem = self.max_mem if self.max_mem else float("inf")

        start = 0
        plen = 0
        lo, hi = 0, fm.size
        has_hit = False
        nof_hits = 0
        n = len(sequence)
        while start + plen < n:
            if plen >= k and (hi - lo) <= thr:
                has_hit = True
                occ = fm.locate(lo, hi)
                sid, q = fm.text_pos_to_string(np.asarray(occ))
                fwd = pm["lengths"][sid] - q - plen
                gpos = pm["seq_off"][sid] + fwd
                entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
                for nid, noff in zip(
                    pm["ids"][entry],
                    gpos - pm["starts"][entry] + pm["base"][entry],
                ):
                    callback(
                        Seed(int(nid), int(noff), 0, start, plen, int(hi - lo))
                    )
                    nof_hits += 1
                if nof_hits >= max_mem:
                    break
            c = int(fm.codemap[ord(sequence[start + plen])])
            # any non-ACGT byte restarts, as the batched route does
            if has_hit or not (1 <= c <= 4):
                lo, hi = 0, fm.size
                start = start + plen + 1
                plen = 0
                has_hit = False
                continue
            nlo, nhi = fm.lf_step(c, lo, hi)
            if nlo >= nhi:
                lo, hi = 0, fm.size
                start = start + plen + 1
                plen = 0
                has_hit = False
                continue
            lo, hi = nlo, nhi
            plen += 1

    def seeds_on_paths_seqs(
        self, reads: Records, callback: Callable[[Seed], None]
    ):
        """Batched MEM query (library API used by aligners): every read
        runs the find_mems automaton in one lockstep device loop
        (ref: seed_finder.hpp:1459-1479 over index_iter.hpp:854-906). Hit
        multiset per read matches seeds_on_paths_seq (read_offset = MEM
        start, match_len = MEM length, gocc = occurrence count)."""
        arr = self.find_mems_arrays(reads)
        if arr is not None:
            _emit_rows(arr, callback)

    def find_mems_arrays(self, reads: Records):
        """Columnar batched find_mems: structured SEED_DTYPE array, or
        None when there is no MEM. The automaton runs on the device, one
        LF step of every read per cursor position; locate and mapping run
        on the host."""
        fm = self.pindex.fm
        if fm is None or fm.size == 0 or len(reads) == 0:
            return None
        self.stats.get_this_thread_stats().set_progress(ProgressEnum.FIND_MEMS)
        with self.stats.timeit_ts("query-paths", reads.rec_offset):
            k = self.seed_len
            N = len(reads)
            lut = np.zeros(256, dtype=np.int32)
            for i, ch in enumerate("ACGT"):
                lut[ord(ch)] = i + 1
                lut[ord(ch.lower())] = i + 1
            # scatter each read's coded bytes into its padded row through
            # one flat ragged -> dense index; packed chunks feed their byte
            # array directly
            pk = reads.packed_view()
            if pk is not None:
                flat, off = pk
                rlens = (off[1:] - off[:-1]).astype(np.int32)
            else:
                rlens = np.fromiter(
                    (len(s) for s in reads.seqs), dtype=np.int32, count=N
                )
                flat = np.frombuffer(
                    "".join(reads.seqs).encode("ascii"), dtype=np.uint8
                )
            L = int(rlens.max())
            if L == 0:
                return None
            starts = np.zeros(N, dtype=np.int64)
            np.cumsum(rlens[:-1], out=starts[1:])
            total = int(rlens.sum())
            within = np.arange(total, dtype=np.int64) - np.repeat(
                starts, rlens
            )
            codes = np.zeros((N, L), dtype=np.int32)
            codes[np.repeat(np.arange(N), rlens), within] = lut[flat]
            thr = self.gocc_threshold or (2**31 - 1)
            mm = self.max_mem or (2**31 - 1)
            # a read emits at most one MEM per k+1 consumed positions
            max_out = L // (k + 1) + 2
            dev = self.device
            out_lo, out_hi, out_start, out_plen, nout, _overflow = (
                fm_ops.find_mems_device(
                    self._get_fm_arrays(),
                    torch.from_numpy(codes).to(dev),
                    torch.from_numpy(rlens).to(dev),
                    k, thr, mm, max_out,
                )
            )
            nout = nout.cpu().numpy()
            valid = (
                np.arange(max_out, dtype=np.int32)[None, :] < nout[:, None]
            )
            if not valid.any():
                return None
            rr, _ = np.nonzero(valid)
            lo_f, hi_f, start_f, plen_f = (
                t.cpu().numpy()[valid].astype(np.int64)
                for t in (out_lo, out_hi, out_start, out_plen))

            # locate + graph mapping (the fwd flip uses each MEM's length)
            pm = self._path_map
            widths = hi_f - lo_f
            total = int(widths.sum())
            occ_rows = np.repeat(np.arange(len(widths)), widths)
            within = np.arange(total) - np.repeat(
                np.cumsum(widths) - widths, widths
            )
            occ_pos = fm.sa[lo_f[occ_rows] + within]
            sid, q = fm.text_pos_to_string(occ_pos)
            fwd = pm["lengths"][sid] - q - plen_f[occ_rows]
            gpos = pm["seq_off"][sid] + fwd
            entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
            out = np.empty(total, dtype=SEED_DTYPE)
            out["node_id"] = pm["ids"][entry]
            out["node_offset"] = gpos - pm["starts"][entry] + pm["base"][entry]
            out["read_id"] = reads.rec_offset + rr[occ_rows]
            out["read_offset"] = start_f[occ_rows]
            out["match_len"] = plen_f[occ_rows]
            out["gocc"] = widths[occ_rows]
            return out

    def all_exact_matches(
        self, reads: Records, callback: Callable[[Seed], None]
    ):
        """Whole-read exact matching over the path index on the host
        (ref: all_exact_matches, index_iter.hpp:928-948; per-read
        backward search, occurrences mapped to graph loci, match_len =
        read length, gocc left 0 as in the reference). N is a real Dna5
        symbol (code 5) on both the read and text sides."""
        fm = self.pindex.fm
        if fm is None or fm.size == 0:
            return
        pm = self._path_map
        for rid in range(len(reads)):
            seq = reads.seqs[rid]
            if not seq:
                continue
            lo, hi = fm.backward_search(seq[::-1])
            if lo >= hi:
                continue
            L = len(seq)
            occ = fm.locate(lo, hi)
            sid, q = fm.text_pos_to_string(np.asarray(occ))
            fwd = pm["lengths"][sid] - q - L
            gpos = pm["seq_off"][sid] + fwd
            entry = np.searchsorted(pm["starts"], gpos, side="right") - 1
            for nid, noff in zip(
                pm["ids"][entry], gpos - pm["starts"][entry] + pm["base"][entry]
            ):
                callback(
                    Seed(int(nid), int(noff), reads.position_to_id(rid), 0, L, 0)
                )

    # === seeds off paths (traversal route) ==================================
    def seeds_off_paths(
        self,
        seeds: SeedSet,
        index: SeedsIndex,
        callback: Callable[[Seed], None],
        device: bool = True,
    ):
        """(ref: seed_finder.hpp:1703-1722 over traverser_bfs.hpp:72-164)"""
        self.stats.set_progress(ProgressEnum.READY)
        tstats = self.stats.get_this_thread_stats()
        tstats.set_progress(ProgressEnum.FIND_OFF_PATHS)
        with self.stats.timeit_ts("seeds-off-path", seeds.rec_offset):
            if not self.starting_loci:
                return
            if device:
                cols = self._traverse_device_columns(index)
                raw = (zip(*(c.tolist() for c in cols)) if cols is not None
                       else ())
            else:
                raw = trav.traverse_host(
                    self.graph, index, self.starting_loci, self.seed_len,
                    max_mismatches=self.seed_mismatches,
                )
            for nid, noff, sid, gocc, L in raw:
                callback(
                    Seed(
                        nid,
                        noff,
                        seeds.read_id(sid),
                        seeds.read_offset(sid),
                        L,
                        gocc,
                    )
                )
            tstats.set_locus_idx(len(self.starting_loci))

    def _traverse_device_columns(self, index: SeedsIndex):
        """(node, off, seed_id, gocc, len) columns of the off-path hits,
        or None when there are no loci or seeds."""
        if not self.starting_loci or index.size == 0:
            return None
        return self._traverse_collect(index, self._traverse_dispatch(index))

    def _get_graph_arrays(self):
        if self._graph_arrays is None:
            self._graph_arrays = trav.graph_to_device(self.graph, self.device)
        return self._graph_arrays

    def _traverse_dispatch(self, index: SeedsIndex, g=None, sa=None,
                           cap: int | None = None):
        """Issue the off-path traversal: the WalkTree when there are no
        mismatches and the tree is cached and fits its cap, else the
        frontier traversal queued on the device (its k steps need no host
        sync, so the on-path route that follows overlaps it). Under a
        mesh, the loci-sharded traversal on every shard instead (never
        the WalkTree), at cap_local = max(4096, next_pow2(loci per
        shard)). Returns a tagged handle for _traverse_collect, or None
        when off-path does not apply."""
        if not self.starting_loci or index.size == 0:
            return None
        mesh = self._get_mesh()
        if mesh is None and not self.seed_mismatches and cap is None:
            tree = self._get_trav_tree()
            if tree is not None:
                return ("tree", tree)
        if g is None:
            g = self._get_graph_arrays()
        if sa is None:
            sa = trav.seeds_to_device(index, self.device)
        if mesh is not None:
            from psi_tpu_torch.parallel.mesh import sharded_traverse_dispatch

            n = len(self.starting_loci)
            D = mesh.shape["data"]
            per = max(-(-n // D), 1)
            if cap is None:
                cap = max(1 << 12, 1 << (per - 1).bit_length())
            sn, so = self._get_loci_np()
            handle = sharded_traverse_dispatch(
                mesh, g, sa, sn, so, self.seed_len, cap,
                max_mm=self.seed_mismatches,
            )
            return ("mesh", handle, cap, g, sa, mesh)
        n = len(self.starting_loci)
        if cap is None:
            cap = max(1 << 15, 1 << (n - 1).bit_length())
        sn_d, so_d = self._get_loci_device(cap)
        packed_d = trav.traverse_device_packed(
            g, sa, sn_d, so_d, n, self.seed_len, cap, self.seed_mismatches,
        )
        if self.seed_mismatches:
            # range_refine4 runs over the whole cap at each of the k steps
            run_stats.count("approx-slots", self.seed_len * cap)
        return ("single", packed_d, cap, g, sa)

    def _traverse_collect(self, index: SeedsIndex, pending):
        """Fetch a _traverse_dispatch result (retrying with a doubled
        state cap on overflow) and assemble the columnar survivors."""
        if pending is None:
            return None
        if pending[0] == "tree":
            with self.stats.timeit_ts("offpath-fetch"):
                locus_idx, lo, hi, gd, ended, ended_len = (
                    trav.walks_match_device(pending[1], index.sorted_keys))
            n_used = len(locus_idx)
            self.stats.get_this_thread_stats().add_traversal(
                gd, ended + n_used, ended_len + n_used * self.seed_len,
            )
            with self.stats.timeit_ts("offpath-columns"):
                return trav.traverse_columnar_from_states(
                    index, self.starting_loci, locus_idx, lo, hi,
                    self.seed_len,
                )
        if pending[0] == "mesh":
            return self._traverse_collect_sharded(index, pending)
        _, packed_d, cap, g, sa = pending
        attempts = 1
        with self.stats.timeit_ts("offpath-fetch"):
            while True:
                packed = run_stats.download(packed_d).numpy()
                n_used = int(packed[3 * cap])
                if int(packed[3 * cap + 1]):    # overflow
                    _, packed_d, cap, g, sa = self._traverse_dispatch(
                        index, g, sa, cap * 2
                    )
                    attempts += 1
                    run_stats.count("traverse-retries", 1)
                    continue
                if not self.seed_mismatches:
                    # only account the final (non-overflowing) run's
                    # counters
                    gd, ended, ended_len = (int(v)
                                            for v in packed[3 * cap + 2:])
                    self.stats.get_this_thread_stats().add_traversal(
                        gd, ended + n_used, ended_len + n_used * self.seed_len,
                    )
                break
        self.last_traversal = {"cap": cap, "attempts": attempts}
        with self.stats.timeit_ts("offpath-columns"):
            return trav.traverse_columnar_from_states(
                index, self.starting_loci,
                packed[:n_used],
                packed[cap: cap + n_used],
                packed[2 * cap: 2 * cap + n_used],
                self.seed_len,
            )

    def _traverse_collect_sharded(self, index: SeedsIndex, pending):
        """Fetch a mesh-mode _traverse_dispatch result (cap-doubling
        retry while any shard overflows) and assemble the columnar
        survivors (this process's shards only under process-sharded
        emission)."""
        from psi_tpu_torch.parallel.mesh import (
            sharded_traverse_collect, sharded_traverse_dispatch,
        )

        _, handle, cap_local, g, sa, mesh = pending
        sn, so = self._get_loci_np()
        local_only = self._mh_emit_sharded()
        with self.stats.timeit_ts("offpath-fetch"):
            while True:
                li, lo, hi, nu, ov, ts, local_ds = sharded_traverse_collect(
                    handle, local_only=local_only
                )
                # overflow is gathered even in local-only mode: the
                # cap-doubling re-dispatch is a collective decision
                if ov.any():
                    cap_local *= 2
                    handle = sharded_traverse_dispatch(
                        mesh, g, sa, sn, so, self.seed_len, cap_local,
                        max_mm=self.seed_mismatches,
                    )
                    run_stats.count("traverse-retries", 1)
                    continue
                break
        if not self.seed_mismatches:
            n_surv = int(nu.sum())
            self.stats.get_this_thread_stats().add_traversal(
                int(ts[:, 0].sum()), int(ts[:, 1].sum()) + n_surv,
                int(ts[:, 2].sum()) + n_surv * self.seed_len,
            )
        # local-only: join/emit only this process's loci shards (the
        # global stream is the concatenation of the disjoint per-process
        # streams; SURVEY §5 order-insensitive emission)
        nu_emit = np.where(local_ds, nu, 0)
        keep = [np.concatenate([a[d, : nu_emit[d]] for d in range(len(a))])
                for a in (li, lo, hi)]
        with self.stats.timeit_ts("offpath-columns"):
            return trav.traverse_columnar_from_states(
                index, self.starting_loci, *keep, self.seed_len,
            )

    @staticmethod
    def _trav_tree_enabled() -> bool:
        """WalkTree route (see ops/traverse.WalkTree), on by default for
        exact matching: the per-chunk traversal becomes prefix probes of a
        tree built once per loci set. PSI_TRAV_CACHE=0 runs the per-chunk
        device traversal instead."""
        return os.environ.get("PSI_TRAV_CACHE", "1") not in ("", "0")

    def _get_trav_tree(self):
        """Lazy chunk-independent WalkTree on the finder's device, or None
        when the route is off or the tree exceeds PSI_TRAV_CACHE_CAP nodes
        (default trav.NODE_CAP). Fingerprinted on the loci set (node and
        offset bytes), so staged add_uncovered_loci calls or loci reloads
        rebuild it."""
        if not self._trav_tree_enabled():
            return None
        sn, so = self._get_loci_np()
        fp = (len(sn), hash((sn.tobytes(), so.tobytes())))
        cached = self._trav_tree
        if cached is None or cached[0] != fp:
            with self._prep_lock:
                cached = self._trav_tree
                if cached is None or cached[0] != fp:
                    with self.stats.timeit_ts("seeds-off-path"):
                        cap = int(os.environ.get("PSI_TRAV_CACHE_CAP",
                                                 str(trav.NODE_CAP)))
                        tree = trav.enumerate_walks(
                            self.graph, sn, so, self.seed_len, node_cap=cap)
                        dtree = (None if tree is None
                                 else trav.tree_to_device(tree, self.device))
                    cached = (fp, tree if tree is not None else False, dtree)
                    self._trav_tree = cached
        return cached[2]

    def offpath_route(self) -> dict:
        """The off-path route of the last query: the WalkTree, with its
        node count, when it was built and fit its cap, else the device
        traversal, with its final cap and attempts once one has run."""
        cached = self._trav_tree
        if cached is not None and cached[1] is not False:
            return {"route": "walktree", "walktree_nodes": int(cached[1].n_nodes)}
        return {"route": "traverse_device", "walktree_nodes": None,
                **(self.last_traversal or {})}

    def _get_loci_np(self):
        """Host-side starting-loci arrays (cached per loci count)."""
        n = len(self.starting_loci)
        if self._loci_np is None or self._loci_np[0] != n:
            sn = np.zeros(n, dtype=np.int32)
            so = np.zeros(n, dtype=np.int32)
            for i, l in enumerate(self.starting_loci):
                sn[i] = l.node_id()
                so[i] = l.offset()
            self._loci_np = (n, (sn, so), {})
        return self._loci_np[1]

    def _get_loci_device(self, cap: int):
        """The starting loci on the device, padded to `cap` (the loci are
        fixed per finder: one upload per cap bucket, not per chunk)."""
        sn, so = self._get_loci_np()
        dev = self._loci_np[2].get(cap)
        if dev is None:
            padded = np.zeros((2, cap), dtype=np.int32)
            padded[0, : len(sn)] = sn
            padded[1, : len(so)] = so
            dev = tuple(run_stats.upload(torch.from_numpy(a), self.device)
                        for a in padded)
            self._loci_np[2][cap] = dev
        return dev

    @staticmethod
    def _off_cols_to_arrays(seeds: SeedSet, cols):
        if cols is None:
            return None
        nodes, offs, seed_sel, goccs, lens = cols
        out = np.empty(len(nodes), dtype=SEED_DTYPE)
        out["node_id"] = nodes
        out["node_offset"] = offs
        out["read_id"] = seeds.rec_offset + seeds.seedmap[seed_sel, 0]
        out["read_offset"] = seeds.seedmap[seed_sel, 1]
        out["match_len"] = lens
        out["gocc"] = goccs
        return out

    def seeds_off_paths_arrays(self, seeds: SeedSet, index: SeedsIndex):
        """Columnar off-path hits (structured SEED_DTYPE array)."""
        with self.stats.timeit_ts("seeds-off-path", seeds.rec_offset):
            return self._off_cols_to_arrays(
                seeds, self._traverse_device_columns(index)
            )

    def seeds_all_arrays(self, seeds: SeedSet, index: SeedsIndex,
                         split: bool = False):
        """Both routes, columnar; the bulk path used by the CLI.

        The off-path traversal is dispatched first (the WalkTree fetched,
        or the device traversal queued) and collected after the on-path
        route, so a device traversal overlaps the on-path transfers and
        host joins. `split=True` returns (on_path, off_path) arrays
        instead of the concatenation."""
        pending = None
        chunk = seeds.rec_offset
        if self.starting_loci and index.size:
            with self.stats.timeit_ts("seeds-off-path", chunk):
                pending = self._traverse_dispatch(index)
        parts = [self.seeds_on_paths_arrays(seeds, index)]
        if pending is not None:
            with self.stats.timeit_ts("seeds-off-path", chunk):
                tstats = self.stats.get_this_thread_stats()
                tstats.set_progress(ProgressEnum.FIND_OFF_PATHS)
                parts.append(self._off_cols_to_arrays(
                    seeds, self._traverse_collect(index, pending)
                ))
                tstats.set_locus_idx(len(self.starting_loci))
        else:
            parts.append(self.seeds_off_paths_arrays(seeds, index))
        self.stats.get_this_thread_stats().inc_chunks_done()
        if split:
            empty = np.zeros(0, dtype=SEED_DTYPE)
            return (
                parts[0] if parts[0] is not None else empty,
                parts[1] if parts[1] is not None else empty,
            )
        parts = [p for p in parts if p is not None and len(p)]
        if not parts:
            return np.zeros(0, dtype=SEED_DTYPE)
        return np.concatenate(parts)

    # === combined ===========================================================
    def seeds_all(
        self,
        seeds: SeedSet,
        index: SeedsIndex,
        callback: Callable[[Seed], None],
        device: bool = True,
    ):
        """(ref: seed_finder.hpp:1724-1743)"""
        self.seeds_on_paths(seeds, index, callback)
        self.seeds_off_paths(seeds, index, callback, device=device)
        self.stats.get_this_thread_stats().inc_chunks_done()


def _emit_rows(arr: np.ndarray, callback: Callable[[Seed], None]) -> None:
    """Feed a structured SEED_DTYPE array through a per-hit callback."""
    for row in arr:
        callback(
            Seed(
                int(row["node_id"]),
                int(row["node_offset"]),
                int(row["read_id"]),
                int(row["read_offset"]),
                int(row["match_len"]),
                int(row["gocc"]),
            )
        )
