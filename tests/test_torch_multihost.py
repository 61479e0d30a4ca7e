"""A real 2-process run of the port's multi-device pipeline on the CPU:
two psi_tpu_torch.tools.multihost_worker processes, gloo on a free
localhost port, one mesh shard each. The worker holds component-sharded
counting (totals summed across processes) and the data-parallel trie
search to a global FM oracle, and the SeedFinder pipeline on the global
mesh to the single-device finder under both emission modes: under
PSI_MH_EMIT=shard the two processes' streams are disjoint and their
union is the single-device multiset, under full each process's stream
equals it (R4). The counterpart of tests/test_multihost.py."""

import json
import os
import socket
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pipeline(tmp_path):
    out = str(tmp_path / "mh2.json")
    port = _free_port()
    env = dict(os.environ)
    for name in ("PSI_DEVICES", "PSI_MH_EMIT", "PSI_STREAM",
                 "PSI_DEVICE_LOCATE", "PSI_TRAV_CACHE"):
        env.pop(name, None)
    # small tensors: one intra-op thread a process, beside the suite's
    # other workers
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "psi_tpu_torch.tools.multihost_worker",
             str(port), str(i), "2", out, "--device", "cpu"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=env,
        )
        for i in range(2)
    ]
    errs = []
    try:
        for i, p in enumerate(procs):
            _, se = p.communicate(timeout=120)
            if p.returncode != 0:
                errs.append(f"proc {i} rc={p.returncode}:\n"
                            f"{se.decode()[-2000:]}")
    finally:
        for p in procs:
            p.kill()
    assert not errs, "\n".join(errs)
    with open(out) as fh:
        res = json.load(fh)
    assert res["nproc"] == 2 and res["devices"] == 2
    assert res["count_ok"], "sharded count diverged from the global oracle"
    assert res["trie_ok"], "sharded trie search diverged from the oracle"
    assert res["disjoint"], "the processes' shard streams overlap"
    assert res["shard_ok"], "the union of the shard streams is not the " \
        "single-device stream"
    assert res["full_ok"], "a process's full stream is not the " \
        "single-device stream"
    assert res["pipeline_hits"] > 0 and res["pipeline_loci"] > 0
    shard = [p["hits_shard"] for p in res["processes"]]
    assert sum(shard) == res["pipeline_hits"] and min(shard) > 0
    assert all(p["hits_full"] == res["pipeline_hits"]
               for p in res["processes"])
