"""CPU tests of the benchmark harness at tiny sizes."""

import copy
import json
import time

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def tiny_cell():
    """make(config, traffic, **changes) -> a Cell of the named files cut to
    a tiny size, for the chunk loop on the CPU."""
    from seedbench import harness
    from seedbench.entries import chunk_loop

    def make(config="g1k_common", traffic="exact", seconds=0.3, seed=7,
             ref_len=20000, chunk_reads=150, pool_chunks=2):
        cfg = copy.deepcopy(json.load(open(
            harness.HERE / "configs" / f"{config}.json")))
        tr = copy.deepcopy(json.load(open(
            harness.HERE / "traffic" / f"{traffic}.json")))
        cfg["ref_len"] = ref_len
        tr.update(chunk_reads=chunk_reads, pool_chunks=pool_chunks)
        return harness.Cell(f"{config}.{traffic}", cfg, tr, chunk_loop,
                            seed, seconds, time.monotonic())
    return make
