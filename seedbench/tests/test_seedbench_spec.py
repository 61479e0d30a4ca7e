"""BENCHMARK.json against the contract's rules, the lookup of a cell's
files by name, the import rules, and a run with no card."""

import ast
import json
import pathlib
import re

import pytest

from seedbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SPEC = harness.load_spec()


def test_names_units_and_lines_use_allowed_characters():
    names = []
    for c in SPEC["configs"]:
        names.append(c["name"])
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (harness.ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "layer" in m:
            assert LINE.match(m["layer"])
            assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in SPEC["workloads"]}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert all(LINE.match(w) for w in SPEC["command"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_cell_and_metric_resolves():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"], 1, 1.0, 0.0, SPEC)
        assert cell.config["name"] == w["config"]
        reported = harness.metrics_of(SPEC, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert harness.metrics_of(SPEC, w["name"], True)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("missing", ["configs", "traffic", "entries"])
def test_missing_file_fails_with_its_name(tmp_path, missing):
    for sub in ("configs", "traffic", "entries"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "cfg.json").write_text("{}")
    (tmp_path / "traffic" / "mix.json").write_text('{"entry": "loop"}')
    (tmp_path / "entries" / "loop.py").write_text("")
    victim = {"configs": "configs/cfg.json", "traffic": "traffic/mix.json",
              "entries": "entries/loop.py"}[missing]
    (tmp_path / victim).unlink()
    spec = {"workloads": [{"name": "c.mix", "config": "cfg",
                           "traffic": "mix", "chips": 1}]}
    with pytest.raises(harness.CellError, match=pathlib.Path(victim).stem):
        harness.load_cell("c.mix", 1, 1.0, 0.0, spec, base=tmp_path)
    with pytest.raises(harness.CellError, match="nope"):
        harness.load_cell("nope", 1, 1.0, 0.0, spec, base=tmp_path)


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(harness.HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "psi_tpu"}, f
    for name in ("gen.py", "reference.py", "roofline.py", "trace.py"):
        assert "psi_tpu_torch" not in _imports(harness.HERE / name), name


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["psi_tpu_torch", "psi_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["psi_tpu.cli", "jax._src", "flax"]) == ["flax", "jax", "psi_tpu"]


def test_run_without_a_card_fails_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from seedbench import run

    rc = run.main(["--workload", "g1k_common.exact", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA card" in err


@pytest.mark.cuda
def test_short_run_on_the_card():
    """A short run of the main cell through the whole harness."""
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "seedbench.run", "--workload",
         "g1k_common.exact", "--seed", "5", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
