"""BENCHMARK.json and the files it names: the contract's names, units and
keys, every name resolving to its file, and the imports the benchmark may
not make."""

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "perfbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]


def test_entry_keys_and_unique_names():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and (m["name"] != "setup_s" or m["bound"] <= 0.25)
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    names = [e["name"] for e in MAN["configs"] + MAN["workloads"] + METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    res = harness.resolve(cell["name"], MAN)
    assert (HERE / "drivers" / f"{res.traffic['driver']}.py").is_file()
    assert set(res.cell["limits"]) and all(v > 0 for v in res.cell["limits"].values())
    assert set(res.cell["limits"]) <= _numbers(res.traffic["driver"])
    for m in res.e2e + res.per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"] for m in res.e2e}
    assert "setup_s" in e2e and len(e2e) >= 2 and res.per_layer
    for m in res.per_layer:
        assert m["moves"] in e2e


def _numbers(driver: str) -> set:
    return {"train": {"loss1", "loss", "grad1", "change"}, "serve": {"logit_gap"}}[driver]


def test_every_config_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert not set(c["reduced"]) - set(cfg)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "nsa_vibe_tpu"}, path


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_system(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "torch"}, tops


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types
    base = harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "nsa_vibe_tpu_torch_probe", types.ModuleType("x"))
    assert harness.loaded_forbidden() == base
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in harness.loaded_forbidden()
