"""The benchmark's files resolve by name, and no module of it imports
JAX or the JAX package (nor, in the reference, the program)."""

import ast
import importlib
import json
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from pic_bench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    w = next(w for w in BENCH["workloads"] if w["name"] == workload)
    run = harness.load_run(["--workload", workload, "--seed", "1",
                            "--seconds", "1"], 0.0)
    assert run.cell["config"] == w["config"]
    assert run.cell["chips"] == w["chips"]
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).resolve() == (
        HERE / "configs" / f"{w['config']}.json").resolve()
    driver = importlib.import_module(
        f"pic_bench.drivers.{run.config['driver']}")
    assert callable(driver.main) and callable(driver.reference_summary)
    assert set(run.cell["limits"]) >= {"lost", "field_gap", "count_gap",
                                       "ux_gap"}
    assert {"pushes_per_s", "setup_s"} <= set(run.metrics)
    traced = harness.load_run(["--workload", workload, "--seed", "1",
                               "--seconds", "1", "--trace", "1"], 0.0)
    assert traced.metrics
    for name in traced.metrics:
        reader = importlib.import_module(f"pic_bench.metrics.{name}")
        assert callable(reader.read)


def test_metrics_name_their_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(HERE)) for p in HERE.rglob("*.py")))
def test_no_jax_and_a_program_free_reference(path):
    names = _top_level_imports(HERE / path)
    assert not names & {"jax", "jaxlib", "flax", "opal_tpu"}, names
    if path.startswith("reference"):
        assert "opal_tpu_torch" not in names, names


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "opal_tpu_torch_probe",
                        types.ModuleType("opal_tpu_torch_probe"))
    monkeypatch.setitem(sys.modules, "jaxtyping_probe",
                        types.ModuleType("jaxtyping_probe"))
    base = harness.forbidden_modules()
    assert "opal_tpu" not in base and "jax" not in base
    monkeypatch.setitem(sys.modules, "opal_tpu.sim",
                        types.ModuleType("opal_tpu.sim"))
    assert "opal_tpu" in harness.forbidden_modules()
