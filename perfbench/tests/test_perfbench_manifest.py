"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and the import guard."""
import ast
import math
import re
from pathlib import Path

import pytest

from conftest import ROOT, manifest
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["perfbench"]
    assert 1 <= m["run_seconds"] <= 51
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for group in ("end_to_end", "per_layer"):
        for metric in m[group]:
            assert UNIT.match(metric["unit"]), metric
            assert metric["better"] in ("lower", "higher")
            names.append(metric["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert {c["config"] for c in m["workloads"]} == {
        c["name"] for c in m["configs"]}
    bounds = {e["name"]: e["bound"] for e in m["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_check_fits_with_24_cells():
    rs = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_its_metrics():
    m = manifest()
    cells = [w["name"] for w in m["workloads"]]
    for cell in cells:
        e2e = [e["name"] for e in m["end_to_end"]
               if "workloads" not in e or cell in e["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [p for p in m["per_layer"] if cell in p["workloads"]]
        assert layer
        assert all(p["moves"] in e2e for p in layer)


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.resolve(cell, ROOT)
    assert hasattr(c.driver, "Driver")
    assert callable(c.reference.make_weights)
    assert callable(c.reference.logits)
    assert callable(c.work.flops) and callable(c.port.build)
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert set(c.readers) == {p["name"] for p in c.per_layer}
    assert all(callable(r) for r in c.readers.values())


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_import_guard():
    files = sorted((ROOT / "perfbench").rglob("*.py"))
    assert files
    for path in files:
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
        assert "benchmarks" not in tops, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == [] or all(
        n.split(".")[0] in harness.FORBIDDEN
        for n in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert "jax.numpy" in harness.forbidden_modules()
    assert "repro_torch_like" not in harness.forbidden_modules()


def test_no_card_no_result(tmp_path):
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "swin_t.batch64",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_seeds_any_whole_number():
    for s in (0, 1, 2 ** 31 + 5, 2 ** 40, -3, 10 ** 30):
        v = harness.derive_seed(s, "weights")
        assert 0 <= v < 2 ** 63
    assert harness.derive_seed(5, "a") != harness.derive_seed(5, "b")
    assert math.isfinite(harness.derive_seed(7, "x"))
