"""On the card, at each cell's own size: a sound run's check passes and
the control (the reference one precision lower in the port's place)
fails it; and a directory holding the benchmark's files alone, without
the port, gives no result.

    python -m pytest -q -m cuda perfbench/tests/test_perfbench_card.py
"""
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, manifest
from perfbench import harness, trace

SEED = 2 ** 31 + 1009
CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = harness.resolve(name, ROOT)
    driver = harness.prepare(cell, SEED, card)
    driver.window(1.0, trace.Tracer(False))
    numbers, _s = harness.judge(cell, driver, SEED, card, control=True)
    assert all(numbers[k] <= lim for k, lim in cell.limits.items()), numbers
    assert any(numbers[f"control.{k}"] > lim
               for k, lim in cell.limits.items()), numbers


@pytest.mark.cuda
def test_no_result_without_the_port(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
