"""A run of each cell, with the look for a card skipped, at a small size
on the CPU: sound, it comes out correct; with its timed path broken
underneath, once a fault the cell can have, it does not; and the
control (the reference one precision lower in the port's place) fails
the check too. The port's plain path and the reference agree in fp32."""
import sys
import time
import types

import pytest
import torch

from conftest import tiny_cell
from perfbench import harness

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
CELLS = ["swin_t.batch64", "deepseek_7b.prefill_mix"]


def half_batch(call):
    """Half of the batch left out: the first half's rows stand for it."""
    def fn(x):
        half = call(x[:x.shape[0] // 2])
        return torch.cat([half, half])
    return fn


def alter_answer(call):
    """An answer altered where it is produced: every call's first row."""
    def fn(x):
        out = call(x).clone()
        out[0, 0] += 1.0 + out[0].abs().max()
        return out
    return fn


PLANTS = {
    ("swin_t.batch64", "half_batch"): ("classify", half_batch),
    ("swin_t.batch64", "alter_answer"): ("classify", alter_answer),
    ("deepseek_7b.prefill_mix", "half_batch"): ("prefill", half_batch),
    ("deepseek_7b.prefill_mix", "alter_answer"): ("prefill", alter_answer),
}
FAULTS = list(PLANTS)


def planted(cell, fault):
    """``cell`` with the port's timed path broken underneath by ``fault``."""
    method, plant = PLANTS[(cell.name, fault)]
    build = cell.port.build

    def faulty_build(config, weights, device):
        system = build(config, weights, device)
        setattr(system, method, plant(getattr(system, method)))
        return system

    cell.port = types.SimpleNamespace(build=faulty_build)
    return cell


def run(cell, trace=False):
    torch.set_num_threads(2)
    return harness.run_cell(cell, seed=SEED, seconds=0.5, trace=trace,
                            device=CPU, t_start=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert all(m in res["metrics"] for m in ("setup_s",))


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_window(name):
    res = run(tiny_cell(name), trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res and res["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault):
    res = run(planted(tiny_cell(name), fault))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_jax_loaded_by_the_check_gives_no_result(name, monkeypatch):
    """A module of JAX that any step after the window loads (here the
    check itself) is caught: the run gives no result."""
    cell = tiny_cell(name)
    make = cell.driver.Driver

    class Driver(make):
        def check(self, reference, weights):
            sys.modules["jax"] = types.ModuleType("jax")
            return super().check(reference, weights)

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    cell.driver = types.SimpleNamespace(Driver=Driver)
    with pytest.raises(harness.HarnessError, match="jax"):
        run(cell)
    assert "jax" in sys.modules


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    torch.set_num_threads(2)
    driver = harness.prepare(cell, SEED, CPU)
    from perfbench import trace
    driver.window(0.3, trace.Tracer(False))
    numbers, _s = harness.judge(cell, driver, SEED, CPU, control=True)
    for key, limit in cell.limits.items():
        assert numbers[key] <= limit
    assert any(numbers[f"control.{k}"] > lim
               for k, lim in cell.limits.items()), numbers


@pytest.mark.parametrize("name", ["swin_t.batch64", "deepseek_7b.prefill_mix"])
def test_reference_agrees_with_the_port_in_fp32(name):
    cell = tiny_cell(name, dtype="float32")
    cfg = cell.config
    w = cell.reference.make_weights(cfg, SEED, CPU, torch.float32)
    system = cell.port.build(cfg, w, CPU)
    if name.startswith("swin"):
        x = cell.reference.make_images(cfg, 1, 3, SEED, CPU, torch.float32)[0]
        got, want = system.classify(x), cell.reference.logits(w, cfg, x)
    else:
        toks = torch.randint(0, cfg["vocab_size"], (2, 40),
                             generator=torch.Generator().manual_seed(1))
        got = system.prefill(toks)
        want = cell.reference.logits(w, cfg, toks,
                                     torch.full((2, 1), 39))[:, 0]
    assert float((got - want).norm() / want.norm()) < 1e-5
