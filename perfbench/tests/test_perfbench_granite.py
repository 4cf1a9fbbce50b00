"""The granite cell on the CPU, at a small size of its own: it resolves
with its eight metrics; a sound run comes out correct and a traced one
reads the program's spans and counters; a half batch, an altered answer
and the control (the reference in fp8) read ``correct`` false; and the
work file's counts match a hand count."""
import sys
import time
import types

import pytest
import torch

from conftest import ROOT
from perfbench import harness
from repro_torch.core import trace

CELL = "granite_4_h_small.prefill_mix_b8"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 313
# the configuration at a small size: widths, depth (two periods of four),
# experts (4 of 8 held), vocabulary and lengths cut; every key kept
TINY = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 32,
        "shared_intermediate_size": 48, "num_attention_heads": 4,
        "num_key_value_heads": 2, "mamba_n_heads": 8, "mamba_d_head": 16,
        "mamba_d_state": 16, "mamba_chunk_size": 8, "num_local_experts": 4,
        "router_experts": 8, "held_experts": [0, 4],
        "num_experts_per_tok": 3, "num_hidden_layers": 8,
        "layer_types": ["mamba", "mamba", "attention", "mamba"] * 2}
TRAFFIC = {"batch": 4, "prompt_len": {"median": 12, "sigma": 0.5, "max": 16},
           "cycle_batches": 3, "trace": {"skip_units": 3, "units": 3}}
METRICS = {"mfu.granite", "matmul_roofline.granite", "idle_share.granite",
           "host_ms.granite", "launches.granite", "moe_host_ms.granite",
           "scan_host_ms.granite", "expert_calls.granite"}


@pytest.fixture(autouse=True)
def no_stub_jax(monkeypatch):
    """test_perfbench_faults.py leaves a stub ``jax`` module behind, which
    the harness's last check would find in a run in the same process."""
    monkeypatch.delitem(sys.modules, "jax", raising=False)


def tiny(**config):
    files = harness.HERE
    cfg = {**harness.load_json(files / "configs" / "granite_4_h_small.json"),
           **TINY, **config}
    traffic = {**harness.load_json(files / "traffic" / "prefill_mix_b8.json"),
               **TRAFFIC}
    return harness.resolve(CELL, ROOT, config=cfg, traffic=traffic)


def run(cell, trace_on=False):
    torch.set_num_threads(2)
    return harness.run_cell(cell, seed=SEED, seconds=0.5, trace=trace_on,
                            device=CPU, t_start=time.perf_counter())


def test_cell_resolves_with_its_metrics():
    cell = harness.resolve(CELL, ROOT)
    assert set(cell.readers) == METRICS
    assert [m["name"] for m in cell.end_to_end] == ["prefill_tokens_per_s",
                                                     "setup_s"]
    assert cell.config["reduced"] == ["num_local_experts"]
    assert cell.config["num_local_experts"] == 36
    assert cell.config["router_experts"] == 72
    assert cell.traffic["batch"] == 8 and cell.chips == 1


def test_sound_run_is_correct():
    res = run(tiny())
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"prefill_tokens_per_s", "setup_s"}


def test_traced_run_reads_the_program():
    trace.take()
    res = run(tiny(), trace_on=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    for m in ("host_ms.granite", "moe_host_ms.granite",
              "scan_host_ms.granite"):
        assert got[m]["value"] > 0 and got[m]["unit"] == "ms", m
    assert got["moe_host_ms.granite"]["value"] < got[
        "host_ms.granite"]["value"]
    # 8 layers, each of the 4 held experts with rows: 2 calls each
    assert got["expert_calls.granite"]["value"] <= 2 * 8 * 4
    assert got["expert_calls.granite"]["value"] > 2 * 8 * 2
    # nothing launches on the CPU
    assert "launches.granite" not in got
    assert trace.take() == ([], {})


def half_batch(call):
    def fn(x):
        half = call(x[:x.shape[0] // 2])
        return torch.cat([half, half])
    return fn


def alter_answer(call):
    def fn(x):
        out = call(x).clone()
        out[0, 0] += 1.0 + out[0].abs().max()
        return out
    return fn


@pytest.mark.parametrize("plant", [half_batch, alter_answer])
def test_fault_is_not_correct(plant):
    cell = tiny()
    build = cell.port.build

    def faulty(config, weights, device):
        system = build(config, weights, device)
        system.prefill = plant(system.prefill)
        return system

    cell.port = types.SimpleNamespace(build=faulty)
    res = run(cell)
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    cell = tiny()
    torch.set_num_threads(2)
    driver = harness.prepare(cell, SEED, CPU)
    from perfbench import trace as bench_trace
    driver.window(0.3, bench_trace.Tracer(False))
    numbers, _s = harness.judge(cell, driver, SEED, CPU, control=True)
    for key, limit in cell.limits.items():
        assert numbers[key] <= limit
    assert any(numbers[f"control.{k}"] > lim
               for k, lim in cell.limits.items()), numbers


def test_work_hand_count():
    work = harness.load_module(harness.HERE / "work" / "granite_4_h_small.py")
    full = harness.load_json(harness.HERE / "configs" /
                             "granite_4_h_small.json")
    cfg = {**full, "hidden_size": 8, "intermediate_size": 4,
           "shared_intermediate_size": 6, "num_attention_heads": 2,
           "num_key_value_heads": 1, "mamba_expand": 2, "mamba_n_heads": 4,
           "mamba_d_head": 4, "mamba_d_state": 3, "vocab_size": 10,
           "router_experts": 8, "num_local_experts": 4,
           "num_experts_per_tok": 2,
           "layer_types": ["mamba", "attention", "mamba"]}
    b, s = 2, 6
    m = b * s                                   # 12 rows
    rows = m * 2 / 8                            # 3 a held expert
    mamba = 2 * m * (8 * (16 + 16 + 6 + 4) + 16 * 8)   # in (z x B C dt), out
    attn = 2 * m * (8 * 16 + 8 * 8)                 # q k v (hd 4), o
    experts = 4 * 2 * rows * (8 * 8 + 4 * 8)        # 4 held, gate|up, down
    shared = 2 * m * (8 * 12 + 6 * 8)
    router = 2 * m * 8 * 8
    causal = 4 * b * 2 * 4 * 21                     # 21 pairs of 6
    ssd = 4 * 4 * 4 * 3 * m
    head = 2 * b * 8 * 10
    want = (2 * (mamba + ssd) + attn + causal
            + 3 * (experts + shared + router) + head)
    unit = {"kind": "prefill", "batch": b, "seq": s}
    assert work.flops(unit, cfg) == pytest.approx(want, rel=1e-12)
    peak, bw = 1e12, 1e9
    least = work.matmul_least_s(unit, cfg, peak, bw)
    # at this bandwidth every call is bound by its bytes
    nbytes = 2 * sum(mm * k + k * n + mm * n
                     for mm, k, n in work.projections(cfg, m)
                     + [(b, 8, 10)])
    assert least == pytest.approx(nbytes / bw, rel=1e-12)
    # the published widths: ~13.0 GFLOP a token in the projections
    per_token = sum(2 * mm * k * n for mm, k, n in
                    work.projections(full, 1.0))
    assert per_token == pytest.approx(13.0e9, rel=0.01)
