"""The readers of the port's own trace (``perfbench/program.py``) on the
CPU: a traced run of each cell at the small size reports the host spans'
metrics and, as nothing launches on the CPU, none of the launch counts;
a reader given no spans gives None; and the port's entry spans share the
harness's clock, each inside the ``bench.submit`` span around it."""
import sys
import time

import pytest
import torch

from conftest import tiny_cell
from perfbench import harness, program
from perfbench import trace as bench_trace
from repro_torch.core import trace

CPU = torch.device("cpu")
SEED = 2 ** 31 + 91
HOST = {"swin_t.batch64": ["host_ms.images", "wrapper_ms.images"],
        "deepseek_7b.prefill_mix": ["host_ms.prefill"]}
LAUNCHES = {"swin_t.batch64": ["launches.images", "masked_launches.images"],
            "deepseek_7b.prefill_mix": ["launches.prefill"]}


@pytest.mark.parametrize("name", list(HOST))
def test_traced_run_reports_the_host_spans(name, monkeypatch):
    # test_perfbench_faults.py plants a stub "jax" module that it leaves
    # behind; this run is not about that check
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    torch.set_num_threads(2)
    trace.take()
    res = harness.run_cell(tiny_cell(name), seed=SEED, seconds=0.5,
                           trace=True, device=CPU,
                           t_start=time.perf_counter())
    got = res["metrics"]
    for m in HOST[name]:
        assert got[m]["value"] > 0 and got[m]["unit"] == "ms", m
    if name == "swin_t.batch64":
        assert got["wrapper_ms.images"]["value"] <= got[
            "host_ms.images"]["value"]
    for m in LAUNCHES[name]:
        assert m not in got, m
    assert trace.take() == ([], {})


def _ctx(units, taken):
    ctx = harness.ReaderContext(window=None, traced_units=units, trace=None,
                                work=None, config={}, peak=None)
    ctx.__dict__[program.KEY] = taken
    return ctx


def test_readers_give_none_without_spans():
    for taken in (None, ([], {})):
        ctx = _ctx([{}] * 3, taken)
        for entry in ("vision.swin_forward", "lm.prefill"):
            assert program.host_ms(ctx, entry) is None
            assert program.wrapper_ms(ctx, entry) is None
            assert program.launches(ctx, entry) is None


def test_readers_on_hand_made_spans():
    S = trace.Span
    spans = [S("vision.swin_forward", 0, 10_000_000, -1, 1),
             S("kernel.rowwise_matmul", 1_000_000, 2_000_000, 0, 1),
             S("vision.stage", 2_000_000, 9_000_000, 0, 1),
             S("kernel.layernorm", 3_000_000, 3_500_000, 2, 1),
             S("vision.swin_forward", 20_000_000, 24_000_000, -1, 2),
             S("kernel.rowwise_matmul", 21_000_000, 22_000_000, 4, 2)]
    counters = {"launch.rowwise_matmul.wgmma": 2, "launch.layernorm.rows": 1,
                "launch.masked_operand": 1}
    ctx = _ctx([{}, {}], (spans, counters))
    entry = "vision.swin_forward"
    assert program.host_ms(ctx, entry) == pytest.approx(7.0)
    assert program.wrapper_ms(ctx, entry) == pytest.approx(1.25)
    assert program.launches(ctx, entry) == 1.5
    assert program.launches(ctx, entry, "launch.masked_operand") == 0.5
    # the entry calls must be the traced units, one for one
    assert program.host_ms(_ctx([{}] * 3, (spans, counters)), entry) is None
    assert program.host_ms(ctx, "lm.prefill") is None


def test_a_program_without_the_trace_gives_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    ctx = harness.ReaderContext(window=None, traced_units=[{}], trace=None,
                                work=None, config={}, peak=None)
    assert program.host_ms(ctx, "vision.swin_forward") is None
    assert program.launches(ctx, "lm.prefill") is None


def test_entry_spans_lie_inside_the_harness_submit_spans():
    """The port's spans and the harness's share ``time.time_ns()``: under
    the harness's CPU tracer each ``vision.swin_forward`` span lies inside
    the ``bench.submit`` span around it."""
    torch.set_num_threads(2)
    cell = tiny_cell("swin_t.batch64")
    driver = harness.prepare(cell, SEED, CPU)
    tracer = bench_trace.Tracer(True, 2, 3, CPU)
    tracer.warm()
    trace.take()
    driver.window(0.5, tracer)
    tracer.finish()
    spans, _ = trace.take()
    entries = [s for s in spans if s.name == "vision.swin_forward"]
    submits = [e for e in tracer.events if e.name == "bench.submit"]
    assert len(entries) == len(submits) == 3
    for s, e in zip(entries, submits):
        assert e.start <= s.start < s.end <= e.end
    driver.release()
