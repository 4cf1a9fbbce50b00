"""On the card, at the granite cell's own size: a sound window passes the
check and the control (the reference in fp8 in the port's place) fails
it; and the routing of the checked batches against the reference's,
(token, choice) pair by pair, printed for the record.

    python -m pytest -q -s -m cuda perfbench/tests/test_perfbench_granite_card.py
"""
import pytest

from conftest import ROOT
from perfbench import harness, trace

CELL = "granite_4_h_small.prefill_mix_b8"
SEED = 2 ** 31 + 2027


def _recorder(fn, picks):
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        picks.append(out[1].reshape(-1, out[1].shape[-1]).cpu())
        return out
    return call


@pytest.mark.cuda
def test_control_fails_and_routing_flips_are_few(card, monkeypatch):
    from repro_torch.core import trace as program_trace
    from repro_torch.models import moe
    cell = harness.resolve(CELL, ROOT)
    driver = harness.prepare(cell, SEED, card)
    driver.window(1.0, trace.Tracer(False))
    # the port's picks on the batches the check samples, layer by layer
    port = []
    monkeypatch.setattr(moe, "_route", _recorder(moe._route, port))
    with program_trace.recording():
        program_trace.take()
        for i in driver._sample():
            n, off, _host = driver.answers[i]
            driver._forward(n, off).cpu()
        _spans, counters = program_trace.take()
    monkeypatch.undo()
    print(f"\ncounters of the checked batches: {counters}")
    # dropless: every routed pair whose expert is held here is computed
    assert counters["moe.rows_held"] == sum(
        int((p < cell.config["num_local_experts"]).sum()) for p in port)
    layers = len(cell.config["layer_types"])
    assert len(port) == layers * len(driver._sample())
    # the reference's picks, in its fp32 pass (the check's), then the
    # control's pass, which is not compared
    ref = []
    monkeypatch.setattr(cell.reference, "route",
                        _recorder(cell.reference.route, ref))
    numbers, _s = harness.judge(cell, driver, SEED, card, control=True)
    flipped = pairs = 0
    for a, b in zip(port, ref[:len(port)]):
        same = (a[:, :, None] == b[:, None, :]).any(-1)
        flipped += int((~same).sum())
        pairs += a.numel()
    print(f"routing: {flipped} of {pairs} (token, choice) pairs differ "
          f"({100 * flipped / pairs:.4f}%) over {len(port)} layer calls; "
          f"checks {numbers}")
    assert all(numbers[k] <= lim for k, lim in cell.limits.items()), numbers
    assert any(numbers[f"control.{k}"] > lim
               for k, lim in cell.limits.items()), numbers
    assert flipped < 0.05 * pairs
