"""The traffic and the weights: the same seed gives the same inputs,
another seed other inputs; every seed gets the same work."""
import pytest
import torch

from conftest import tiny_cell
from perfbench import harness

CPU = torch.device("cpu")
SEEDS = (3, 2 ** 31 + 11)


def _env(cell, seed, system=None):
    return harness.Env(cell.config, cell.traffic, system, seed, CPU,
                       cell.reference)


@pytest.mark.parametrize("cell", ["swin_t.batch64", "deepseek_7b.prefill_mix"])
def test_weights_follow_the_seed(cell):
    c = tiny_cell(cell)
    a, b = (c.reference.make_weights(c.config, s, CPU, torch.bfloat16)
            for s in SEEDS)
    again = c.reference.make_weights(c.config, SEEDS[0], CPU, torch.bfloat16)

    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]

    la, lb, lc = leaves(a), leaves(b), leaves(again)
    assert all(torch.equal(x, y) for x, y in zip(la, lc))
    assert any(not torch.equal(x, y) for x, y in zip(la, lb))
    assert all(x.dtype == torch.bfloat16 for x in la)


def test_images_follow_the_seed():
    c = tiny_cell("swin_t.batch64")
    a, b = (c.reference.make_images(c.config, 2, 3, s, CPU, torch.bfloat16)
            for s in SEEDS)
    again = c.reference.make_images(c.config, 2, 3, SEEDS[0], CPU,
                                    torch.bfloat16)
    assert torch.equal(a, again) and not torch.equal(a, b)
    order = [harness.rng(s, "order").integers(4, size=20).tolist()
             for s in SEEDS]
    assert order[0] != order[1]


def test_prefill_plan_follows_the_seed():
    c = tiny_cell("deepseek_7b.prefill_mix")
    plans = []
    for s in SEEDS + SEEDS[:1]:
        d = c.driver.Driver(_env(c, s))
        plans.append(([d._plan(i) for i in range(9)], d.pool.clone()))
    assert plans[0][0] == plans[2][0]
    assert torch.equal(plans[0][1], plans[2][1])
    assert plans[0][0] != plans[1][0]
    # every cycle holds the same lengths, in its own order
    for plan, _pool in plans:
        for cyc in range(3):
            got = sorted(n for n, _o in plan[3 * cyc:3 * cyc + 3])
            assert got == [7, 12, 16]


def test_cycle_lengths_are_the_quantiles():
    from perfbench.drivers.prefill import cycle_lengths
    spec = {"median": 1500, "sigma": 0.7, "max": 4096}
    got = cycle_lengths(spec, 16)
    assert got == sorted(got) and len(got) == 16
    assert got[7] < 1500 < got[8]               # the median in the middle
    assert got[-1] == 4096 and got[-2] < 4096   # the top quantile clipped
    assert cycle_lengths({"median": 12, "sigma": 0.5, "max": 16}, 3) == [
        7, 12, 16]
