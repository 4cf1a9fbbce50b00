"""Tensor-parallel serving of the port (``serve/placement.py``,
``core/partitioning.py``) against the JAX package's, on the CPU.

Fast tests first: ``shard_perm``, ``validate`` and ``from_mesh_shape``
against JAX's (the same answers and messages), the engine refusing an
indivisible mesh, and a ``TensorParallel`` with no process group, at
construction; the traffic models against JAX's. Then worlds: the
reduced deepseek-7b served by the engine at t = 1, 2 and 4 ranks, each
a process of a gloo world on the CPU (``tests/torch_tp_harness.py``),
on ``tests/test_tp.py``'s trace; every rank's completions, ``stats``
and shape counts must equal the port's single-device engine's and
JAX's ``TensorParallel`` engine's (run once per module in a process of
its own with 8 host devices), and each rank's collectives are counted
per model call. Each rank's prepared shard equals JAX's
``addressable_shards`` of the same leaf, bitwise.
``tests/test_torch_tp_worlds.py`` holds the windowed, int8 and
deadline worlds.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch_tp_harness as harness

from repro.configs import REDUCED
from repro.core import block_traffic as jtraffic
from repro.serve import placement as jplacement
from repro_torch.configs import get_reduced
from repro_torch.core import block_traffic, partitioning
from repro_torch.serve import placement
from repro_torch.serve.engine import Engine

JOBS = [("deepseek", 1), ("deepseek", 2), ("deepseek", 4)]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_oracle")
    harness.run_oracle(out, JOBS)
    return out


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------------ fast


@pytest.mark.parametrize("widths,t", [((8, 4, 4), 2), ((6, 3, 3), 3),
                                      ((64, 16, 16), 4), ((172, 172), 2),
                                      ((172, 172), 4), ((256,), 4)])
def test_shard_perm_equals_jax(widths, t):
    np.testing.assert_array_equal(placement.shard_perm(widths, t),
                                  jplacement.shard_perm(widths, t))


def _err(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("arch,t", [("gemma3-27b", 4), ("gemma3-27b", 3),
                                    ("rwkv6-3b", 2), ("deepseek-7b", 3),
                                    ("zamba2-1.2b", 2)])
def test_validate_rejects_as_jax(arch, t):
    """The configs JAX's ``validate`` refuses, with its message."""
    want = _err(lambda: jplacement.TensorParallel(t).validate(
        REDUCED[arch]()))
    got = _err(lambda: placement.TensorParallel(t).validate(
        get_reduced(arch)))
    assert got == want
    assert "cannot shard" in got or "causal" in got


@pytest.mark.parametrize("arch,t", [("gemma3-27b", 2), ("deepseek-7b", 2),
                                    ("deepseek-7b", 4), ("deepseek-7b", 1)])
def test_validate_accepts_as_jax(arch, t):
    jplacement.TensorParallel(t).validate(REDUCED[arch]())
    placement.TensorParallel(t).validate(get_reduced(arch))


@pytest.mark.parametrize("spec", ["", "1", "model=1", "4", "model=2",
                                  " model = 3 "])
def test_from_mesh_shape_accepts_as_jax(spec):
    got, want = placement.from_mesh_shape(spec), \
        jplacement.from_mesh_shape(spec)
    assert type(got).__name__ == type(want).__name__
    assert got.n_shards == want.n_shards
    assert got.describe() == want.describe()


@pytest.mark.parametrize("spec", ["data=2", "banana", "0", "model=-1"])
def test_from_mesh_shape_rejects_as_jax(spec):
    assert _err(lambda: placement.from_mesh_shape(spec)) == _err(
        lambda: jplacement.from_mesh_shape(spec))


def _tiny_params(arch):
    from repro_torch.models import lm
    cfg = get_reduced(arch)
    return lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu",
                      dtype=torch.float32), cfg


def test_engine_rejects_at_construction():
    """An indivisible mesh is refused by ``validate`` before any group is
    touched; a divisible one with no process group refuses to run rather
    than serve on one device; a group of another size is refused."""
    params, cfg = _tiny_params("gemma3-27b")
    with pytest.raises(ValueError, match="cannot shard"):
        Engine(params, cfg, n_slots=2, max_len=64, eos_id=-1,
               placement=placement.TensorParallel(4), device="cpu")
    with pytest.raises(ValueError, match="needs a process group of 2"):
        Engine(params, cfg, n_slots=2, max_len=64, eos_id=-1,
               placement=placement.TensorParallel(2), device="cpu")


def test_hooks_are_inert_without_a_group():
    """Outside a TP call the hooks change nothing and launch nothing."""
    y = torch.randn(2, 3, 8)
    before = (partitioning.tp_reduce.launches,
              partitioning.tp_gather.launches)
    assert partitioning.tp_axis() is None
    assert partitioning.tp_reduce(y) is y and partitioning.tp_gather(y) is y
    assert (partitioning.tp_reduce.launches,
            partitioning.tp_gather.launches) == before
    assert placement.SingleDevice().wrap(len) is len


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_serve_tp_traffic_matches_jax(tp):
    """``tests/test_tp.py``'s trace: the KV, head, collective and step
    terms equal JAX's; the block weights are priced as the port's
    kernels read them (unpadded; JAX prices its TPU tile plan), and the
    shape of the model holds (monotone in tp, parts summing up)."""
    trace = [[16, 16, 16, 16]] * 10
    kw = dict(n_slots=4, max_len=128, page_size=16, tp=tp)
    got = block_traffic.serve_tp_traffic(trace, get_reduced("deepseek-7b"),
                                         **kw)
    want = jtraffic.serve_tp_traffic(trace, REDUCED["deepseek-7b"](), **kw)
    for key in ("kv_bytes", "lm_head_bytes", "allreduce_bytes", "tp",
                "steps"):
        assert got[key] == want[key], key
    cfg = get_reduced("deepseek-7b")
    blk = block_traffic.decode_weight_traffic_cfg(cfg, n_slots=4)
    assert got["weight_bytes"] == 2 * 10 * blk["weight_bytes"]
    assert got["per_device_bytes"] == (
        got["kv_bytes"] // tp + got["weight_bytes"] // tp
        + got["lm_head_bytes"] // tp + got["allreduce_bytes"])
    if tp > 1:
        half = block_traffic.serve_tp_traffic(
            trace, cfg, **{**kw, "tp": tp // 2})
        assert got["ratio"] > half["ratio"] and got["allreduce_bytes"] > 0


@pytest.mark.parametrize("gated,prefused", [(True, True), (False, True),
                                            (True, False)])
def test_decode_weight_traffic_matches_jax_where_nothing_pads(gated,
                                                              prefused):
    """At widths the TPU tile plan pads nothing (multiples of 128, one K
    panel), the port's weight bytes of every matmul equal JAX's (its
    totals differ: the tile plan fetches x once per N tile)."""
    cfg = dataclasses.replace(
        REDUCED["deepseek-7b"](), d_model=512, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=1024, act="silu" if gated else "gelu")
    got = block_traffic.decode_weight_traffic_cfg(cfg, n_slots=16,
                                                  prefused=prefused)
    want = jtraffic.decode_weight_traffic_cfg(cfg, n_slots=16,
                                              prefused=prefused)
    assert [(n, w) for n, _, w in got["ops"]] == [
        (n, w) for n, _, w in want["ops"]]
    assert got["weight_bytes"] == want["weight_bytes"]


# ---------------------------------------------------------------- worlds


@pytest.mark.parametrize("t", [1, 2, 4])
def test_tp_parity_deepseek(oracle, tmp_path, t):
    harness.check_world(oracle, tmp_path, "deepseek", t)


@pytest.mark.parametrize("t", [2, 4])
def test_tp_shards_deepseek(oracle, t):
    harness.check_shards(oracle, "deepseek", t)
