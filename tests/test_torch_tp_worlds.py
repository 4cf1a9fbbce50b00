"""Tensor-parallel serving worlds of the port beyond the dense trace of
``tests/test_torch_tp.py``, on the CPU (gloo worlds, one process a
rank, ``tests/torch_tp_harness.py``):

* gemma3-smoke at t = 2: sliding-window ring pages split by KV head, a
  GeGLU panel and a tied (replicated) head;
* the weight-only int8 deepseek-7b tree at t = 4: int8 scales split
  with column shards and replicated with row shards;
* agreement on host decisions: a request whose deadline expires
  mid-run (a fault plan's slow tick outlasts it) ends as ``deadline``
  on every rank, the others as on one device, and no rank hangs.

Each world equals the port's single-device engine and JAX's
``TensorParallel`` engine on every rank, and each rank's prepared shard
equals JAX's ``addressable_shards``.
"""
import pytest
import torch
import torch_tp_harness as harness

from repro_torch.serve import placement

JOBS = [("gemma", 2), ("int8", 4)]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_oracle")
    harness.run_oracle(out, JOBS + [("deepseek", 2)])
    return out


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("model,t", JOBS)
def test_tp_parity(oracle, tmp_path, model, t):
    harness.check_world(oracle, tmp_path, model, t)


@pytest.mark.parametrize("model,t", JOBS)
def test_tp_shards(oracle, model, t):
    harness.check_shards(oracle, model, t)


def test_tp_ranks_agree_on_a_deadline(oracle, tmp_path):
    """rid 0 (decoding from the first tick) and rid 5 (queued) must
    finish in 1 s; clock 2's slow tick sleeps 1.5 s on every rank, so
    both end as ``deadline`` wherever the sweep finds them, and every
    rank must agree on where: one clock (rank 0's) decides. The other
    requests end as on one device."""
    job = {"name": "deadline", "model": "deepseek", "faults": "slow@2:1.5",
           "deadlines": {"0": 1.0, "5": 1.0}}
    ranks = harness.run_world(tmp_path, oracle, job, 2)
    assert ranks[0]["completions"] == ranks[1]["completions"]
    assert ranks[0]["stats"] == ranks[1]["stats"]
    params, cfg = harness.load_params(oracle, "deepseek")
    want = harness.serve(params, cfg, placement.SingleDevice(),
                         {"model": "deepseek"})
    for got, ref in zip(ranks[0]["completions"], want["completions"]):
        if got[0] in (0, 5):
            assert got[1] == "deadline" and len(got[2]) < 8
        else:
            assert got == ref
