"""Worlds of tensor-parallel serving for ``tests/test_torch_tp*.py``.

Three roles, one file:

* ``serve(params, cfg, placement, job)`` runs the port's engine on a
  job (``tests/test_tp.py``'s trace: its prompts, 4 slots, max_len
  128, chunks of 32, 8 greedy tokens each; a job may add a fault plan
  and deadlines) and returns what the tests compare;
* ``python tests/torch_tp_harness.py rank R T STORE JOB OUT`` is one
  rank of a gloo world on the CPU, joined through a ``FileStore``: it
  serves the job under ``TensorParallel(T)`` and writes its result and
  its collective counts to ``OUT``. It imports nothing of JAX;
* ``python tests/torch_tp_harness.py oracle DIR JOBS`` runs JAX's
  ``TensorParallel`` engine on each job (it needs
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before
  JAX starts) and writes its completions, the parameter trees the port
  loads (numpy, pickled) and every prepared leaf's addressable shards.

:func:`run_world` starts T ranks and waits for them under a timeout:
a world that hangs is killed and fails its test. :func:`check_world`
and :func:`check_shards` hold a world and a rank's shard against the
single-device engine and the oracle.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [5, 37, 64, 12, 90, 23, 48, 7]      # tests/test_tp.py
# name: (arch, weight-only int8). The int8 tree dequantizes to the
# config's dtype, which the int8 model sets to fp32 on both packages: in
# bf16 each rank's partial sums round before the reduce, and JAX's own
# TP(4) engine then leaves its single-device greedy streams at near-ties
MODELS = {"deepseek": ("deepseek-7b", False),
          "gemma": ("gemma3-27b", False), "int8": ("deepseek-7b", True)}
WORLD_TIMEOUT_S = 120


def prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, size=(p,)).astype(np.int32)
            for p in PROMPTS]


def config(model, reduced):
    """The reduced config of ``model`` from ``reduced(arch)`` (either
    package's), fp32 for the int8 tree."""
    arch, int8 = MODELS[model]
    cfg = reduced(arch)
    return dataclasses.replace(cfg, dtype="float32") if int8 else cfg


def _result(eng, done):
    return {"completions": sorted(
                [c.rid, c.status, [int(t) for t in c.tokens]]
                for c in done),
            "stats": dict(eng.stats), "counts": eng.compile_counts()}


def serve(params, cfg, placement, job, **kw):
    """The port's engine on ``job`` (``model``, optional ``faults`` and
    ``deadlines`` {rid: seconds}) under ``placement``."""
    from repro_torch.core.types import PagingConfig
    from repro_torch.serve import faults
    from repro_torch.serve.engine import Engine, Request
    eng = Engine(params, cfg, n_slots=4, max_len=128, eos_id=-1,
                 temperature=0.0, paging=PagingConfig(prefill_chunk=32),
                 placement=placement,
                 faults=faults.parse_plan(job.get("faults", "")),
                 device="cpu", **kw)
    dls = {int(k): v for k, v in job.get("deadlines", {}).items()}
    for rid, p in enumerate(prompts(cfg.vocab)):
        eng.submit(Request(rid=rid, prompt=p, max_new=8,
                           deadline_s=dls.get(rid)))
    return _result(eng, eng.run())


def load_params(out_dir, model):
    """The port's tree of a model the oracle wrote, and its config."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import from_jax_params
    cfg = config(model, get_reduced)
    with open(Path(out_dir) / f"params_{model}.pkl", "rb") as f:
        tree = pickle.load(f)
    return from_jax_params(tree, cfg, device="cpu"), cfg


def run_world(tmp_path, out_dir, job, t):
    """Serve ``job`` in a world of ``t`` ranks: each rank's result."""
    tag = f"{job['name']}-t{t}"
    store = tmp_path / f"store-{tag}"
    job_file = tmp_path / f"job-{tag}.json"
    job_file.write_text(json.dumps({**job, "dir": str(out_dir)}))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    outs = [tmp_path / f"rank{i}-{tag}.json" for i in range(t)]
    logs = [open(tmp_path / f"rank{i}-{tag}.log", "w") for i in range(t)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "rank", str(i), str(t), str(store),
         str(job_file), str(outs[i])], env=env, stdout=logs[i],
        stderr=subprocess.STDOUT) for i in range(t)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        # a rank that fails stops the others at once
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [(i, p.returncode, (tmp_path / f"rank{i}-{tag}.log").read_text()
            [-3000:]) for i, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"world {tag} failed or hung: {bad}"
    return [json.loads(o.read_text()) for o in outs]


def _layers(cfg):
    return sum(st.repeat * len(st.body) for st in cfg.stages())


def check_world(out_dir, tmp_path, model, t):
    """A world of ``t`` ranks on ``model`` equals the single-device
    engine and JAX's TP engine, on every rank; each model call ran 2
    all-reduces a layer and, with an untied head, 1 gather."""
    from repro_torch.serve.placement import SingleDevice
    ranks = run_world(tmp_path, out_dir, {"name": model, "model": model}, t)
    params, cfg = load_params(out_dir, model)
    want = serve(params, cfg, SingleDevice(), {"model": model})
    jax_tp = json.loads((Path(out_dir) / f"jax_{model}_t{t}.json")
                        .read_text())
    for r in ranks:
        assert r["completions"] == want["completions"]
        assert r["completions"] == jax_tp["completions"]
        assert r["stats"] == want["stats"] == jax_tp["stats"]
        assert r["counts"] == want["counts"] == jax_tp["counts"]
        calls = sum(r["calls"].values())
        assert calls > 0
        assert r["reduce"] == 2 * _layers(cfg) * calls
        assert r["gather"] == (0 if cfg.tie_embeddings else calls)
    assert all(r == ranks[0] for r in ranks)


def check_shards(out_dir, model, t):
    """Rank i's prepared tree equals JAX's ``addressable_shards[i]`` of
    every leaf, bitwise (replicated leaves whole)."""
    from repro_torch.core import tree
    from repro_torch.serve.placement import shard_params
    params, cfg = load_params(out_dir, model)
    shards = np.load(Path(out_dir) / f"shards_{model}_t{t}.npz")
    n = 0
    for rank in range(t):
        got = shard_params(params, cfg, t, rank)
        for path, leaf in tree.leaves_with_paths(got):
            np.testing.assert_array_equal(leaf.numpy(),
                                          shards[f"{rank}|{path}"], path)
            n += 1
    assert n == len(shards.files)


def _rank(rank, t, store, job_file, out):
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import partitioning
    from repro_torch.serve import engine
    from repro_torch.serve.placement import TensorParallel

    torch.set_num_threads(1)
    job = json.loads(Path(job_file).read_text())
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, t), rank=rank, world_size=t,
        timeout=datetime.timedelta(seconds=60))
    params, cfg = load_params(job["dir"], job["model"])
    calls = {"admit": 0, "chunk": 0, "step": 0, "spec": 0}
    for name in calls:
        orig = getattr(engine.Engine, f"_{name}")

        def counted(self, *a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)
        setattr(engine.Engine, f"_{name}", counted)
    res = serve(params, cfg, TensorParallel(t, rank=rank, timeout_s=60),
                job)
    res["calls"] = calls
    res["reduce"] = partitioning.tp_reduce.launches
    res["gather"] = partitioning.tp_gather.launches
    dist.barrier()                   # no rank leaves while one still sends
    dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def _oracle(out_dir, jobs):
    import jax
    import jax.numpy as jnp

    from repro.configs import REDUCED
    from repro.core import quant
    from repro.core.types import PagingConfig
    from repro.models import lm
    from repro.serve.engine import Engine, Request
    from repro.serve.placement import TensorParallel

    out_dir = Path(out_dir)
    devs = jax.devices()
    for model in sorted({m for m, _ in jobs}):
        int8 = MODELS[model][1]
        cfg = config(model, lambda arch: REDUCED[arch]())
        params, _ = lm.init_lm(jax.random.PRNGKey(4 if int8 else 0), cfg,
                               dtype=jnp.float32)
        if int8:
            params = quant.quantize_tree(params, quant.lm_weight_predicate)
        with open(out_dir / f"params_{model}.pkl", "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
        for m, t in jobs:
            if m != model:
                continue
            place = TensorParallel(t)
            shards = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    place.prepare_params(params, cfg))[0]:
                key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                               for k in path)
                for s in leaf.addressable_shards:
                    shards[f"{devs.index(s.device)}|{key}"] = np.asarray(
                        s.data)
            np.savez(out_dir / f"shards_{model}_t{t}.npz", **shards)
            eng = Engine(params, cfg, n_slots=4, max_len=128, eos_id=-1,
                         temperature=0.0,
                         paging=PagingConfig(prefill_chunk=32),
                         placement=TensorParallel(t))
            for rid, p in enumerate(prompts(cfg.vocab)):
                eng.submit(Request(rid=rid, prompt=jnp.asarray(p),
                                   max_new=8))
            (out_dir / f"jax_{model}_t{t}.json").write_text(
                json.dumps(_result(eng, eng.run())))


def run_oracle(out_dir, jobs):
    """JAX's ``TensorParallel`` engine on ``jobs`` [(model, t)], in a
    process of its own with 8 host devices."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    out = subprocess.run(
        [sys.executable, __file__, "oracle", str(out_dir), json.dumps(jobs)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        _rank(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        _oracle(sys.argv[2], [tuple(j) for j in json.loads(sys.argv[3])])
