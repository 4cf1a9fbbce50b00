"""Worlds of the training mesh for ``tests/test_torch_mesh_worlds.py``.

Three roles, one file:

* :func:`write_inputs` writes what every rank loads: the JAX
  initializer's parameter trees of the reduced configs (numpy, norm
  gains jittered), the batches and the MoE input, all from numpy seeds;
* ``python tests/torch_mesh_harness.py rank R STORE DIR`` is one rank of
  an 8-rank gloo world on the CPU, joined through a ``FileStore``, on
  the (pod=2, data=2, model=2) mesh. It runs every scenario of
  :data:`SCENARIOS` in turn and writes its results (global trees
  gathered from the blocks, logits, collective counts) to
  ``DIR/rank<R>.pkl``. It imports nothing of JAX;
* ``python tests/torch_mesh_harness.py jax_ep DIR`` runs JAX's
  ``moe._apply_ep`` on the dropping MoE case with 8 host devices (it
  sets ``XLA_FLAGS`` before JAX starts) and writes its output.

:func:`start_world` starts the ranks (and the JAX subprocess beside
them), so that the caller computes its oracles while they run;
:func:`wait_world` waits under :data:`WORLD_TIMEOUT_S`: a world that
hangs is killed and fails its tests.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
MESH = (2, 2, 2)
WORLD_TIMEOUT_S = 240
# the sharded step's archs (reduced, fp32), B=4 so that ``batch`` drops
# ``model``: the two model ranks of a pod and data position hold the
# same row
FSDP_ARCHS = ("deepseek-7b", "zamba2-1.2b", "rwkv6-3b", "qwen2-vl-2b")
FSDP_BATCH = (4, 32)
STEPS = 3
LR = 1e-3
# the compressed step: deepseek-7b reduced at B=8 x 16 (JAX's scenario)
COMP_BATCH = (8, 16)
COMP_STEPS = 2
# the MoE: phi3.5-moe reduced (4 experts, top 2), x (8, 16, d): one row
# a rank; capacity factor 4 (no drop) and 0.5 (drops)
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_X = (8, 16)
DROP_FACTOR = 0.5
# the sequence-sharded decode: deepseek-7b reduced, B=2, a 12-token
# prefill then 6 steps into a cache of 32 positions (JAX's scenario)
DEC_B, DEC_PROMPT, DEC_STEPS, DEC_ALLOC = 2, 12, 6, 32
SCENARIOS = ("fsdp", "compress", "moe", "decode", "elastic")


def tcfg_kw():
    return dict(warmup_steps=1, total_steps=10)


def _jitter(tree, seed):
    """Norm gains and biases (constant at init) spread by 0.1."""
    import jax
    rng = np.random.default_rng(seed)

    def jit(path, leaf):
        a = np.asarray(leaf)
        if getattr(path[-1], "key", None) in ("g", "b"):
            return a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(jit, tree)


def lm_batch(cfg, seed, b, s):
    """Tokens and labels; a vision arch's 6 patch rows (labels -1) with
    (t, h, w) positions (3, B, S), as ``tests/test_torch_train.py``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": labels}
    if cfg.frontend == "vision":
        n = 6
        batch["vis_embeds"] = rng.standard_normal(
            (b, n, cfg.d_model)).astype(np.float32)
        p3 = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                             (3, b, s)).copy()
        p3[0, :, :n] = 0
        p3[1, :, :n] = np.arange(n) // 3
        p3[2, :, :n] = np.arange(n) % 3
        p3[:, 1, n:] += 5                 # rows differ in their positions
        batch["positions3"] = p3
        labels[:, :n] = -1
    return batch


def write_inputs(out_dir):
    """The parameter trees, batches and MoE inputs every rank loads."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced
    from repro.models import lm, moe
    out = {"params": {}, "batch": {}}
    for i, arch in enumerate(FSDP_ARCHS):
        cfg = get_reduced(arch)
        params, _ = lm.init_lm(jax.random.PRNGKey(i), cfg, dtype=jnp.float32)
        out["params"][arch] = _jitter(
            jax.tree_util.tree_map(np.asarray, params), i + 10)
        out["batch"][arch] = lm_batch(cfg, i, *FSDP_BATCH)
    out["batch"]["compress"] = lm_batch(get_reduced("deepseek-7b"), 20,
                                        *COMP_BATCH)
    cfg = get_reduced(MOE_ARCH)
    mp, _ = moe.init(jax.random.PRNGKey(3), cfg, stack=None,
                     dtype=jnp.float32)
    rng = np.random.default_rng(4)
    out["moe"] = {"params": jax.tree_util.tree_map(np.asarray, mp),
                  "x": rng.standard_normal(MOE_X + (cfg.d_model,))
                  .astype(np.float32),
                  "w": rng.standard_normal(MOE_X + (cfg.d_model,))
                  .astype(np.float32)}
    dcfg = get_reduced("deepseek-7b")
    dp, _ = lm.init_lm(jax.random.PRNGKey(5), dcfg, dtype=jnp.float32)
    out["decode"] = {"params": jax.tree_util.tree_map(np.asarray, dp),
                     "tokens": rng.integers(
                         0, dcfg.vocab, (DEC_B, DEC_PROMPT + DEC_STEPS))
                     .astype(np.int32)}
    with open(Path(out_dir) / "inputs.pkl", "wb") as f:
        pickle.dump(out, f)
    return out


def drop_cfg(cfg):
    """``cfg`` with the MoE capacity factor that drops tokens."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DROP_FACTOR))


# ----------------------------------------------------------------------
# One rank
# ----------------------------------------------------------------------


def _torch_batch(batch):
    import torch
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        out[k] = out[k].long()
    return out


def _np(tree):
    from repro_torch.core import tree as tree_lib
    return tree_lib.tree_map(lambda t: t.detach().numpy().copy(), tree)


def _fsdp(inputs, mesh, rank, res):
    from repro_torch.configs import get_reduced
    from repro_torch.convert import from_jax_params
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.optim import adamw
    from repro_torch.train import step as tsl
    for arch in FSDP_ARCHS:
        cfg = get_reduced(arch)
        params = from_jax_params(inputs["params"][arch], cfg, device="cpu")
        tcfg = tsl.TrainConfig(opt=adamw.AdamWConfig(lr=LR), **tcfg_kw())
        step = tsl.make_train_step(cfg, tcfg, mesh=mesh)
        sh = tsl.state_shardings(cfg, tcfg, mesh)
        state = tsl.shard_state(tsl.init_state(params, tcfg), sh)
        batch = _torch_batch(inputs["batch"][arch])
        grads, _ = step.grads_and_metrics(state, batch)
        grads = part.gather_tree(grads, sh.params)
        losses, counts = [], []
        for _ in range(STEPS):
            part.reset_counts()
            state, m = step(state, batch)
            counts.append(part.counts())
            losses.append(float(m["loss"]))
        out = {"losses": losses, "counts": counts,
               "local_shapes": [tuple(t.shape) for t in
                                tree_lib.leaves(state.params)]}
        full = part.gather_tree(state, sh)
        if rank == 0:
            out["grads0"] = _np(grads)
            out["params"] = _np(full.params)
        res["fsdp", arch] = out
        if arch == "deepseek-7b":
            res["_state"] = (cfg, tcfg, state, sh)


def _compress(inputs, mesh, rank, res):
    from repro_torch.configs import get_reduced
    from repro_torch.convert import from_jax_params
    from repro_torch.core import partitioning as part
    from repro_torch.optim import adamw
    from repro_torch.train import step as tsl
    cfg = get_reduced("deepseek-7b")
    params = from_jax_params(inputs["params"]["deepseek-7b"], cfg,
                             device="cpu")
    batch = _torch_batch(inputs["batch"]["compress"])
    for name, comp in (("compress", True), ("exact", False)):
        tcfg = tsl.TrainConfig(opt=adamw.AdamWConfig(lr=LR),
                               compress_pods=comp, **tcfg_kw())
        step = tsl.make_train_step(cfg, tcfg, mesh=mesh)
        sh = tsl.state_shardings(cfg, tcfg, mesh)
        state = tsl.shard_state(tsl.init_state(params, tcfg), sh)
        losses = []
        for _ in range(COMP_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        full = part.gather_tree(state, sh)
        out = {"losses": losses}
        if mesh.coord("data") == 0 and mesh.coord("model") == 0:
            out["params"] = _np(full.params)
            if comp:
                out["residual"] = _np(full.residual)
        res[name] = out


def _int8_sum(mesh, res):
    """The int32 sum of two pods' int8 payloads, against the payloads."""
    import torch

    from repro_torch.core import partitioning as part
    from repro_torch.optim import compression
    g = torch.randn(64, 32, generator=torch.Generator().manual_seed(
        mesh.coord("pod")))
    q, _ = compression._quantize(g)
    pods = mesh.group(("pod",))
    total = compression.int8_sum(q, pods)
    every = torch.empty((2,) + tuple(q.shape), dtype=torch.int8)
    part.all_gather(every.view(-1, q.shape[1]), q, pods)
    res["int8_sum_exact"] = bool(torch.equal(
        total, every.to(torch.int32).sum(0)))


def _moe(inputs, mesh, rank, res):
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import partitioning as part
    from repro_torch.models import moe
    cfg = get_reduced(MOE_ARCH)
    params = {k: torch.from_numpy(v) for k, v in
              inputs["moe"]["params"].items()}
    x = torch.from_numpy(inputs["moe"]["x"])[rank:rank + 1]
    w = torch.from_numpy(inputs["moe"]["w"])[rank:rank + 1]
    out = {}
    with part.use_mesh(mesh), part.batch_split(("pod", "data", "model")):
        part.reset_counts()
        y, aux = moe.apply(params, x, cfg=cfg)
        out["a2a_forward"] = part.counts()["all_to_all"]
        out["y"], out["aux"] = y.numpy(), float(aux)
        y2, aux2 = moe.apply(params, x, cfg=drop_cfg(cfg))
        out["y_drop"], out["aux_drop"] = y2.numpy(), float(aux2)
        # the gradient through both all-to-alls: every rank's loss over
        # its row, the gradients summed over the world
        leaves = {k: v.clone().requires_grad_(True) for k, v in
                  params.items()}
        xg = x.clone().requires_grad_(True)
        yg, auxg = moe.apply(leaves, xg, cfg=cfg)
        loss = (yg * w).sum() + auxg
        grads = torch.autograd.grad(loss, list(leaves.values()) + [xg])
    world = mesh.group(mesh.axis_names)
    summed = {}
    for k, g in zip(leaves, grads[:-1]):
        summed[k] = part.all_reduce(g.clone(), world).numpy()
    out["grads"] = summed
    out["x_grad"] = grads[-1].numpy()
    res["moe"] = out


def _decode(inputs, mesh, rank, res):
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.convert import from_jax_params
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.models import lm
    cfg = get_reduced("deepseek-7b")
    params = from_jax_params(inputs["decode"]["params"], cfg, device="cpu")
    tokens = torch.from_numpy(inputs["decode"]["tokens"]).long()
    rules = {"kv_seq": "model", "decode_attn": "sharded"}
    with part.use_mesh(mesh, rules):
        b_spec = part.resolve(("batch",), shape=(DEC_B,))
        axes = part.spec_axes(b_spec[0])
        row = mesh.coord("pod") if axes == ("pod",) else None
        mine = tokens[row:row + 1]
        with torch.no_grad():
            _, cache = lm.prefill(params, mine[:, :DEC_PROMPT], cfg,
                                  alloc=DEC_ALLOC)
        # the cache's shardings at its global shape (B = DEC_B)
        like = lm.init_cache(cfg, DEC_B, DEC_ALLOC, dtype=torch.float32,
                             device="meta")
        sh = part.tree_shardings(mesh, lm.cache_logical_specs(like, cfg),
                                 like=like)
        # the rows are already this rank's: cut the positions alone
        local = tree_lib.tree_map(
            lambda t, s: part.shard_leaf(t, part.Sharding(
                mesh, (None, None) + s.spec[2:], s.names)), cache, sh)
        lengths = torch.full((1,), DEC_PROMPT, dtype=torch.int32)
        logits = []
        part.reset_counts()
        with torch.no_grad():
            for t in range(DEC_PROMPT, DEC_PROMPT + DEC_STEPS):
                lg, local = lm.decode_step(params, local,
                                           mine[:, t:t + 1], lengths, cfg)
                logits.append(lg.numpy())
                lengths = lengths + 1
    res["decode"] = {"row": row, "logits": np.stack(logits, 1),
                     "batch_axes": axes,
                     "cache_rows": int(local[0]["0"]["kv"].k.shape[2]),
                     "counts": part.counts()}


def _elastic(tmp, mesh, rank, res):
    """The deepseek-7b state of :func:`_fsdp` saved from (2,2,2) and
    restored onto (4,2) (data, model), then gathered whole."""
    from repro_torch.checkpoint import checkpointer as ckpt
    from repro_torch.core import partitioning as part
    from repro_torch.core import tree as tree_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import step as tsl
    cfg, tcfg, state, sh = res.pop("_state")
    d = str(Path(tmp) / "elastic")
    ckpt.save(d, 7, state, extra={"data_step": 7}, shardings=sh)
    mesh_b = make_host_mesh((4, 2), ("data", "model"))
    sh_b = tsl.state_shardings(cfg, tcfg, mesh_b)
    restored, extra = ckpt.restore(d, 7, state, device="cpu",
                                   shardings=sh_b)
    full_a = part.gather_tree(state, sh)
    full_b = part.gather_tree(restored, sh_b)
    out = {"extra": extra, "dir": d,
           "shapes_b": [tuple(t.shape) for t in tree_lib.leaves(restored)]}
    if rank == 0:
        out["saved"] = _np(full_a)
        out["restored"] = _np(full_b)
    res["elastic"] = out


def _rank(rank, store, out_dir):
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    mesh = make_host_mesh(MESH)
    with open(Path(out_dir) / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    res = {}
    t0 = time.perf_counter()
    _fsdp(inputs, mesh, rank, res)
    _compress(inputs, mesh, rank, res)
    _int8_sum(mesh, res)
    _moe(inputs, mesh, rank, res)
    _decode(inputs, mesh, rank, res)
    _elastic(out_dir, mesh, rank, res)
    res["seconds"] = time.perf_counter() - t0
    dist.barrier()                   # no rank leaves while one still sends
    dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _jax_ep(out_dir):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced
    from repro.core import partitioning
    from repro.models import moe
    with open(Path(out_dir) / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)["moe"]
    cfg = drop_cfg(get_reduced(MOE_ARCH))
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    mesh = jax.make_mesh(MESH, ("pod", "data", "model"))
    with partitioning.use_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe.apply(p, x, cfg=cfg))(
            params, jnp.asarray(inputs["x"]))
    with open(Path(out_dir) / "jax_ep.pkl", "wb") as f:
        pickle.dump({"y": np.asarray(y), "aux": float(aux)}, f)


def start_world(out_dir):
    """Start the eight ranks and JAX's expert-parallel oracle beside
    them; :func:`wait_world` collects them."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    store = Path(out_dir) / "store"
    names = [f"rank{i}" for i in range(WORLD)] + ["jax_ep"]
    logs = [open(Path(out_dir) / f"{n}.log", "w") for n in names]
    argvs = [["rank", str(i), str(store), str(out_dir)]
             for i in range(WORLD)] + [["jax_ep", str(out_dir)]]
    procs = [subprocess.Popen([sys.executable, __file__, *a], env=env,
                              stdout=log, stderr=subprocess.STDOUT)
             for a, log in zip(argvs, logs)]
    return {"dir": Path(out_dir), "procs": procs, "logs": logs,
            "names": names, "deadline": time.monotonic() + WORLD_TIMEOUT_S}


def wait_world(world):
    """Every rank's results and JAX's oracle's, once all exit 0 (a rank
    that fails stops the others at once; a world that hangs past
    :data:`WORLD_TIMEOUT_S` is killed)."""
    procs, out_dir = world["procs"], world["dir"]
    try:
        while (time.monotonic() < world["deadline"]
               and any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in world["logs"]:
            log.close()
    bad = [(n, p.returncode, (out_dir / f"{n}.log").read_text()[-3000:])
           for n, p in zip(world["names"], procs) if p.returncode != 0]
    assert not bad, f"the mesh world failed or hung: {bad}"
    out = []
    for i in range(WORLD):
        with open(out_dir / f"rank{i}.pkl", "rb") as f:
            out.append(pickle.load(f))
    with open(out_dir / "jax_ep.pkl", "rb") as f:
        return out, pickle.load(f)


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        _rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _jax_ep(sys.argv[2])
