"""The training loop: data pipeline -> train step -> checkpoints, on the
card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --smoke --steps 50 --ckpt-dir ckpt

The flags and output lines of the JAX package's ``launch/train.py``:
exact resume (the checkpoint's step is the data step), async
checkpoints, a SIGTERM hook (a final synchronous save, then exit), the
NaN-step guard, a straggler EMA; plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path) and ``--layers`` (cut the config
to that many layers at full width; 0 keeps its depth). Weights come
from ``lm.init_lm`` in fp32 with a ``torch.Generator`` seeded with
``--seed``.

``--mesh host`` trains on the (pod=2, data=2, model=2) mesh: the CLI
runs itself once per rank (``--rank i``, all joined at ``--dist-init``,
a ``tcp://localhost`` port it picks unless given), waits for the eight
ranks and prints rank 0's lines. Each rank builds the full model from
the seed, keeps its blocks of the state (``train/step.py``) and draws
the same global batch. The collectives' backend is ``--dist-backend``
(``nccl`` for a card, ``gloo`` for the CPU unless given; NCCL refuses
two ranks on one card, so eight ranks on fewer cards need ``gloo``).
``--compress-pods`` (a mesh only) reduces the gradients across the pods
in int8 with error feedback. Checkpoints under a mesh are one device's
format, written by rank 0, so a run resumes on any mesh or none
(elastic). Every host decision is rank 0's: the SIGTERM flag is
broadcast each step, and a rank that fails fails the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import runtime
from repro_torch.core import tree as tree_lib
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as tsl

HOST_MESH = (2, 2, 2)


def main(argv=None, cfg=None):
    """The CLI. ``cfg``: a ``ModelConfig`` to train in place of
    ``--arch``'s (on one device: a mesh's ranks resolve ``--arch``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-pods", action="store_true",
                    help="int8 + error-feedback gradient mean across "
                         "the pods (needs --mesh host)")
    ap.add_argument("--mesh", default="none", choices=("none", "host"),
                    help="none | host (2,2,2: eight ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels; under a mesh rank i on "
                         "card i mod the cards), 'cuda:N', or 'cpu' (the "
                         "plain PyTorch path)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="the collectives' backend under a mesh "
                         "(default: nccl on a card, gloo on the CPU)")
    ap.add_argument("--dist-init", default=None,
                    help="the ranks' rendezvous, e.g. "
                         "tcp://localhost:29500 (default: a free port)")
    ap.add_argument("--dist-timeout", type=float, default=600.0,
                    help="seconds a collective may take before it fails")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if cfg is not None and args.mesh != "none":
        raise ValueError("a config given to main trains on one device: "
                         "the mesh's ranks resolve --arch")
    if args.compress_pods and args.mesh == "none":
        raise ValueError("--compress-pods reduces the gradients over the "
                         "'pod' axis of a mesh: pass --mesh host")
    n_ranks = 1
    if args.mesh == "host":
        n_ranks = HOST_MESH[0] * HOST_MESH[1] * HOST_MESH[2]
        if args.rank is None:
            outs = mesh_lib.spawn_ranks(
                "repro_torch.launch.train",
                list(sys.argv[1:] if argv is None else argv), n_ranks,
                args.dist_timeout + 60.0, "the training mesh")
            print(outs[0], end="")
            return None
    device = runtime.resolve_device(args.device)
    if n_ranks > 1 and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    mesh = None
    if n_ranks > 1:
        backend = args.dist_backend or (
            "nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:                        # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
        dist.init_process_group(
            backend, init_method=args.dist_init, rank=args.rank,
            world_size=n_ranks,
            timeout=datetime.timedelta(seconds=args.dist_timeout))
        mesh = mesh_lib.make_host_mesh(HOST_MESH)
    lead = args.rank in (None, 0)
    try:
        return _train(args, cfg or _cfg_of(args), device, mesh, lead)
    finally:
        if mesh is not None:
            dist.barrier()           # no rank leaves while one still sends
            dist.destroy_process_group()


def _cfg_of(args):
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def _train(args, cfg, device, mesh, lead: bool):
    """The loop on this rank (``mesh`` None: one device); ``lead`` ranks
    print."""
    def say(msg):
        if lead:
            print(msg, flush=True)

    say(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model}"
        + ("" if mesh is None else f" {mesh.describe()}"))

    tcfg = tsl.TrainConfig(
        opt=adamw.AdamWConfig(lr=args.lr),
        warmup_steps=max(args.steps // 20, 2), total_steps=args.steps,
        microbatches=args.microbatches,
        compress_pods=args.compress_pods)
    if mesh is None:
        step_fn = tsl.make_train_step(cfg, tcfg)
    else:
        step_fn = tsl.make_train_step(cfg, tcfg, mesh=mesh)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_lm(cfg, gen, device=device, dtype=torch.float32)
    n_params = sum(x.numel() for x in tree_lib.leaves(params))
    say(f"params: {n_params/1e6:.2f}M")
    state = tsl.init_state(params, tcfg)
    shardings = None
    if mesh is not None:
        # every rank built the same full state from the seed: keep the
        # blocks
        shardings = tsl.state_shardings(cfg, tcfg, mesh)
        state = tsl.shard_state(state, shardings)
        del params

    start_step = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = ckpt.restore(args.ckpt_dir, latest, state,
                                        device=device, shardings=shardings)
            start_step = extra["data_step"]
            say(f"resumed from step {start_step}")

    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed))
    it = PrefetchIterator(ds.iter_from(start_step))

    # preemption hook: a final synchronous checkpoint on SIGTERM
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, on_sigterm)

    def stop() -> bool:
        """Whether to stop after this step: rank 0's flag, on every
        rank (a rank deciding otherwise would wait in a collective the
        others never enter)."""
        if mesh is None:
            return preempted["flag"]
        flag = torch.tensor([float(preempted["flag"])],
                            device=device if mesh.backend == "nccl"
                            else "cpu")
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    # straggler mitigation: EMA of step latency; steps slower than
    # STRAGGLER_X times the EMA are logged (on a multi-host deployment
    # this signal would feed the controller that drains the slow host)
    STRAGGLER_X = 3.0
    ema = {"dt": None, "flagged": 0}

    def track_step_time(dt):
        if ema["dt"] is None:
            ema["dt"] = dt
            return False
        slow = dt > STRAGGLER_X * ema["dt"]
        ema["dt"] = 0.9 * ema["dt"] + 0.1 * dt
        if slow:
            ema["flagged"] += 1
            say(f"[straggler] step took {dt*1e3:.0f}ms "
                f"(EMA {ema['dt']*1e3:.0f}ms) — flagged "
                f"{ema['flagged']} total")
        return slow

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    try:
        t0 = time.time()
        for i in range(start_step, args.steps):
            batch = {k: runtime.to_device(v, device).long()
                     for k, v in next(it).items()}
            t_step = time.time()
            state, metrics = step_fn(state, batch)
            sync()
            track_step_time(time.time() - t_step)
            if i % 10 == 0 or i == args.steps - 1:
                dt = time.time() - t0
                tok_s = (i - start_step + 1) * args.batch * args.seq / dt
                say(f"step {i}: loss={float(metrics['loss']):.4f} "
                    f"acc={float(metrics['accuracy']):.3f} "
                    f"gnorm={float(metrics['grad_norm']):.2f} "
                    f"skip={int(metrics.get('skipped', 0))} "
                    f"tok/s={tok_s:.0f}")
            if saver and ((i + 1) % args.ckpt_every == 0):
                saver.save_async(i + 1, state, extra={"data_step": i + 1},
                                 shardings=shardings)
            if stop():
                say("SIGTERM: sync checkpoint + exit")
                if saver:
                    saver.wait()
                    ckpt.save(args.ckpt_dir, i + 1, state,
                              extra={"data_step": i + 1},
                              shardings=shardings)
                sys.exit(0)
        if saver:
            saver.wait()
            ckpt.save(args.ckpt_dir, args.steps, state,
                      extra={"data_step": args.steps}, shardings=shardings)
    finally:
        it.close()
        signal.signal(signal.SIGTERM, prev_handler)
    say("done")
    return state


if __name__ == "__main__":
    main()
