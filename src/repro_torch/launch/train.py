"""The training loop: data pipeline -> train step -> checkpoints, on the
card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --smoke --steps 50 --ckpt-dir ckpt

The flags and output lines of the JAX package's ``launch/train.py``:
exact resume (the checkpoint's step is the data step), async
checkpoints, a SIGTERM hook (a final synchronous save, then exit), the
NaN-step guard, a straggler EMA; plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path) and ``--layers`` (cut the config
to that many layers at full width; 0 keeps its depth). ``--mesh`` other
than ``none`` and ``--compress-pods`` raise: the mesh and cross-pod
compression are not ported yet (ROADMAP.md queue 1 item 8b). Weights
come from ``lm.init_lm`` in fp32 with a ``torch.Generator`` seeded with
``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import runtime
from repro_torch.core import tree as tree_lib
from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as tsl


def main(argv=None):
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
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--mesh", default="none",
                    help="none (a mesh is not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise ValueError(f"--mesh {args.mesh!r}: the port trains on one "
                         "device; a mesh is not ported yet (ROADMAP.md "
                         "queue 1 item 8b)")
    device = runtime.resolve_device(args.device)

    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model}")

    tcfg = tsl.TrainConfig(
        opt=adamw.AdamWConfig(lr=args.lr),
        warmup_steps=max(args.steps // 20, 2), total_steps=args.steps,
        microbatches=args.microbatches,
        compress_pods=args.compress_pods)
    step_fn = tsl.make_train_step(cfg, tcfg)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_lm(cfg, gen, device=device, dtype=torch.float32)
    n_params = sum(x.numel() for x in tree_lib.leaves(params))
    print(f"params: {n_params/1e6:.2f}M")
    state = tsl.init_state(params, tcfg)

    start_step = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = ckpt.restore(args.ckpt_dir, latest, state,
                                        device=device)
            start_step = extra["data_step"]
            print(f"resumed from step {start_step}")

    ds = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed))
    it = PrefetchIterator(ds.iter_from(start_step))

    # preemption hook: a final synchronous checkpoint on SIGTERM
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, on_sigterm)

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
            print(f"[straggler] step took {dt*1e3:.0f}ms "
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
                print(f"step {i}: loss={float(metrics['loss']):.4f} "
                      f"acc={float(metrics['accuracy']):.3f} "
                      f"gnorm={float(metrics['grad_norm']):.2f} "
                      f"skip={int(metrics.get('skipped', 0))} "
                      f"tok/s={tok_s:.0f}")
            if saver and ((i + 1) % args.ckpt_every == 0):
                saver.save_async(i + 1, state, extra={"data_step": i + 1})
            if preempted["flag"]:
                print("SIGTERM: sync checkpoint + exit")
                if saver:
                    saver.wait()
                    ckpt.save(args.ckpt_dir, i + 1, state,
                              extra={"data_step": i + 1})
                sys.exit(0)
        if saver:
            saver.wait()
            ckpt.save(args.ckpt_dir, args.steps, state,
                      extra={"data_step": args.steps})
    finally:
        it.close()
        signal.signal(signal.SIGTERM, prev_handler)
    print("done")
    return state


if __name__ == "__main__":
    main()
