"""Serving driver: the port's paged-KV continuous-batching engine over
synthetic requests, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
      --smoke --requests 8 --slots 4 --page-size 16

The flags and output lines of the JAX package's ``launch/serve.py``,
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
path) and ``--layers`` (cut the config to that many layers at full
width). Weights come from ``lm.init_lm`` with a ``torch.Generator``
seeded with ``--seed``, the synthetic prompts from
``np.random.default_rng(seed)`` at the reference's lengths
(``prompt_len + i % 8``).

Tensor-parallel serving: ``--mesh-shape model=N`` (or ``N``) with N > 1
serves N ranks. The CLI starts them itself: it runs itself once per
rank (``--rank i``, all joined at ``--dist-init``, a
``tcp://localhost:<port>`` it picks when none is given), waits for them
and checks that every rank produced the same completions. Each rank
builds the same full model from ``--seed``, keeps its shard
(``serve/placement.py``) and serves the same requests; rank 0 prints
the lines above. The collectives' backend is ``--dist-backend``
(``nccl`` for a card, ``gloo`` for the CPU unless given), and
``--device`` names each rank's device: one device for every rank or a
comma-separated list, one a rank. NCCL refuses two ranks on one card;
to run N ranks on fewer cards, ask for ``--dist-backend gloo`` (it
stages every collective through host memory). Nothing switches backend
or device on a failure, and a rank that fails fails the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.core import runtime
from repro_torch.core.block_traffic import serve_kv_traffic
from repro_torch.core.types import PagingConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.serve import faults as faults_mod
from repro_torch.serve import placement as placement_mod
from repro_torch.serve.engine import Engine, Request


def digest(done) -> str:
    """A short hash of the completions (rid, status, tokens): equal on
    every rank of a tensor-parallel run."""
    h = hashlib.sha256()
    for c in sorted(done, key=lambda c: c.rid):
        h.update(repr((c.rid, c.status, list(c.tokens))).encode())
    return h.hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="real pages per layer pool (0 = full occupancy; "
                         "smaller oversubscribes and defers admissions)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill panel size (a bucket-ladder "
                         "power of two; 0 = monolithic bucketed prefill). "
                         "Prompts longer than this split across engine "
                         "steps interleaved with decode, removing the "
                         "TTFT cliff the largest bucket causes")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix cache over token prefixes: "
                         "admission maps fully shared prompt pages into "
                         "the new slot's block table and chunked "
                         "prefill replays only the uncached suffix "
                         "(requires --prefill-chunk; sliding-window "
                         "archs silently opt out)")
    ap.add_argument("--prefill-token-budget", type=int, default=0,
                    help="Sarathi-style cap on prefill tokens advanced "
                         "per engine step across mid-prefill slots "
                         "(0 = unbounded; the oldest slot always "
                         "advances)")
    ap.add_argument("--prompt-len", type=int, default=4,
                    help="base synthetic prompt length (request i gets "
                         "prompt_len + i %% 8 tokens); raise above "
                         "--prefill-chunk to drive chunked admissions")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the k highest-logit tokens "
                         "(0 = full vocab). Static per engine; greedy "
                         "rows (t=0) stay bit-identical regardless")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass cutoff (1.0 = off); "
                         "static per engine, like --top-k")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: a host-side "
                         "prompt-lookup drafter proposes up to K "
                         "tokens/step, one batched verify forward "
                         "scores them, rejected tails roll back "
                         "page-exactly. Greedy streams stay "
                         "bit-identical to K=0; repetitive prompts "
                         "accept >1 token/step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-plan", default="",
                    help="deterministic chaos schedule, e.g. "
                         "'alloc@3,nan@5.1,exc@7,slow@2:0.01' "
                         "(kind@clock[.slot][:arg]); or 'random:SEED' "
                         "for a seeded random plan. The engine recovers "
                         "and every request still reaches a terminal "
                         "completion — this flag exists to demo that")
    ap.add_argument("--preempt-patience", type=int, default=None,
                    help="preempt the youngest slot after this many "
                         "consecutive iterations with the queue head "
                         "blocked on pages (default: off; deadline-"
                         "priority preemption is always on)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds (requests "
                         "past it retire with status 'deadline')")
    ap.add_argument("--mesh-shape", default="",
                    help="tensor-parallel mesh, e.g. 'model=4' or '4' "
                         "('' or '1' = single device): that many ranks, "
                         "one process each. Head counts, d_ff and the "
                         "padded vocab must divide by it; indivisible "
                         "shapes are rejected at engine construction")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: 'cuda' (the kernels) "
                         "or 'cpu' (the plain PyTorch path); under a "
                         "mesh, one device for every rank or a "
                         "comma-separated list, one a rank")
    ap.add_argument("--dist-backend", default=None,
                    choices=("nccl", "gloo"),
                    help="the collectives' backend under a mesh "
                         "(default: nccl on a card, gloo on the CPU)")
    ap.add_argument("--dist-init", default=None,
                    help="the ranks' rendezvous, e.g. "
                         "tcp://localhost:29500 (default: a free port)")
    ap.add_argument("--dist-timeout", type=float, default=600.0,
                    help="seconds a collective (and the whole run of "
                         "the ranks) may take before it fails")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = all)")
    args = ap.parse_args(argv)

    placement = placement_mod.from_mesh_shape(args.mesh_shape)
    devices = args.device.split(",")
    t = placement.n_shards
    if len(devices) not in (1, t):
        raise ValueError(f"--device names {len(devices)} devices for "
                         f"{t} ranks: give one, or one a rank")
    cfg = get_reduced(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    placement.validate(cfg)
    devices = [runtime.resolve_device(d) for d in devices]
    if t > 1 and args.rank is None:
        outs = mesh_lib.spawn_ranks(
            "repro_torch.launch.serve",
            list(sys.argv[1:] if argv is None else argv), t,
            args.dist_timeout + 60.0, "tensor-parallel serving")
        print(outs[0], end="")
        sums = [line.split("completions=")[1] for out in outs
                for line in out.splitlines() if "completions=" in line]
        if len(sums) != t or len(set(sums)) != 1:
            raise RuntimeError(f"the ranks' completions differ: {sums}")
        print(f"ranks: {t}, every rank's completions {sums[0]}")
        return None
    device = devices[min(args.rank or 0, len(devices) - 1)]
    if t > 1:
        backend = args.dist_backend or (
            "nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:                        # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // t))
        dist.init_process_group(
            backend, init_method=args.dist_init, rank=args.rank,
            world_size=t,
            timeout=datetime.timedelta(seconds=args.dist_timeout))
        placement = placement_mod.TensorParallel(
            t, rank=args.rank, axis=placement.axis,
            timeout_s=args.dist_timeout)
    if args.fault_plan.startswith("random:"):
        plan = faults_mod.FaultPlan.random(
            int(args.fault_plan.split(":", 1)[1]), n_steps=64,
            n_slots=args.slots, p_alloc=0.1, p_nan=0.05, p_exc=0.02)
    else:
        plan = faults_mod.parse_plan(args.fault_plan)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_lm(cfg, gen, device=device, dtype=torch.float32)
    eng = Engine(params, cfg, n_slots=args.slots, max_len=args.max_len,
                 eos_id=-1, temperature=args.temperature,
                 top_k=args.top_k, top_p=args.top_p, seed=args.seed,
                 paging=PagingConfig(
                     page_size=args.page_size, n_pages=args.n_pages,
                     prefill_chunk=args.prefill_chunk,
                     prefix_cache=args.prefix_cache,
                     prefill_token_budget=args.prefill_token_budget,
                     speculate_k=args.speculate),
                 placement=placement, faults=plan,
                 preempt_patience=args.preempt_patience, device=device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = min(args.prompt_len + (i % 8), args.max_len)
        prompt = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new,
                           deadline_s=args.deadline))
    t0 = time.time()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_new = sum(len(c.tokens) for c in done)
    if t > 1:
        print(f"rank={args.rank} completions={digest(done)}")
        dist.barrier()               # no rank leaves while one still sends
        dist.destroy_process_group()
        if args.rank:
            return done
    print(f"arch={cfg.name} slots={args.slots} requests={len(done)} "
          f"page_size={eng.page_size} pool={eng.pool.n_pages} pages "
          f"placement={placement.describe()} device={device}")
    for c in sorted(done, key=lambda c: c.rid)[:4]:
        print(f"  rid={c.rid} status={c.status} prompt_len={c.prompt_len} "
              f"tokens={c.tokens[:8]}... latency={c.latency_s*1e3:.0f}ms "
              f"ttft={c.ttft_s*1e3:.0f}ms")
    by_status: dict = {}
    for c in done:
        by_status[c.status] = by_status.get(c.status, 0) + 1
    print(f"decoded {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s with continuous batching)")
    print(f"statuses: {by_status}  faults: {plan.describe()}  "
          f"stats: {eng.stats}")
    traffic = serve_kv_traffic(eng.kv_trace, cfg, n_slots=args.slots,
                               max_len=args.max_len,
                               page_size=eng.page_size)
    compiles = eng.compile_counts()
    if traffic["dense_bytes"]:
        kv = (f"KV bytes/trace: paged={traffic['paged_bytes']:,} "
              f"dense={traffic['dense_bytes']:,} "
              f"(x{traffic['ratio']:.2f} less)")
    else:
        kv = "KV traffic: n/a (no attention layers)"
    print(f"{kv}; compiles: prefill={compiles['prefill']} "
          f"chunk={compiles['chunk']} step={compiles['step']} "
          f"spec={compiles.get('spec', 0)} "
          f"buckets={eng.buckets} prefill_chunk={eng.prefill_chunk}")
    return done


if __name__ == "__main__":
    main()
