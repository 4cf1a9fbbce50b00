"""The port's auditor CLI.

    PYTHONPATH=src python -m repro_torch.analysis.audit [--arch deepseek-7b]
        [--mesh-shape N] [--json out.json] [--passes sync,donation,...]
        [--device cpu|cuda]

Runs the five passes over the serving modules and the step programs of
a reduced engine (2 slots, ``max_len`` 64, pages of 16, chunks of 16,
``speculate_k`` 2: the JAX package's audit engine) and exits non-zero on
any error diagnostic:

  sync            AST taint over ``src/repro_torch/serve/*.py`` (one
                  ``Engine._fetch`` per step-loop phase, no other host
                  read) and each entry point run once under the dispatch
                  recorder (no host read inside; on a card, the sync
                  debug mode agrees)
  donation        every cache leaf updated in place by each entry point
                  (on a card, a decode step's peak memory too)
  compile-bound   the shape-signature enumeration against the documented
                  bound, plain and table-width-bucketed; each entry
                  point's operands; a workload's signatures against the
                  static prediction and ``Engine.compile_counts()``
  smem            every kernel instantiation's shared memory against the
                  H100's 232,448 bytes a block and ``plan_matmul``'s
                  accounting, the K = 16384 stress plan; on a card, the
                  build (``ptxas.log`` and the library's query)
  rules           PagePool transaction discipline and the concat rule
                  over serve/engine.py, paging.py, prefix_cache.py

It runs on the card unless given ``--device cpu``. ``--mesh-shape N``
audits the ``TensorParallel`` placement: the CLI starts N ranks of
itself (``launch/mesh.spawn_ranks``, gloo on the CPU, NCCL on cards),
each audits its rank's engine, and rank 0 reports.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import (compile_bound, dispatch, donation, rules,
                                  smem, sync)
from repro_torch.analysis.report import CODES, PassResult

PASSES = ("sync", "donation", "compile-bound", "smem", "rules")

# sanctioned Engine._fetch call sites per engine function: THE serving
# latency contract. run(): the one decode read; _fill_slots(): the
# one-shot prefill's first token; _advance_chunks(): the final chunk's
# token (intermediate chunks stay asynchronous). And the host-read sites:
# _fetch's own one .cpu() of the stacked values, and submit()'s one
# normalisation of a tensor prompt to numpy. Everything else in
# src/repro_torch/serve is allowed zero of each.
ENGINE_FETCH_ALLOW = {"run": 1, "_fill_slots": 1, "_advance_chunks": 1}
ENGINE_HOST_READ_ALLOW = {"_fetch": 1, "submit": 1}
# _fetch stacks the few values it reads back, so the read is one transfer
ENGINE_CONCAT_ALLOW = ("_fetch",)

SERVE_DIR = Path(__file__).resolve().parent.parent / "serve"
SERVE_DIR_MODULES = ("engine.py", "paging.py", "sampling.py",
                     "placement.py", "prefix_cache.py", "faults.py",
                     "spec.py")
RULE_MODULES = ("engine.py", "paging.py", "prefix_cache.py")
# the compile-bound workload: one one-shot prompt and two chunked ones
WORKLOAD = (5, 20, 40)


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.audit")
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--mesh-shape", type=int, default=1,
                    help="TensorParallel ranks (1 = one device); the CLI "
                         "starts a process for each")
    ap.add_argument("--json", default="",
                    help="write per-pass results to this path")
    ap.add_argument("--passes", default="",
                    help="comma-separated subset (default: all five)")
    ap.add_argument("--explain", default="",
                    help="print the catalogue entry for a code and exit")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels, the build, the sync debug "
                         "mode) or 'cpu' (the plain path)")
    ap.add_argument("--dist-backend", default=None,
                    choices=("nccl", "gloo"),
                    help="the ranks' backend (default: nccl on a card, "
                         "gloo on the CPU)")
    ap.add_argument("--dist-init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dist-timeout", type=float, default=300.0,
                    help="seconds a collective (and the ranks' whole run) "
                         "may take")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def make_params(arch: str, device="cpu"):
    """The reduced ``arch``'s parameters, ``lm.init_lm`` from seed 0 in
    fp32."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    dev = torch.device(device)
    return lm.init_lm(get_reduced(arch),
                      torch.Generator(device=dev).manual_seed(0),
                      device=dev, dtype=torch.float32)


def build_engine(arch: str, params, device="cpu", *, placement=None,
                 speculate_k: int = 2):
    """The audited engine: the reduced ``arch``, 2 slots, ``max_len``
    64, pages of 16, chunks of 16, ``speculate_k`` 2, over ``params``
    (:func:`make_params`, or a tree converted from the JAX package's)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.types import PagingConfig
    from repro_torch.serve.engine import Engine

    cfg = get_reduced(arch)
    dev = torch.device(device)
    eng = Engine(params, cfg, n_slots=2, max_len=64, eos_id=-1,
                 paging=PagingConfig(page_size=16, prefill_chunk=16,
                                     speculate_k=speculate_k),
                 placement=placement, device=dev)
    return eng, cfg


def serve_sources():
    """(path, source) of each serving module the sync pass reads."""
    return [(str(SERVE_DIR / mod), (SERVE_DIR / mod).read_text())
            for mod in SERVE_DIR_MODULES]


def engine_policy() -> sync.SyncPolicy:
    return sync.SyncPolicy(fetch_allow=dict(ENGINE_FETCH_ALLOW),
                           host_read_allow=dict(ENGINE_HOST_READ_ALLOW))


def _timed(name, fn):
    t0 = time.perf_counter()
    res = fn()
    res.name = name
    res.wall_s = time.perf_counter() - t0
    return res


def _sync_pass(runs):
    res = PassResult(name="sync")
    for path, src in serve_sources():
        policy = engine_policy() if path.endswith("engine.py") \
            else sync.SyncPolicy()
        res.merge(sync.audit_source(src, path=path, policy=policy))
    return res.merge(sync.audit_entry_points(runs))


def _compile_bound_pass(eng, cfg, runs, workload):
    res = PassResult(name="compile-bound")
    for twb in (False, True):
        # speculation ships full-width tables (the engine forbids
        # speculate_k + table-width bucketing), so the bucketed leg
        # audits the speculation-free ladder and the plain leg carries
        # the engine's k-ladder
        sk = 0 if twb else eng.spec_k
        inv = compile_bound.enumerate_programs(
            max_len=eng.max_len, page_size=eng.page_size,
            prefill_chunk=eng.prefill_chunk, buckets=eng.buckets,
            table_width_bucketing=twb, speculate_k=sk)
        res.merge(compile_bound.audit_bound(
            inv, n_buckets=len(eng.buckets),
            n_chunk_shapes=len([b for b in eng.buckets
                                if b <= eng.prefill_chunk]),
            max_pages=eng.max_pages, table_width_bucketing=twb,
            n_spec_shapes=len(eng.spec_ladder) if sk else 0,
            name=f"{cfg.name}[twb={twb}]"))
    res.merge(compile_bound.operand_audit(runs))
    if workload is not None:
        res.merge(workload())
    return res


def workload_check(eng, cfg, params, prompt_lens=WORKLOAD,
                   max_new: int = 4):
    """Serve ``prompt_lens`` on an engine like ``eng`` (built from the
    same full ``params``) without speculation (the prediction models
    none), its step programs' signatures recorded, and hold them and
    ``compile_counts()`` to :func:`compile_bound.predict_compile_counts`."""
    from repro_torch.core.types import PagingConfig
    from repro_torch.serve.engine import Engine, Request
    run = Engine(params, cfg, n_slots=eng.n_slots, max_len=eng.max_len,
                 eos_id=-1, paging=PagingConfig(
                     page_size=eng.page_size,
                     prefill_chunk=eng.prefill_chunk),
                 placement=eng.placement, device=eng.device)
    seen = compile_bound.record_signatures(run)
    rng = np.random.default_rng(0)
    for i, plen in enumerate(prompt_lens):
        run.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, plen).astype(np.int32), max_new=max_new))
    done = run.run()
    res = compile_bound.check_engine_counts(
        run, compile_bound.predict_compile_counts(
            prompt_lens, max_len=run.max_len,
            prefill_chunk=run.prefill_chunk, buckets=run.buckets),
        name=f"{cfg.name}[workload]", signatures=seen)
    res.checked += 1
    if [c.status for c in done] != ["ok"] * len(prompt_lens):
        from repro_torch.analysis.report import Diagnostic
        res.diagnostics.append(Diagnostic(
            code="RWA303", path=f"{cfg.name}[workload]",
            message=f"the workload ended {[c.status for c in done]}"))
    return res


def _smem_pass(device):
    res = PassResult(name="smem")
    models = smem.kernel_models()
    res.merge(smem.audit_models(models))
    # every design's plan against its kernel, and the large-K stress case
    for m, k, n, dt, nw in ((4, 4096, 12288, "bf16", 1),
                            (2048, 4096, 11008, "bf16", 2),
                            (2048, 4096, 4096, "fp32", 1),
                            (16, 4096, 11008, "fp32", 2),
                            (4, 4096, 11008, "int8", 2),
                            (2048, 4096, 4096, "int8", 1)):
        plan = smem.rowwise.plan_matmul(m, k, n, dtype=dt, n_weights=nw)
        res.merge(smem.crosscheck_plan(plan, smem.model_of(plan, nw, dt),
                                       name=f"matmul[{m}x{k}x{n} {dt}]"))
    plan, model = smem.stress_plan()
    res.merge(smem.crosscheck_plan(plan, model,
                                   name=f"matmul[k={smem.STRESS[1]}]"))
    if torch.device(device).type == "cuda":
        res.merge(card_smem(device))
    return res


def card_smem(device) -> PassResult:
    """The build's half of the smem pass: ptxas' report and the
    library's query of every kernel, its constants, and the K = 16384
    stress matmul launched and held to its plan."""
    from repro_torch.analysis.report import Diagnostic
    from repro_torch.core import trace
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
    lib = _build.library()
    log = (_build.BUILD_DIR / "ptxas.log").read_text()
    res = smem.audit_build(smem.query_library(lib), smem.parse_ptxas(log))
    res.merge(smem.check_constants(smem.library_constants(lib)))
    m, k, n = smem.STRESS
    plan, _ = smem.stress_plan()
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=device)
    w = torch.randn(k, n, generator=gen, device=device) * k ** -0.5
    with trace.recording() as recs:
        out = rowwise_matmul_p(x, w)
    want = ref.pipeline_ref(x, w)
    err = (out - want).abs().max().item()
    res.checked += 2
    if [r["design"] for r in recs] != [plan.design]:
        res.diagnostics.append(Diagnostic(
            code="RWA402", path=f"matmul[k={k}]",
            message=f"the launch took {[r['design'] for r in recs]}, the "
                    f"plan {plan.design}"))
    if not err <= 1e-4 * max(1.0, want.abs().max().item()):
        res.diagnostics.append(Diagnostic(
            code="RWA402", path=f"matmul[k={k}]",
            message=f"the stress matmul is {err:.3g} off its plain "
                    "version"))
    return res


def _rules_pass():
    res = PassResult(name="rules")
    for mod in RULE_MODULES:
        res.merge(rules.audit_file(
            str(SERVE_DIR / mod),
            concat_allow=ENGINE_CONCAT_ALLOW if mod == "engine.py" else ()))
    return res


def run_passes(eng, cfg, which=None, *, params=None):
    """Run the selected passes on ``eng`` (:func:`build_engine`);
    returns ``(results, runs)``, the entry points' runs beside. With the
    engine's full ``params`` the compile-bound pass also serves its
    workload (:func:`workload_check`)."""
    which = set(which or PASSES)
    runs = []
    if which & {"sync", "donation", "compile-bound"}:
        runs = dispatch.run_entry_points(eng)
    results = []
    if "sync" in which:
        results.append(_timed("sync", lambda: _sync_pass(runs)))
    if "donation" in which:
        results.append(_timed("donation",
                              lambda: donation.audit_runs(runs)))
    if "compile-bound" in which:
        results.append(_timed("compile-bound", lambda: _compile_bound_pass(
            eng, cfg, runs,
            (lambda: workload_check(eng, cfg, params))
            if params is not None else None)))
    if "smem" in which:
        results.append(_timed("smem", lambda: _smem_pass(eng.device)))
    if "rules" in which:
        results.append(_timed("rules", _rules_pass))
    return results, runs


def _entries_json(runs):
    return [{"name": r.name, "host_reads": len(r.recorder.host_reads),
             "debug_syncs": r.debug_syncs, "peak_growth": r.peak_growth,
             "ops": sum(r.recorder.ops.values())} for r in runs]


def _placement(args, device):
    from repro_torch.serve import placement as placement_mod
    if args.mesh_shape <= 1:
        return placement_mod.SingleDevice()
    import torch.distributed as dist
    backend = args.dist_backend or (
        "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:                            # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.mesh_shape))
    dist.init_process_group(
        backend, init_method=args.dist_init, rank=args.rank,
        world_size=args.mesh_shape,
        timeout=datetime.timedelta(seconds=args.dist_timeout))
    return placement_mod.TensorParallel(args.mesh_shape, rank=args.rank,
                                        timeout_s=args.dist_timeout)


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.explain:
        print(f"{args.explain}: {CODES.get(args.explain, 'unknown code')}")
        return 0
    from repro_torch.core import runtime
    device = runtime.resolve_device(args.device)
    which = set(args.passes.split(",")) if args.passes else set(PASSES)
    unknown = which - set(PASSES)
    if unknown:
        raise ValueError(f"unknown passes {sorted(unknown)}; known "
                         f"{PASSES}")
    if args.mesh_shape > 1 and args.rank is None:
        from repro_torch.launch import mesh as mesh_lib
        outs = mesh_lib.spawn_ranks(
            "repro_torch.analysis.audit",
            list(sys.argv[1:] if argv is None else argv), args.mesh_shape,
            args.dist_timeout + 60.0, "the tensor-parallel audit")
        print(outs[0], end="")
        return 0
    placement = _placement(args, device)
    params = make_params(args.arch, device)
    eng, cfg = build_engine(args.arch, params, device, placement=placement)
    results, runs = run_passes(eng, cfg, which, params=params)
    failed = not all(r.ok for r in results)
    if args.mesh_shape > 1:
        import torch.distributed as dist
        dist.barrier()               # no rank leaves while one still sends
        dist.destroy_process_group()
        if args.rank:
            return 1 if failed else 0
    print(f"audit of {cfg.name} on {device} "
          f"({placement.describe()}), 2 slots, max_len 64, pages of 16, "
          "chunks of 16, speculate_k 2")
    for run in runs:
        print(f"  entry {run.name}: {len(run.recorder.host_reads)} host "
              f"read(s) recorded, sync debug mode "
              f"{'n/a' if run.debug_syncs is None else run.debug_syncs}, "
              f"{sum(run.recorder.ops.values())} ops"
              + ("" if run.peak_growth is None else
                 f", peak memory +{run.peak_growth:,} B"))
    for res in results:
        print(res.summary())
        for d in res.diagnostics:
            print(f"  {d}" + ("" if d.severity == "error"
                              else f" [{d.severity}]"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": str(device), "arch": cfg.name,
                       "mesh_shape": args.mesh_shape,
                       "fetch_allow": ENGINE_FETCH_ALLOW,
                       "host_read_allow": ENGINE_HOST_READ_ALLOW,
                       "entries": _entries_json(runs),
                       "passes": [{
                           "pass": r.name, "checked": r.checked,
                           "wall_s": r.wall_s, "ok": r.ok,
                           "diagnostics": [str(d) for d in r.diagnostics],
                       } for r in results]}, f, indent=2)
    print("audit:", "FAIL" if failed else
          f"OK ({sum(r.checked for r in results)} invariant sites, "
          f"{len(results)} passes)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
