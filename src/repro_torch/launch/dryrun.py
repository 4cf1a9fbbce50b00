"""Multi-pod dry run on ``meta`` tensors: every (arch x shape x mesh)
cell's real step, as one rank of a fake 256- or 512-rank world, on the
CPU with no card. The port's counterpart of the JAX package's
``launch/dryrun.py``.

JAX lowers and compiles the step against 512 placeholder devices. The
port has no compile step: it opens torch's ``fake`` process group
(every collective returns at once, moving nothing) in this process as
rank ``--rank`` of the production mesh (``launch/mesh.py``: (data=16,
model=16) or (pod=2, data=16, model=16)), builds the state on ``meta``
(``launch/specs.py``: shapes and dtypes, no allocation), cuts this
rank's blocks (``partitioning.tree_shardings`` / ``shard_tree`` under
the cell's rules) and runs the real call on them under the op walk
(``launch/op_cost.py``):

  * ``train``: ``make_train_step(cfg, tcfg, mesh=)`` on the sharded
    state and the global batch;
  * ``prefill``: ``lm.prefill`` on this rank's batch rows, every
    parameter leaf registered with ``partitioning.fsdp`` at the cell's
    specs (the model gathers each where it reads it);
  * ``decode``: ``lm.decode_step`` the same way, on the cache cut by
    ``lm.cache_logical_specs``; under ``kv_seq=model,
    decode_attn=sharded`` the global layers take
    ``attention._decode_seq_sharded``.

Every kernel wrapper given a meta tensor notes its launch record and
returns an empty output (``_build.check_cuda`` passes meta tensors, and
each wrapper's meta branch returns before its launch); the glue runs
as ATen ops on meta. The collectives are the port's counted wrappers
(``core/partitioning.py``): FSDP by hand, so the schedule is the port's
own (``"schedule": "fsdp-by-hand"``), not GSPMD's. One JSON a cell,
``{arch}__{shape}__{mesh}.json``, holds ``roofline.analyze``'s terms,
the launches by kernel and design, the collectives by kind, this rank's
memory (``memory_analysis``: its blocks as arguments, the call's fresh
outputs, the peak of the intermediates alive at once) and whether it
fits the card's memory (:data:`HBM_BYTES`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k [--mesh multipod] [--rank 5]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b \\
        --shape decode_32k --rules kv_seq=model,kv_heads=data

The exit code is 1 when any cell failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.core import partitioning as part
from repro_torch.core import tree as tree_lib
from repro_torch.core.types import ModelConfig, ShapeSpec
from repro_torch.launch import op_cost, roofline, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.train import step as train_step_lib

# the memory a process sees on an H100 80GB HBM3
# (``torch.cuda.get_device_properties(0).total_memory``; nvidia-smi's
# memory.total, 81,559 MiB, also counts what the card reserves), read by
# ``chip_smoke.py``'s tooling phase, which holds this to the card's
# within 1%: ``fits_hbm_80g`` is this rank's live bytes under it
HBM_BYTES = 85_017_493_504
SCHEDULE = "fsdp-by-hand"


def cell_rules(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Per-cell logical-rule overrides (the baseline schedule): the JAX
    package's, cell for cell."""
    rules = {}
    if shape.kind in ("decode", "prefill"):
        rules["kv_seq"] = "model"       # shard the cache along sequence
    if shape.kind == "decode":
        # serving keeps weights resident in their shards (Megatron-TP
        # layout, no FSDP dim)
        rules["embed"] = None
        rules["qkv"] = "model"
        rules["ffn"] = "model"
        rules["decode_attn"] = "sharded"   # seq-sharded flash decode
        if shape.global_batch == 1:
            rules["batch"] = None       # batch=1 cannot shard
            rules["kv_heads"] = "data"  # use the idle data axis on heads
    return rules


def _fake_store():
    """torch's fake process group store: every collective of a group on
    it returns at once. It lives in ``torch.testing._internal``; without
    it the dry run stops (it never opens a real group)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not ship") from e
    return FakeStore()


@contextlib.contextmanager
def _fake_world(size: int, rank: int):
    """This process as rank ``rank`` of a fake world of ``size`` ranks,
    for the block; the group is destroyed after."""
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} of a world of {size}")
    if dist.is_initialized():
        raise RuntimeError("the dry run opens a fake world of its own, and "
                           "a process group is already initialised")
    dist.init_process_group("fake", store=_fake_store(), rank=rank,
                            world_size=size)
    try:
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run's group is not the fake backend")
        yield
    finally:
        dist.destroy_process_group()


def _storages(tree) -> dict:
    """{storage: bytes} of the tensor leaves of a tree (a storage two
    leaves share counted once)."""
    return {t.untyped_storage()._cdata: t.numel() * t.element_size()
            for t in tree_lib.leaves(tree) if isinstance(t, torch.Tensor)}


def cell_arguments(cfg: ModelConfig, shape: ShapeSpec, tcfg=None):
    """(arguments, logical names) of a cell's call, both dicts of trees,
    the arguments on ``meta`` at their global shapes: ``state`` (train)
    or ``params``, the ``cache`` of a decode cell, the ``inputs``."""
    if shape.kind == "train":
        state, state_names = specs.abstract_train_state(cfg, tcfg)
        args, names = {"state": state}, {"state": state_names}
    else:
        params, pspecs = specs.abstract_init(cfg)
        args, names = {"params": params}, {"params": pspecs}
    if shape.kind == "decode":
        cache, _ = specs.abstract_cache(cfg, shape.global_batch,
                                        shape.seq_len)
        args["cache"] = cache
        names["cache"] = lm.cache_logical_specs(cache, cfg)
    inputs = specs.input_specs(cfg, shape)
    args["inputs"] = inputs
    names["inputs"] = {k: ("batch",) + (None,) * (v.dim() - 1)
                       for k, v in inputs.items()}
    return args, names


def _call(cfg, shape, mesh, tcfg):
    """(fn, this rank's arguments) of the cell's call."""
    args, names = cell_arguments(cfg, shape, tcfg)
    shardings = part.tree_shardings(mesh, names, like=args)
    if shape.kind == "train":
        state = part.shard_tree(args["state"], shardings["state"])
        batch = args["inputs"]
        step = train_step_lib.make_train_step(cfg, tcfg, mesh=mesh)
        rows, _ = train_step_lib.split_batch(batch, mesh)
        # the step takes the global batch; its arguments are this rank's
        # rows of it
        return (lambda: step(state, batch)), (state, rows)
    params = part.shard_tree(args["params"], shardings["params"])
    rows, axes = train_step_lib.split_batch(args["inputs"], mesh)
    leaves = tree_lib.leaves(params)
    p_sh = tree_lib.leaves(shardings["params"])
    if shape.kind == "prefill":
        extra = {k: v for k, v in rows.items() if k != "tokens"} or None

        def fn():
            with part.fsdp(leaves, p_sh), part.batch_split(axes), \
                    torch.no_grad():
                return lm.prefill(params, rows["tokens"], cfg, extra=extra)
        return fn, (params, rows)
    cache = part.shard_tree(args["cache"], shardings["cache"])

    def fn():
        with part.fsdp(leaves, p_sh), part.batch_split(axes), \
                torch.no_grad():
            logits, new_cache = lm.decode_step(params, cache, rows["tokens"],
                                               rows["lengths"], cfg)
            return torch.argmax(logits, -1).to(torch.int32), new_cache
    return fn, (params, cache, rows)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             rules_override=None, tcfg=None, verbose=True,
             microbatches: int = 1, rank: int = 0,
             keep_cost: bool = False) -> dict:
    """One cell's record (see the module docstring); with ``keep_cost``
    also the walk's ``OpCost`` under ``"cost"`` (not JSON)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    tcfg = tcfg or train_step_lib.TrainConfig(microbatches=microbatches,
                                              remat=True)
    rules = cell_rules(cfg, shape)
    rules.update(rules_override or {})
    world = 512 if multi_pod else 256

    t0 = time.time()
    with _fake_world(world, rank):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with part.use_mesh(mesh, rules):
            fn, args = _call(cfg, shape, mesh, tcfg)
            held = _storages(args)
            counts0 = part.counts()
            out, cost = op_cost.walk(fn)
            counts = {k: v - counts0[k] for k, v in part.counts().items()}
        made = _storages(out)
        del out, args, fn
        coords = dict(mesh.coords)
    seconds = time.time() - t0

    n = specs.param_count(cfg)
    rep = roofline.analyze(
        cost, arch=arch, shape=shape_name, mesh_name=mesh_name, chips=world,
        n_active=n["active"], tokens=shape.tokens,
        kind="train" if shape.kind == "train" else "serve",
        dtype=lm.DTYPES[cfg.dtype])
    result = rep.to_dict()
    # the outputs an argument's storage holds were written in place
    mem = {"argument_size_in_bytes": sum(held.values()),
           "output_size_in_bytes": sum(n for k, n in made.items()
                                       if k not in held),
           "temp_size_in_bytes": cost.temp_bytes,
           "alias_size_in_bytes": sum(n for k, n in made.items()
                                      if k in held)}
    live = mem["argument_size_in_bytes"] + cost.temp_bytes
    result.update({
        "memory_analysis": mem,
        "live_bytes_per_device": live,
        "fits_hbm_80g": bool(live < HBM_BYTES),
        "launches_by_kernel": rep.by_kernel(),
        "collectives": {
            "counts": {k: v for k, v in counts.items() if k != "staged"},
            "bytes": {k: int(v) for k, v in cost.coll_bytes.items()}},
        "glue_ops": cost.glue_ops,
        "params_total": n["total"], "params_active": n["active"],
        "rules": {**part.DEFAULT_RULES, **rules},
        "schedule": SCHEDULE,
        "rank": rank, "coords": coords, "world": world,
        "seconds": round(seconds, 2),
        "ok": True,
    })
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape_name} (rank {rank}): "
              f"compute={rep.compute_t * 1e3:.2f}ms "
              f"memory={rep.memory_t * 1e3:.2f}/"
              f"{rep.memory_t_fused * 1e3:.2f}ms(raw/fused) "
              f"coll={rep.collective_t * 1e3:.2f}ms bound={rep.bound} "
              f"serial={rep.call_bound_ms:.2f}ms (kernels "
              f"{rep.bound_ms:.2f}, glue {rep.glue_ms:.2f}) "
              f"mfu={rep.mfu:.3f} useful={rep.useful_flops_ratio:.2f} "
              f"live={live / 1e9:.2f}GB/dev ({seconds:.1f}s)", flush=True)
    if keep_cost:
        result["cost"] = cost
    return result


def _rules(text: str) -> dict:
    out = {}
    for kv in filter(None, text.split(",")):
        k, _, v = kv.partition("=")
        out[k] = v if v else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--rules", default="",
                    help="logical rule overrides k=v,k2=v2 (v empty=None)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake world this process plays")
    args = ap.parse_args(argv)

    rules_override = _rules(args.rules)
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch, shape_name in cells:
        for mp in meshes:
            mesh_name = "multipod" if mp else "pod"
            tag = f"{arch}__{shape_name}__{mesh_name}"
            path = os.path.join(args.out, tag + ".json")
            if not cell_applicable(arch, shape_name):
                with open(path, "w") as f:
                    json.dump({"ok": True, "skipped": True,
                               "reason": "inapplicable (DESIGN.md §5)"}, f)
                print(f"[{mesh_name}] {arch} x {shape_name}: SKIP "
                      f"(documented)", flush=True)
                n_skip += 1
                continue
            try:
                result = run_cell(arch, shape_name, multi_pod=mp,
                                  rules_override=rules_override or None,
                                  microbatches=args.microbatches,
                                  rank=args.rank)
                n_ok += 1
            except Exception as e:
                traceback.print_exc()
                print(f"[{mesh_name}] {arch} x {shape_name}: FAILED "
                      f"{type(e).__name__}: {e}", flush=True)
                result = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                n_fail += 1
            with open(path, "w") as f:
                json.dump(result, f, indent=1)
    print(f"dry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
