"""Train-step factory: microbatch accumulation, the NaN guard and the
learning-rate schedule, the JAX package's ``train/step.py`` on trees of
tensors.

A step makes no read of the device: the loss, the gradient norm and the
guard's flag stay tensors, and the guard keeps the old state with
``torch.where`` on the device. The caller reads ``metrics`` when it
prints. The gradients come from ``torch.autograd.grad`` of
``lm.loss_fn`` with respect to leaves made from the state's parameters
(``detach().requires_grad_()``: the state's own leaves never carry a
graph).

Under a mesh (``make_train_step(..., mesh=, param_specs=)``) the state
is this rank's blocks, sharded by :func:`state_logical_specs` (the
moments take the parameters' specs, ZeRO) and cut by
:func:`state_shardings` / :func:`shard_state`. A step takes the global
batch on every rank and keeps its rows (each batch key split along its
own batch axis by ``resolve(("batch", ...))``: ``positions3`` is (3, B,
S)); the model gathers each parameter where it reads it
(``partitioning.fsdp``: a stacked leaf one repeat at a time, inside the
repeat's recomputation, so the backward gathers again), the gathers'
backward reduce-scatters each gradient to its block, and the block is
then all-reduced over the mesh axes the leaf is not split over, so that
it is the gradient of the global loss. The loss counts each row once,
the metrics are global and the non-finite guard decides alike on every
rank. With ``compress_pods`` the step is manual over ``pod``: each pod
runs that step on its block of the batch over ``data`` and ``model``,
and the pods' gradients meet in the int8 error-feedback mean
(``optim/compression.py``), the residual sharded like the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import partitioning as part
from repro_torch.core import tree as tree_lib
from repro_torch.core.types import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import adamw, compression

METRICS = ("loss", "aux_loss", "ntokens", "accuracy")
# the batch keys whose batch axis is not their first
BATCH_AXIS = {"positions3": 1}
# elements a bucket of the gradients' all-reduce holds at most
BUCKET = 1 << 26


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1           # gradient accumulation
    compress_pods: bool = False     # int8+EF cross-pod gradient reduce
    remat: bool = True
    skip_nonfinite: bool = True     # fault tolerance: skip bad steps


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    residual: Any                   # EF buffer (empty dict if unused)


def init_state(params, tcfg: TrainConfig) -> TrainState:
    res = compression.init_residual(params) if tcfg.compress_pods else {}
    return TrainState(params=params, opt=adamw.init(params), residual=res)


def state_logical_specs(param_specs, tcfg: TrainConfig) -> TrainState:
    res = param_specs if tcfg.compress_pods else {}
    return TrainState(params=param_specs,
                      opt=adamw.state_specs(param_specs), residual=res)


def _manual(tcfg: TrainConfig):
    return ("pod",) if tcfg.compress_pods else ()


def state_shardings(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                    param_specs=None) -> TrainState:
    """The tree of ``partitioning.Sharding`` of a train state on
    ``mesh``, resolved at the global shapes (``pod`` manual under
    ``compress_pods``: the pods hold replicas)."""
    if tcfg.compress_pods and "pod" not in mesh.axis_names:
        raise ValueError(f"compress_pods needs a 'pod' axis: {mesh.sizes}")
    specs = state_logical_specs(
        param_specs if param_specs is not None else lm.logical_specs(cfg),
        tcfg)
    like = lm.param_shapes(cfg)
    with part.use_mesh(mesh), part.manual_axes(_manual(tcfg)):
        params = part.tree_shardings(mesh, specs.params, like=like)
    scalar = part.Sharding(mesh, (), ())
    return TrainState(params=params,
                      opt=adamw.AdamWState(step=scalar, mu=params,
                                           nu=params),
                      residual=params if tcfg.compress_pods else {})


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """This rank's blocks of a full train state."""
    return part.shard_tree(state, shardings)


def fuse_state(state: TrainState, cfg: ModelConfig) -> TrainState:
    """Migrate a seed-layout TrainState (split wq/wk/wv, wg/wi leaves) to
    the fused layout, so old training checkpoints keep resuming. The
    AdamW moments are per element, so concatenating mu and nu beside
    the parameters is exact (the global-norm clip sums over leaves,
    whatever their grouping)."""
    def fuse(tree):
        return lm.fuse_params(cfg, tree)
    opt = state.opt._replace(mu=fuse(state.opt.mu), nu=fuse(state.opt.nu))
    res = fuse(state.residual) if state.residual else state.residual
    return TrainState(params=fuse(state.params), opt=opt, residual=res)


def _value_and_grad(params, batch, cfg, tcfg):
    """(metrics, grads) of ``lm.loss_fn`` at ``params``."""
    flat = [p.detach().requires_grad_(True)
            for p in tree_lib.leaves(params)]
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(tree_lib.unflatten(params, flat), batch,
                                   cfg, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_lib.unflatten(params, grads)


def _grads_and_metrics(params, batch, cfg, tcfg):
    if tcfg.microbatches <= 1:
        metrics, grads = _value_and_grad(params, batch, cfg, tcfg)
        return grads, metrics

    n = tcfg.microbatches
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_lib.leaves(params)]
    dev = g_acc[0].device
    m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in METRICS}
    for i in range(n):
        mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
              for k, v in batch.items()}
        m, g = _value_and_grad(params, mb, cfg, tcfg)
        g_acc = [a + b.to(torch.float32) / n
                 for a, b in zip(g_acc, tree_lib.leaves(g))]
        m_acc = {k: m_acc[k] + m[k] / n for k in m_acc}
    return tree_lib.unflatten(params, g_acc), m_acc


def _apply_update(state: TrainState, grads, metrics, cfg, tcfg,
                  shardings=None):
    lr_scale = adamw.cosine_schedule(
        state.opt.step, warmup=tcfg.warmup_steps, total=tcfg.total_steps)
    new_params, new_opt, gnorm = adamw.apply(
        tcfg.opt, state.opt, state.params, grads, lr_scale, shardings)
    metrics = dict(metrics)
    metrics["grad_norm"] = gnorm
    metrics["lr_scale"] = lr_scale
    if tcfg.skip_nonfinite:
        ok = torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm)
        old_opt = state.opt._replace(step=state.opt.step + 1)

        def keep(new, old):
            # written into ``new`` (no third copy of the state): where
            # the step is bad, the old leaf bit for bit
            return torch.where(ok, new, old, out=new)
        new_params = tree_lib.tree_map(keep, new_params, state.params)
        new_opt = tree_lib.tree_map(keep, new_opt, old_opt)
        metrics["skipped"] = (~ok).to(torch.float32)
    return TrainState(params=new_params, opt=new_opt,
                      residual=state.residual), metrics


def _rows(batch, axis_of, idx: int, n: int):
    """Block ``idx`` of ``n`` of every key along its batch axis."""
    out = {}
    for k, v in batch.items():
        ax = axis_of.get(k, 0)
        if v.shape[ax] % n:
            raise ValueError(f"batch key {k!r} of {tuple(v.shape)} does "
                             f"not split {n} ways along axis {ax}")
        step = v.shape[ax] // n
        out[k] = v.narrow(ax, idx * step, step)
    return out


def split_batch(batch, mesh):
    """This rank's rows of a global batch on the active mesh (the
    non-manual axes that ``resolve(("batch",))`` gives at its size), and
    those axes."""
    sizes = {v.shape[BATCH_AXIS.get(k, 0)] for k, v in batch.items()}
    if len(sizes) != 1:
        raise ValueError(f"batch keys of different batch sizes: {sizes}")
    spec = part.resolve(("batch",), mesh, shape=(sizes.pop(),))
    axes = part.spec_axes(spec[0])
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.sizes[a] + mesh.coord(a)
        n *= mesh.sizes[a]
    return _rows(batch, BATCH_AXIS, idx, n), axes


def _reduce_grads(grads, shardings, mesh):
    """All-reduce each gradient block over the (non-manual) axes its leaf
    is not split over, in buckets of leaves that share those axes."""
    auto = part.auto_axes(mesh)
    groups: dict = {}
    for i, s in enumerate(shardings):
        rest = tuple(a for a in auto if a not in s.axes())
        if rest:
            groups.setdefault(rest, []).append(i)
    grads = list(grads)
    for rest, idx in groups.items():
        bucket: list = []

        def flush(bucket=bucket):
            if not bucket:
                return
            # each block flattened in its memory order, and put back in
            # its layout
            orders = [part.memory_order(grads[i]) for i in bucket]
            flat = torch.cat([grads[i].permute(o).reshape(-1)
                              for i, o in zip(bucket, orders)])
            part.all_reduce(flat, mesh.group(rest))
            for i, o, chunk in zip(bucket, orders, flat.split(
                    [grads[i].numel() for i in bucket])):
                grads[i] = chunk.view([grads[i].shape[d] for d in o]
                                      ).permute([o.index(d) for d in
                                                 range(len(o))])
            bucket.clear()
        size = 0
        for i in idx:
            if size + grads[i].numel() > BUCKET:
                flush()
                size = 0
            bucket.append(i)
            size += grads[i].numel()
        flush()
    return grads


def _mesh_value_and_grad(params, batch, cfg, tcfg, mesh, flat_sh):
    """(metrics, gradient blocks) of the global ``batch`` on this rank."""
    local, axes = split_batch(batch, mesh)
    flat = [p.detach().requires_grad_(True)
            for p in tree_lib.leaves(params)]
    with part.batch_split(axes), part.fsdp(flat, flat_sh), \
            torch.enable_grad():
        loss, metrics = lm.loss_fn(tree_lib.unflatten(params, flat), local,
                                   cfg, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    grads = _reduce_grads(grads, flat_sh, mesh)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_lib.unflatten(params, grads)


def _mesh_grads_and_metrics(params, batch, cfg, tcfg, mesh, flat_sh):
    n = tcfg.microbatches
    if n <= 1:
        metrics, grads = _mesh_value_and_grad(params, batch, cfg, tcfg,
                                              mesh, flat_sh)
        return grads, metrics
    # microbatch i is rows block i of the GLOBAL batch, then split
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_lib.leaves(params)]
    dev = g_acc[0].device
    m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in METRICS}
    for i in range(n):
        m, g = _mesh_value_and_grad(params, _rows(batch, BATCH_AXIS, i, n),
                                    cfg, tcfg, mesh, flat_sh)
        g_acc = [a + b.to(torch.float32) / n
                 for a, b in zip(g_acc, tree_lib.leaves(g))]
        m_acc = {k: m_acc[k] + m[k] / n for k in m_acc}
    return tree_lib.unflatten(params, g_acc), m_acc


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    param_specs=None):
    """Returns ``train_step(state, batch) -> (new_state, metrics)``;
    ``batch`` holds tensors on the state's device (``tokens``,
    ``labels`` and any ``extra`` of ``lm.forward``).

    With ``mesh`` (a ``partitioning.Mesh``), the sharded step of the
    module's docstring: ``state`` is this rank's blocks
    (:func:`shard_state` of :func:`state_shardings` with the same
    ``param_specs``, default ``lm.logical_specs(cfg)``) and ``batch``
    the global batch. The step's ``grads_and_metrics(state, batch)``
    gives the gradient blocks (before compression) and the metrics."""
    if mesh is None:
        if tcfg.compress_pods:
            raise ValueError("compress_pods reduces over the 'pod' axis of "
                             "a mesh: pass mesh=")

        def train_step(state: TrainState, batch):
            grads, metrics = _grads_and_metrics(state.params, batch, cfg,
                                                tcfg)
            return _apply_update(state, grads, metrics, cfg, tcfg)
        return train_step

    shardings = state_shardings(cfg, tcfg, mesh, param_specs).params
    flat_sh = tree_lib.leaves(shardings)
    manual = _manual(tcfg)

    def rows_of_pod(batch):
        if not manual:
            return batch
        return _rows(batch, BATCH_AXIS, mesh.coord("pod"),
                     mesh.sizes["pod"])

    def grads_and_metrics(state: TrainState, batch):
        with part.use_mesh(mesh), part.manual_axes(manual):
            return _mesh_grads_and_metrics(state.params, rows_of_pod(batch),
                                           cfg, tcfg, mesh, flat_sh)

    def train_step(state: TrainState, batch):
        grads, metrics = grads_and_metrics(state, batch)
        if manual:
            pods = mesh.group(("pod",))
            grads, res = compression.compressed_pmean_tree(
                grads, state.residual, pods, shardings)
            n = mesh.sizes["pod"]
            metrics = {k: part.all_reduce(v.to(torch.float32).clone(), pods)
                       / n for k, v in metrics.items()}
            state = state._replace(residual=res)
        return _apply_update(state, grads, metrics, cfg, tcfg, shardings)
    train_step.grads_and_metrics = grads_and_metrics
    train_step.shardings = shardings
    return train_step
