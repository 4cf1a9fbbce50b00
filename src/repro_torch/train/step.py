"""Train-step factory: microbatch accumulation, the NaN guard and the
learning-rate schedule, the JAX package's ``train/step.py`` on trees of
tensors.

A step makes no read of the device: the loss, the gradient norm and the
guard's flag stay tensors, and the guard keeps the old state with
``torch.where`` on the device. The caller reads ``metrics`` when it
prints. The gradients come from ``torch.autograd.grad`` of
``lm.loss_fn`` with respect to leaves made from the state's parameters
(``detach().requires_grad_()``: the state's own leaves never carry a
graph). Cross-pod gradient compression (``compress_pods``) is a
collective over a mesh, and waits with the mesh for ROADMAP.md queue 1
item 8b; so do ``state_logical_specs`` and ``param_specs``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.types import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import adamw

METRICS = ("loss", "aux_loss", "ntokens", "accuracy")


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


def _no_compression(tcfg: TrainConfig):
    if tcfg.compress_pods:
        raise NotImplementedError(
            "compress_pods: cross-pod gradient compression reduces over a "
            "'pod' mesh axis; not ported yet, ROADMAP.md queue 1 item 8b")


def init_state(params, tcfg: TrainConfig) -> TrainState:
    _no_compression(tcfg)
    return TrainState(params=params, opt=adamw.init(params), residual={})


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


def _apply_update(state: TrainState, grads, metrics, cfg, tcfg):
    lr_scale = adamw.cosine_schedule(
        state.opt.step, warmup=tcfg.warmup_steps, total=tcfg.total_steps)
    new_params, new_opt, gnorm = adamw.apply(
        tcfg.opt, state.opt, state.params, grads, lr_scale)
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (new_state, metrics)``;
    ``batch`` holds tensors on the state's device (``tokens``,
    ``labels`` and any ``extra`` of ``lm.forward``)."""
    _no_compression(tcfg)

    def train_step(state: TrainState, batch):
        grads, metrics = _grads_and_metrics(state.params, batch, cfg, tcfg)
        return _apply_update(state, grads, metrics, cfg, tcfg)
    return train_step
