"""AdamW on trees of tensors, the JAX package's ``optim/adamw.py`` line
for line: fp32 first and second moments whatever the parameter dtype,
the bias corrections ``1 - b ** step`` in fp32, ``delta = mh / (sqrt(vh)
+ eps) + wd * p``, the new parameter cast back to its dtype, and the
global-norm clip ``min(1, max_norm / max(norm, 1e-9))``. ``torch.optim
.AdamW`` orders the bias correction, ``eps`` and the decay otherwise
(it decays before the step), so it rounds differently; it is not used.
Every operation stays on the device: no host read.

Under a training mesh the optimizer state takes the parameters' specs
(:func:`state_specs`, ZeRO): each rank updates its own blocks, element
by element. The global norm counts each element once: a leaf's sum of
squares over this rank's block is all-reduced over the axes the leaf is
split over (its replicas hold the same block and are not summed again),
one all-reduce for every set of axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Zero fp32 moments beside every leaf, and step 0, on the leaves'
    device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_lib.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_lib.tree_map(zeros, params),
                      nu=tree_lib.tree_map(zeros, params))


def state_specs(param_specs) -> AdamWState:
    """Optimizer state inherits parameter logical specs (ZeRO-1)."""
    return AdamWState(step=(), mu=param_specs, nu=param_specs)


def global_norm(tree, shardings=None) -> torch.Tensor:
    """The l2 norm of every leaf together; ``shardings`` (a tree of
    ``partitioning.Sharding``) when the leaves are this rank's blocks."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_lib.leaves(tree)]
    if shardings is not None:
        from repro_torch.core import partitioning as part
        by_axes: dict = {}
        for i, s in enumerate(tree_lib.leaves(shardings)):
            if s.axes():
                by_axes.setdefault((s.mesh, s.axes()), []).append(i)
        for (mesh, axes), idx in by_axes.items():
            part_sums = torch.stack([sums[i] for i in idx])
            part.all_reduce(part_sums, mesh.group(axes))
            for j, i in enumerate(idx):
                sums[i] = part_sums[j]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_lib.tree_map(lambda g: g * scale, grads), norm


def apply(cfg: AdamWConfig, state: AdamWState, params, grads, lr_scale=1.0,
          shardings=None):
    """-> (new_params, new_state, grad_norm). The clipped gradient of a
    leaf is made where the leaf is updated (the same products as
    clipping the whole tree first, without a second copy of it).
    ``shardings``: the parameters' (``partitioning.Sharding``) when the
    leaves are this rank's blocks."""
    grads = tree_lib.tree_map(lambda g: g.to(torch.float32), grads)
    gnorm = global_norm(grads, shardings)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        p32 = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m, v

    flat = [tree_lib.leaves(t) for t in (params, grads, state.mu, state.nu)]
    out = [upd(*xs) for xs in zip(*flat)]
    new_p = tree_lib.unflatten(params, [o[0] for o in out])
    new_m = tree_lib.unflatten(params, [o[1] for o in out])
    new_v = tree_lib.unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), gnorm


def cosine_schedule(step, *, warmup: int, total: int, min_frac: float = 0.1):
    """LR multiplier: linear warmup then cosine decay to ``min_frac``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
