"""The tensor-parallel shard context of serving.

The port's copy of the TP hooks of the JAX package's
``core/partitioning.py``. There they mark code traced inside a
``shard_map`` body over one mesh axis; here every rank of a
``torch.distributed`` process group runs the model on its own shard,
and the context names the group the row-parallel output projections
(attention ``wo``, the MLP down projection) sum their K-partial outputs
over (:func:`tp_reduce`) before the residual is added, and the
vocab-sharded head gathers its logit blocks over (:func:`tp_gather`).
``serve/placement.py`` opens the context around the engine's model
calls; with no group active every hook is a no-op, so the
single-device paths are untouched.

Each collective wrapper counts its launches in ``launches``, as the
kernel wrappers do. The logical-axis rules of the training mesh
(``resolve``, ``use_mesh``, ``constrain_tree``) wait for ROADMAP.md
queue 1 item 8b.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_ACTIVE: dict = {"tp_group": None}


@contextlib.contextmanager
def tp_shard(group):
    """Run the enclosed model calls as one rank of ``group``."""
    prev = _ACTIVE["tp_group"]
    _ACTIVE["tp_group"] = group
    try:
        yield
    finally:
        _ACTIVE["tp_group"] = prev


def tp_axis() -> Optional[dist.ProcessGroup]:
    """The active tensor-parallel group, or None outside a TP call."""
    return _ACTIVE["tp_group"]


def tp_reduce(y: torch.Tensor) -> torch.Tensor:
    """Sum a K-partial matmul output over the active group, in place
    (no-op without one). It must run BEFORE any residual add: a
    residual folded into a partial shard's epilogue would be summed
    once per rank."""
    group = _ACTIVE["tp_group"]
    if group is None:
        return y
    y = y.contiguous()
    dist.all_reduce(y, group=group)
    tp_reduce.launches += 1
    return y


def tp_gather(y: torch.Tensor) -> torch.Tensor:
    """Every rank's block of the last axis, concatenated in rank order
    (the tiled all-gather; no-op without an active group)."""
    group = _ACTIVE["tp_group"]
    if group is None:
        return y
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    tp_gather.launches += 1
    return torch.cat(parts, dim=-1)


tp_reduce.launches = 0
tp_gather.launches = 0
