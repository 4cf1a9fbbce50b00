"""A parameter tree held by an ``nn.Module``, and the initialisers'
random draws.

The functional forwards take trees of nested dicts and lists of tensors,
the JAX package's trees; the model modules hold one as frozen
parameters.
"""
from __future__ import annotations

import torch
from torch import nn


def randn(gen, shape) -> torch.Tensor:
    """fp32 standard normals of ``shape`` drawn from ``gen`` on its own
    device; with no generator, a tensor on the meta device (the shape
    alone: ``lm.param_shapes``)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


class ParamTree(nn.Module):
    """A parameter tree (dicts, lists, tensors, None) held as frozen
    ``nn.Parameter``s, so ``.to()``/``state_dict()`` see every leaf;
    :meth:`tree` gives the nested dicts back for the functional
    forwards."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, list):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v) for v in value))
            elif value is None:
                self.register_parameter(key, None)
            else:
                raise TypeError(f"{key}: {type(value).__name__} leaf")

    def tree(self) -> dict:
        out = {}
        for key in self._keys:
            value = getattr(self, key)
            if isinstance(value, ParamTree):
                value = value.tree()
            elif isinstance(value, nn.ModuleList):
                value = [v.tree() for v in value]
            out[key] = value
        return out
