"""Parameters of the JAX package, as the port's tensors.

The caller hands over the JAX parameter pytree as nested dicts and lists
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), so the
port never sees JAX; both packages then compute the same function from
the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.swin_t import SwinConfig, ViTConfig
from repro_torch.core import runtime


def _tensor(leaf, device):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":         # ml_dtypes' bfloat16
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))    # a writable copy
    return t.to(device)


def _convert(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def _check(tree, cfg):
    if isinstance(cfg, SwinConfig):
        depths = tuple(len(s["blocks"]) for s in tree["stages"])
        merges = sum("merge" in s for s in tree["stages"])
        if depths != tuple(cfg.depths) or merges != len(cfg.depths) - 1:
            raise ValueError(f"tree has stage depths {depths} and {merges} "
                             f"merges; {cfg.name} wants {cfg.depths}")
    elif isinstance(cfg, ViTConfig):
        if len(tree["blocks"]) != cfg.depth:
            raise ValueError(f"tree has {len(tree['blocks'])} blocks; "
                             f"{cfg.name} wants {cfg.depth}")
    else:
        raise TypeError(f"no vision config: {type(cfg).__name__}")
    if tree["patch_w"].shape != (cfg.patch * cfg.patch * cfg.in_chans,
                                 cfg.embed_dim):
        raise ValueError(f"patch_w {tuple(tree['patch_w'].shape)} does "
                         f"not fit {cfg.name}")


def from_jax_params(tree, cfg, device="cuda"):
    """The JAX package's Swin/ViT parameter tree (numpy leaves) as a tree
    of tensors on ``device``. Keys the JAX initializer leaves out (the
    last stage's ``merge``) stay out; ``None`` leaves (``norm_g`` and
    ``norm_b`` before they are set) stay ``None``."""
    device = runtime.resolve_device(device)
    out = _convert(tree, device)
    _check(out, cfg)
    return out
