"""Abstract input and state specs for every (arch x shape) cell, the
port's counterpart of the JAX package's ``launch/specs.py``.

Everything here lives on the ``meta`` device: shapes and dtypes, no
allocation, no data (JAX's ``ShapeDtypeStruct`` stand-ins). The
parameter tree is ``lm.param_shapes``, :func:`lm.init_lm`'s tree on
``meta``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.types import ModelConfig, ShapeSpec
from repro_torch.models import lm


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on ``meta``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract model inputs for one cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": sds((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = sds((b, s), torch.int32)
        if cfg.frontend == "audio":
            specs["frames"] = sds((b, cfg.cross_len, cfg.d_model),
                                  torch.bfloat16)
        if cfg.frontend == "vision":
            n_patches = min(1024, s // 4)
            specs["vis_embeds"] = sds((b, n_patches, cfg.d_model),
                                      torch.bfloat16)
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"tokens": sds((b, 1), torch.int32),
            "lengths": sds((b,), torch.int32)}


def abstract_init(cfg: ModelConfig, dtype=None) -> Tuple:
    """(params on meta, logical specs): the structure without
    allocation. ``dtype`` defaults to the config's."""
    params = lm.init_lm(cfg, None, device="meta", dtype=dtype)
    return params, lm.logical_specs(cfg)


def abstract_train_state(cfg: ModelConfig, tcfg) -> Tuple:
    """(TrainState on meta, TrainState logical specs)."""
    from repro_torch.train import step as train_step_lib
    params, pspecs = abstract_init(cfg)
    state = train_step_lib.init_state(params, tcfg)
    return state, train_step_lib.state_logical_specs(pspecs, tcfg)


def abstract_cache(cfg: ModelConfig, batch: int, alloc: int):
    cache = lm.init_cache(cfg, batch, alloc, torch.bfloat16, device="meta")
    return cache, lm.cache_logical_specs(cache)


def param_count(cfg: ModelConfig) -> dict:
    """Exact N (and active N for MoE) from the abstract parameter tree,
    the vocab and expert padding taken out."""
    params, _ = abstract_init(cfg)
    total = sum(x.numel() for x in tree_lib.leaves(params))
    pad = (lm.padded_vocab(cfg) - cfg.vocab) * cfg.d_model
    total -= pad * (1 if cfg.tie_embeddings else 2)
    if cfg.moe is not None:
        from repro_torch.models.moe import padded_experts
        e_pad = padded_experts(cfg) - cfg.moe.n_experts
        per_expert = 3 * cfg.d_model * cfg.moe.d_ff
        total -= (e_pad * per_expert + e_pad * cfg.d_model) * cfg.n_layers
    active = total
    if cfg.moe is not None:
        mo = cfg.moe
        # routed expert leaves: wi/wg/wo carry the n_experts dim
        inactive_frac = (mo.n_experts - mo.top_k) / mo.n_experts
        expert_params = 0
        for stage_p in params["stages"]:
            for blk in stage_p["stacked"].values():
                ffn = blk.get("ffn", {})
                for name in ("wi", "wg", "wo"):
                    if name in ffn:
                        expert_params += ffn[name].numel()
        active = total - int(expert_params * inactive_frac)
    return {"total": total, "active": active}
