"""Block assembly from BlockDefs.

A block = pre-norm mixer (+ residual) then pre-norm FFN (+ residual),
with the mixer/FFN kinds taken from the config's stage compilation. The
port runs the ``attn`` mixer (global: no sliding window) with the
``mlp`` FFN, and the RWKV6 pair (the ``rwkv6`` time-mix mixer and the
``rwkv6_cmix`` channel-mix FFN), in modes ``train``, ``prefill`` and
``decode``. The other kinds raise, naming the ROADMAP.md item that
ports them. All dense ops route through the row-wise primitive.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import runtime
from repro_torch.core.types import BlockDef, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, mlp, rwkv6

MODES = ("train", "prefill", "decode")

# block kinds of the JAX package the port does not run yet
_PENDING = {
    "mamba2": "mamba2 mixer: ROADMAP.md queue 1 item 8",
    "moe": "MoE FFN: ROADMAP.md queue 1 item 8",
    "cross_attn": "cross-attention: ROADMAP.md queue 1 item 4 "
                  "(encoder-decoder)",
    "window": "sliding-window attention: ROADMAP.md queue 1 item 4 "
              "(gemma3's ring buffer)",
    "chunk": "chunked prefill: ROADMAP.md queue 1 item 5 (paged serving)",
    "verify": "speculative verify: ROADMAP.md queue 1 item 5 (paged "
              "serving)",
}


def _pending(kind: str):
    return NotImplementedError(f"not ported yet: {_PENDING[kind]}")


def _check(blk: BlockDef, mode: str = "train"):
    if mode not in MODES:
        raise _pending(mode) if mode in _PENDING else ValueError(
            f"mode {mode!r}")
    for kind in (blk.mixer, blk.ffn):
        if kind in _PENDING:
            raise _pending(kind)
    if blk.cross_attn:
        raise _pending("cross_attn")
    if blk.window:
        raise _pending("window")


def _norm_init(cfg: ModelConfig, stack, dtype, device):
    lead = () if stack is None else (stack,)
    p = {"g": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layer":
        p["b"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                             device=device)
    return p


def _norm_apply(p, x, cfg: ModelConfig):
    return ops.layernorm(x, p["g"], p.get("b"), kind=cfg.norm)


def _norm_spec(p, cfg: ModelConfig) -> ops.NormSpec:
    return ops.NormSpec(cfg.norm, p["g"], p.get("b"))


def init_block(gen: torch.Generator, blk: BlockDef, cfg: ModelConfig,
               stack, dtype, device):
    _check(blk)
    params = {"norm1": _norm_init(cfg, stack, dtype, device)}
    if blk.mixer == "attn":
        params["attn"] = attention.init(gen, cfg, stack, dtype, device)
    elif blk.mixer == "rwkv6":
        params["tmix"] = rwkv6.init(gen, cfg, stack, dtype, device)
    if blk.ffn != "none":
        params["norm2"] = _norm_init(cfg, stack, dtype, device)
    if blk.ffn == "mlp":
        params["ffn"] = mlp.init(gen, cfg, stack, dtype, device)
    elif blk.ffn == "rwkv6_cmix":
        params["ffn"] = mlp.init_cmix(gen, cfg, stack, dtype, device)
    return params


class BlockIO(NamedTuple):
    """Everything a block may consume/produce besides the hidden state."""
    aux: float = 0.0                      # aux loss (MoE only)
    new_cache: Any = None                 # decode: updated cache slice
    prefill_state: Any = None             # prefill: mixer state


def apply_block(blk: BlockDef, params, x, *, cfg: ModelConfig, mode: str,
                positions=None, lengths=None, cache=None) -> tuple:
    """mode: 'train' | 'prefill' | 'decode'. ``positions``: (B, S) RoPE
    positions (train, prefill); ``lengths``: (B,) tokens already in the
    cache (decode); ``cache``: this layer's slice of the decode cache.
    The attention KV is written into that slice in place, so it is not
    in the returned ``new_cache``. Returns (x, BlockIO)."""
    _check(blk, mode)
    new_cache = {}
    prefill_state = {}
    # Fused pipeline: the attn/mlp sublayers take the RAW hidden state
    # plus a NormSpec — the pre-norm runs as the qkv / gate-up kernel
    # prologue and the residual add rides the output projection's
    # epilogue.
    fuse = runtime.pipeline_fusion()

    if blk.mixer == "attn":
        nspec = _norm_spec(params["norm1"], cfg) if fuse else None
        h = x if fuse else _norm_apply(params["norm1"], x, cfg)
        res = x if fuse else None
        if mode == "decode":
            out, _ = attention.decode_apply(
                params["attn"], h, cache["kv"], cfg=cfg, lengths=lengths,
                norm=nspec, residual=res)
        else:
            out, (k, v) = attention.apply(params["attn"], h, cfg=cfg,
                                          positions=positions, causal=True,
                                          norm=nspec, residual=res)
            if mode == "prefill":
                prefill_state["kv"] = (k, v)
        x = out if fuse else x + out
    elif blk.mixer == "rwkv6":
        h = _norm_apply(params["norm1"], x, cfg)
        state = cache["rwkv_t"] if mode == "decode" else None
        out, (x_last, wkv) = rwkv6.apply(params["tmix"], h, cfg=cfg,
                                         state=state)
        if mode in ("decode", "prefill"):
            st = {"x_prev_t": x_last, "wkv": wkv}
            if mode == "decode":
                new_cache["rwkv_t"] = st
            else:
                prefill_state["rwkv_t"] = st
        x = x + out

    if blk.ffn == "mlp":
        if fuse:
            x = mlp.apply(params["ffn"], x, cfg=cfg,
                          norm=_norm_spec(params["norm2"], cfg), residual=x)
        else:
            h = _norm_apply(params["norm2"], x, cfg)
            x = x + mlp.apply(params["ffn"], h, cfg=cfg)
    elif blk.ffn == "rwkv6_cmix":
        h = _norm_apply(params["norm2"], x, cfg)
        x_last_c = (cache["rwkv_c"]["x_prev_c"] if mode == "decode"
                    else torch.zeros_like(h[:, 0]))
        hp = rwkv6._token_shift(h, x_last_c)
        out = mlp.apply_cmix(params["ffn"], h, hp)
        if mode == "decode":
            new_cache["rwkv_c"] = {"x_prev_c": h[:, -1]}
        elif mode == "prefill":
            prefill_state["rwkv_c"] = {"x_prev_c": h[:, -1]}
        x = x + out
    return x, BlockIO(new_cache=new_cache or None,
                      prefill_state=prefill_state or None)
