"""Block assembly from BlockDefs.

A block = pre-norm mixer (+ residual), then, in a decoder block of an
encoder-decoder arch, pre-norm cross-attention to the encoder's output
(+ residual), then pre-norm FFN (+ residual), with the kinds taken from
the config's stage compilation: the ``attn`` mixer (global or
sliding-window, with or without cross-attention), the ``mamba2`` mixer
(zamba2) and the ``rwkv6`` time-mix, and the ``mlp``, ``moe`` and
``rwkv6_cmix`` FFNs (or none), in modes ``train``, ``prefill`` and
``decode`` (dense or paged), and the paged serving modes ``chunk`` and
``verify`` of the attention-only archs. All dense ops route through the
row-wise primitive.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import runtime
from repro_torch.core.types import BlockDef, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, mamba2, mlp, moe, rwkv6

MODES = ("train", "prefill", "decode", "chunk", "verify")


def _check(blk: BlockDef, mode: str = "train"):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}")
    if mode in ("chunk", "verify") and (blk.mixer != "attn"
                                        or blk.cross_attn):
        raise ValueError(
            "chunked prefill requires every position's state to be "
            f"causal-attention KV; {blk.mixer}/cross_attn blocks must "
            "prefill in one shot (paging.supports_bucketing)")


def _norm_init(cfg: ModelConfig, stack, dtype, device):
    lead = () if stack is None else (stack,)
    p = {"g": torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layer":
        p["b"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                             device=device)
    return p


def _norm_specs(cfg: ModelConfig, stack):
    ll = () if stack is None else ("layers",)
    s = {"g": ll + (None,)}
    if cfg.norm == "layer":
        s["b"] = ll + (None,)
    return s


def _norm_apply(p, x, cfg: ModelConfig):
    return ops.layernorm(x, p["g"], p.get("b"), eps=cfg.norm_eps,
                         kind=cfg.norm)


def _norm_spec(p, cfg: ModelConfig) -> ops.NormSpec:
    return ops.NormSpec(cfg.norm, p["g"], p.get("b"), cfg.norm_eps)


def init_block(gen: torch.Generator, blk: BlockDef, cfg: ModelConfig,
               stack, dtype, device):
    _check(blk)
    params = {"norm1": _norm_init(cfg, stack, dtype, device)}
    if blk.mixer == "attn":
        params["attn"] = attention.init(gen, cfg, stack, dtype, device)
    elif blk.mixer == "mamba2":
        params["mamba"] = mamba2.init(gen, cfg, stack, dtype, device)
    elif blk.mixer == "rwkv6":
        params["tmix"] = rwkv6.init(gen, cfg, stack, dtype, device)
    if blk.cross_attn:
        params["norm_x"] = _norm_init(cfg, stack, dtype, device)
        params["cross"] = attention.init(gen, cfg, stack, dtype, device,
                                         cross=True)
    if blk.ffn != "none":
        params["norm2"] = _norm_init(cfg, stack, dtype, device)
    if blk.ffn == "mlp":
        params["ffn"] = mlp.init(gen, cfg, stack, dtype, device)
    elif blk.ffn == "moe":
        params["ffn"] = moe.init(gen, cfg, stack, dtype, device)
    elif blk.ffn == "rwkv6_cmix":
        params["ffn"] = mlp.init_cmix(gen, cfg, stack, dtype, device)
    return params


def block_logical_specs(blk: BlockDef, cfg: ModelConfig, stack):
    """The logical axis names of :func:`init_block`'s leaves (the JAX
    package's ``init_block`` specs), from the config alone."""
    specs = {"norm1": _norm_specs(cfg, stack)}
    if blk.mixer == "attn":
        specs["attn"] = attention.logical_specs(stack)
    elif blk.mixer == "mamba2":
        specs["mamba"] = mamba2.logical_specs(stack)
    elif blk.mixer == "rwkv6":
        specs["tmix"] = rwkv6.logical_specs(stack)
    if blk.cross_attn:
        specs["norm_x"] = _norm_specs(cfg, stack)
        specs["cross"] = attention.logical_specs(stack, cross=True)
    if blk.ffn != "none":
        specs["norm2"] = _norm_specs(cfg, stack)
    if blk.ffn == "mlp":
        specs["ffn"] = mlp.logical_specs(cfg, stack)
    elif blk.ffn == "moe":
        specs["ffn"] = moe.logical_specs(cfg, stack)
    elif blk.ffn == "rwkv6_cmix":
        specs["ffn"] = mlp.cmix_logical_specs(stack)
    return specs


class BlockIO(NamedTuple):
    """Everything a block may consume/produce besides the hidden state."""
    aux: Any = 0.0                        # aux loss (a tensor: MoE)
    new_cache: Any = None                 # decode: updated cache slice
    prefill_state: Any = None             # prefill / verify: mixer state


def apply_block(blk: BlockDef, params, x, *, cfg: ModelConfig, mode: str,
                positions=None, lengths=None, cache=None, enc_out=None,
                pages=None, chunk_len=None, targets=None,
                window_override: Optional[int] = None) -> tuple:
    """mode: 'train' | 'prefill' | 'decode' | 'chunk' | 'verify'.
    ``positions``: (B, S) RoPE positions (train, prefill); ``lengths``:
    (B,) tokens already in the cache (decode, chunk, verify); ``cache``:
    this layer's slice of the decode cache; ``enc_out``: the encoder's
    output, (B, T, d), which cross-attention reads at train and prefill;
    ``window_override``: the window in place of the block's own (0 in
    the encoder). The attention KV is written into the cache slice in
    place and the cross KV is read from it, so neither is in the
    returned ``new_cache``.

    pages: (B, max_pages) block table of paged decode, chunk and verify
    (the cache's KV leaf is then a ``PagedKVCache`` pool). 'chunk' is
    chunked prefill: x is a row panel of prompt tokens at position
    offset ``lengths`` of which the first ``chunk_len`` are real;
    attention layers attend prefix pages + the in-flight chunk and
    append their KV (``targets``: ``attention.chunk_targets`` of the
    call, by window). 'verify' scores a speculative panel the same way
    but leaves the pool as it is: each layer returns the panel's (k, v)
    as ``prefill_state``. Only causal-attention blocks without
    cross-attention take these two modes. Returns (x, BlockIO)."""
    _check(blk, mode)
    aux = 0.0
    new_cache = {}
    prefill_state = {}
    window = blk.window if window_override is None else window_override
    # Fused pipeline: the attn/mlp sublayers take the RAW hidden state
    # plus a NormSpec — the pre-norm runs as the qkv / gate-up kernel
    # prologue and the residual add rides the output projection's
    # epilogue.
    fuse = runtime.pipeline_fusion()

    if blk.mixer == "attn":
        nspec = _norm_spec(params["norm1"], cfg) if fuse else None
        h = x if fuse else _norm_apply(params["norm1"], x, cfg)
        res = x if fuse else None
        if mode == "decode" and isinstance(cache["kv"],
                                           attention.PagedKVCache):
            out, _ = attention.paged_decode_apply(
                params["attn"], h, cache["kv"], cfg=cfg, lengths=lengths,
                pages=pages, window=window, norm=nspec, residual=res)
        elif mode == "decode":
            out, _ = attention.decode_apply(
                params["attn"], h, cache["kv"], cfg=cfg, lengths=lengths,
                window=window, norm=nspec, residual=res)
        elif mode == "chunk":
            out, _ = attention.paged_chunk_apply(
                params["attn"], h, cache["kv"], cfg=cfg, offset=lengths,
                chunk_len=chunk_len, pages=pages, window=window,
                norm=nspec, residual=res,
                targets=None if targets is None else targets[window])
        elif mode == "verify":
            out, (k, v) = attention.paged_verify_apply(
                params["attn"], h, cache["kv"], cfg=cfg, offset=lengths,
                chunk_len=chunk_len, pages=pages, window=window,
                norm=nspec, residual=res)
            prefill_state["kv"] = (k, v)
        else:
            # causal in the encoder too, as the JAX package's block runs
            # it (its non-causal stages only drop the window)
            out, (k, v) = attention.apply(params["attn"], h, cfg=cfg,
                                          positions=positions,
                                          window=window, causal=True,
                                          norm=nspec, residual=res)
            if mode == "prefill":
                prefill_state["kv"] = (k, v)
        x = out if fuse else x + out
    elif blk.mixer == "mamba2":
        h = _norm_apply(params["norm1"], x, cfg)
        state = cache["mamba"] if mode == "decode" else None
        out, s_new = mamba2.apply(params["mamba"], h, cfg=cfg, state=state)
        if mode == "decode":
            new_cache["mamba"] = s_new
        elif mode == "prefill":
            prefill_state["mamba"] = s_new
        x = x + out
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

    if blk.cross_attn:
        # the cross pre-norm is standalone in both pipelines, as in JAX
        h = _norm_apply(params["norm_x"], x, cfg)
        if mode == "decode":
            # the cross K/V are fixed after prefill: heads from the cache
            xk, xv = cache["cross_kv"]
            b = h.shape[0]
            hq, hd = cfg.n_heads, cfg.head_dim
            q = ops.matmul(h, params["cross"]["wq"]).reshape(b, 1, hq, hd)
            out = attention.chunked_attention(
                q.transpose(1, 2), xk.transpose(1, 2), xv.transpose(1, 2),
                causal=False, window=0)
            out = ops.matmul(out.transpose(1, 2).reshape(b, 1, hq * hd),
                             params["cross"]["wo"])
        else:
            out, (ck, cv) = attention.apply(
                params["cross"], h, cfg=cfg, positions=positions,
                causal=False, kv=(enc_out, enc_out))
            if mode == "prefill":
                prefill_state["cross_kv"] = (ck, cv)
        x = x + out

    if blk.ffn == "mlp":
        if fuse:
            x = mlp.apply(params["ffn"], x, cfg=cfg,
                          norm=_norm_spec(params["norm2"], cfg), residual=x)
        else:
            h = _norm_apply(params["norm2"], x, cfg)
            x = x + mlp.apply(params["ffn"], h, cfg=cfg)
    elif blk.ffn == "moe":
        h = _norm_apply(params["norm2"], x, cfg)
        out, aux_l = moe.apply(params["ffn"], h, cfg=cfg)
        x = x + out
        aux = aux + aux_l
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
    return x, BlockIO(aux=aux, new_cache=new_cache or None,
                      prefill_state=prefill_state or None)
