"""Mixture-of-Experts FFN with token-choice top-k routing.

The JAX package's local path (no mesh): capacity-based scatter/gather
dispatch over the whole batch. The router, the dispatch and the experts
are jnp there, outside any Pallas kernel, so here they are torch ops:
the router product and the expert SwiGLU einsums in fp32, as in JAX.
The expert-parallel path (``_apply_ep``, an all-to-all over the mesh's
'model' axis) comes with the training mesh (ROADMAP.md queue 1 item 8b).

Experts are padded up to a multiple of the model axis (qwen2-moe's 60
-> 64) with router logits masked to -1e30: routing never reaches pads.
Shared experts (qwen2-moe) run as a dense sigmoid-gated MLP on the
side. Aux load-balance loss follows Shazeer et al. (f_e * P_e).

Capacity is per call: ``cap = max(int(t k / E * capacity_factor), k)``
over the call's t = B * S tokens, assigned in token order. So in a
serving engine's decode step the idle slots' rows compete for capacity
with the live ones, as they do in the JAX engine.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.types import ModelConfig

MODEL_AXIS_FOR_PADDING = 16


def padded_experts(cfg: ModelConfig) -> int:
    e = cfg.moe.n_experts
    m = MODEL_AXIS_FOR_PADDING
    return -(-e // m) * m if e >= m else e


def init(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
         dtype, device):
    """FFN parameters (stacked over ``stack`` layers when given), drawn
    on the generator's device: the JAX package's tree of keys, shapes
    and dtypes."""
    mo = cfg.moe
    d, f = cfg.d_model, mo.d_ff
    e = padded_experts(cfg)
    lead = () if stack is None else (stack,)

    def w(*shape):
        t = torch.randn(lead + shape, generator=gen, device=gen.device,
                        dtype=torch.float32) / math.sqrt(shape[-2])
        return t.to(dtype=dtype, device=device)

    params = {"router": w(d, e), "wi": w(e, d, f), "wg": w(e, d, f),
              "wo": w(e, f, d)}
    if mo.n_shared:
        fs = mo.d_ff * mo.n_shared
        params["shared_wi"] = w(d, fs)
        params["shared_wg"] = w(d, fs)
        params["shared_wo"] = w(fs, d)
        params["shared_gate"] = torch.zeros(lead + (d, 1), dtype=dtype,
                                            device=device)
    return params


def _route(xf, router_w, cfg: ModelConfig, e_pad: int):
    """-> (gate_vals (T,k), gate_idx (T,k), probs (T,E_pad)). Ties among
    the probabilities go to the lower expert index, as ``lax.top_k``
    breaks them."""
    mo = cfg.moe
    logits = xf.float() @ router_w.float()                # (T, E_pad)
    if e_pad != mo.n_experts:                             # mask pads
        col = torch.arange(e_pad, device=logits.device)
        logits = torch.where(col < mo.n_experts, logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, mo.top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, gate_idx, probs


def _top_k(probs, k: int):
    """The k largest of each row, the lower index first among equal
    values (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _one_hot(idx, n: int, dtype):
    """(..., n) one-hot rows of ``idx``, by comparison: no bounds check,
    so no read of the device."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _dispatch_indices(gate_idx, e_pad: int, cap: int):
    """-> (slot (T*k,) in [0, e_pad*cap] (last = dropped), keep,
    token_idx): each (token, choice) takes the next free row of its
    expert's capacity in token order (the one-hot cumsum)."""
    t, k = gate_idx.shape
    flat = _one_hot(gate_idx, e_pad, torch.int32).reshape(t * k, e_pad)
    pos = ((torch.cumsum(flat, dim=0, dtype=torch.int32) - flat)
           * flat).sum(-1)
    eid = gate_idx.reshape(t * k)
    keep = pos < cap
    slot = torch.where(keep, eid * cap + pos,
                       torch.full_like(pos, e_pad * cap))
    token_idx = torch.arange(t, device=gate_idx.device).repeat_interleave(k)
    return slot, keep, token_idx


def _expert_mlp(x, wi, wg, wo):
    """x: (E, C, d); weights (E, d, f)/(E, f, d). fp32 compute."""
    xf = x.float()
    g = F.silu(torch.bmm(xf, wg.float()))
    h = torch.bmm(xf, wi.float()) * g
    return torch.bmm(h, wo.float())


def _aux_loss(gate_idx, probs, cfg: ModelConfig):
    mo = cfg.moe
    e = probs.shape[-1]
    f_e = _one_hot(gate_idx, e, torch.float32).sum(1).mean(0)
    p_e = probs.mean(0)
    return mo.n_experts * (f_e * p_e).sum() * mo.router_aux_coef


def _shared_expert(params, xf):
    x32 = xf.float()
    sg = F.silu(x32 @ params["shared_wg"].float())
    sh = (x32 @ params["shared_wi"].float()) * sg
    s_out = sh @ params["shared_wo"].float()
    s_gate = torch.sigmoid(x32 @ params["shared_gate"].float())
    return s_gate * s_out


def _apply_local(params, x, *, cfg: ModelConfig):
    """Single-shard dispatch."""
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = padded_experts(cfg)
    k = mo.top_k
    cap = max(int(t * k / mo.n_experts * mo.capacity_factor), k)
    xf = x.reshape(t, d)
    gate_vals, gate_idx, probs = _route(xf, params["router"], cfg, e)
    slot, keep, token_idx = _dispatch_indices(gate_idx, e, cap)
    # the last row takes the dropped (token, choice) pairs
    buf = xf.new_zeros((e * cap + 1, d))
    buf[slot] = xf[token_idx]
    expert_out = _expert_mlp(buf[:e * cap].reshape(e, cap, d),
                             params["wi"], params["wg"], params["wo"])
    flat_out = expert_out.reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           flat_out[torch.clamp(slot, max=e * cap - 1)],
                           torch.zeros((), dtype=flat_out.dtype,
                                       device=flat_out.device))
    # each token's k gated rows are adjacent (token_idx = repeat(arange
    # t, k)): summed in choice order, in place of JAX's scatter-add
    # (``index_add_`` on the card adds with atomics, in no fixed order)
    rows = (gathered * gate_vals.reshape(t * k, 1)).reshape(t, k, d)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    if mo.n_shared:
        out = out + _shared_expert(params, xf)
    return (out.reshape(b, s, d).to(x.dtype),
            _aux_loss(gate_idx, probs, cfg))


def apply(params, x, *, cfg: ModelConfig):
    """x: (B, S, d) -> (out, aux_loss). Weight-only int8 expert leaves
    dequantize here: the expert einsums take the (E, d, f) leaves
    directly, with no ``ops.matmul`` in between."""
    if any(quant.is_quantized(params[k]) for k in ("wi", "wg", "wo")):
        params = dict(params)
        for k in ("wi", "wg", "wo"):
            params[k] = quant.resolve_weight(params[k])
    return _apply_local(params, x, cfg=cfg)
