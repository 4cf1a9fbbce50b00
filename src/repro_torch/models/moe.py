"""Mixture-of-Experts FFN with token-choice top-k routing.

The JAX package's local path (no mesh): capacity-based scatter/gather
dispatch over the whole batch. The router, the dispatch and the experts
are jnp there, outside any Pallas kernel, so here they are torch ops:
the router product and the expert SwiGLU einsums in fp32, as in JAX.
Under a mesh whose ``model`` axis divides the padded experts the
expert-parallel path runs (``_apply_ep``: each rank routes its rows and
a tiled all-to-all over ``model`` carries them to the rank holding
their expert and back); the aux loss is then the global batch's.

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

from repro_torch.core import partitioning as part
from repro_torch.core import quant
from repro_torch.core.params import randn
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
        t = randn(gen, lead + shape) / math.sqrt(shape[-2])
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


def logical_specs(cfg: ModelConfig, stack: Optional[int]):
    """The logical axis names of :func:`init`'s leaves: the stacked
    expert dim is ``experts`` (expert parallel over ``model``)."""
    ll = () if stack is None else ("layers",)
    specs = {"router": ll + ("embed", None),
             "wi": ll + ("experts", "embed", None),
             "wg": ll + ("experts", "embed", None),
             "wo": ll + ("experts", None, "embed")}
    if cfg.moe.n_shared:
        specs.update({"shared_wi": ll + ("embed", "ffn"),
                      "shared_wg": ll + ("embed", "ffn"),
                      "shared_wo": ll + ("ffn", "embed"),
                      "shared_gate": ll + ("embed", None)})
    return specs


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
    """Shazeer's load-balance loss. Under a mesh each rank routes its own
    tokens: ``f_e`` and ``p_e`` are averaged over every (non-manual)
    mesh axis first, so the value is the global batch's on every rank
    (the JAX package's ``_apply_ep``; its GSPMD local path is global by
    construction)."""
    mo = cfg.moe
    e = probs.shape[-1]
    f_e = _one_hot(gate_idx, e, torch.float32).sum(1).mean(0)
    p_e = probs.mean(0)
    if part.active_mesh() is not None:
        f_e, p_e = part.mesh_mean(f_e), part.mesh_mean(p_e)
    return mo.n_experts * (f_e * p_e).sum() * mo.router_aux_coef


def _shared_expert(params, xf):
    x32 = xf.float()
    sg = F.silu(x32 @ params["shared_wg"].float())
    sh = (x32 @ params["shared_wi"].float()) * sg
    s_out = sh @ params["shared_wo"].float()
    s_gate = torch.sigmoid(x32 @ params["shared_gate"].float())
    return s_gate * s_out


def _combine(flat_out, slot, keep, gate_vals, t, k, d):
    """Each token's k expert rows, gated and summed in choice order."""
    e_cap = flat_out.shape[0]
    gathered = torch.where(keep[:, None],
                           flat_out[torch.clamp(slot, max=e_cap - 1)],
                           torch.zeros((), dtype=flat_out.dtype,
                                       device=flat_out.device))
    # each token's k gated rows are adjacent (token_idx = repeat(arange
    # t, k)): summed in choice order, in place of JAX's scatter-add
    # (``index_add_`` on the card adds with atomics, in no fixed order)
    rows = (gathered * gate_vals.reshape(t * k, 1)).reshape(t, k, d)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def _dispatch(xf, params, cfg: ModelConfig, e: int):
    """Route the rows of ``xf`` (T, d) and lay them out by expert: ->
    (buf (E, C, d), slot, keep, gate_vals, gate_idx, probs), the capacity
    C over these T rows."""
    mo = cfg.moe
    t, d = xf.shape
    k = mo.top_k
    cap = max(int(t * k / mo.n_experts * mo.capacity_factor), k)
    gate_vals, gate_idx, probs = _route(xf, params["router"], cfg, e)
    slot, keep, token_idx = _dispatch_indices(gate_idx, e, cap)
    # the last row takes the dropped (token, choice) pairs
    buf = xf.new_zeros((e * cap + 1, d))
    buf[slot] = xf[token_idx]
    return (buf[:e * cap].reshape(e, cap, d), slot, keep, gate_vals,
            gate_idx, probs)


def _apply_local(params, x, *, cfg: ModelConfig):
    """Single-shard dispatch (under a mesh: each rank over its own rows,
    the capacity per rank, the aux loss global)."""
    b, s, d = x.shape
    t = b * s
    e = padded_experts(cfg)
    xf = x.reshape(t, d)
    buf, slot, keep, gate_vals, gate_idx, probs = _dispatch(xf, params,
                                                            cfg, e)
    expert_out = _expert_mlp(buf, params["wi"], params["wg"], params["wo"])
    out = _combine(expert_out.reshape(-1, d), slot, keep, gate_vals, t,
                   cfg.moe.top_k, d)
    if cfg.moe.n_shared:
        out = out + _shared_expert(params, xf)
    return (out.reshape(b, s, d).to(x.dtype),
            _aux_loss(gate_idx, probs, cfg))


def _local_experts(w, mesh, e_loc: int):
    """This rank's expert block of an expert leaf: the leaf itself when
    the training mesh keeps it local (``part.fsdp``), else its rows of
    the full leaf."""
    if w.shape[0] == e_loc:
        return w
    m = mesh.coord("model")
    if w.shape[0] != e_loc * mesh.sizes["model"]:
        raise ValueError(f"an expert leaf of {w.shape[0]} experts on a "
                         f"model axis of {mesh.sizes['model']}")
    return w[m * e_loc:(m + 1) * e_loc]


def _apply_ep(params, x, *, cfg: ModelConfig, mesh):
    """Expert-parallel dispatch over the mesh's ``model`` axis, the JAX
    package's ``_apply_ep``: each rank routes its own rows (capacity per
    rank, over its tokens) into (E, C, d), a tiled all-to-all sends
    expert block j to model rank j, which runs its E / n_model experts
    over (E_loc, n_model C, d) and sends the rows back the same way.
    Both all-to-alls have a backward (the all-to-all itself). The expert
    weights are local over ``model``; under the training mesh they were
    gathered over ``data`` alone (``part.fsdp`` keeps the expert dim
    local). The aux loss is the global batch's."""
    b, s, d = x.shape
    t = b * s
    e = padded_experts(cfg)
    n = mesh.sizes["model"]
    e_loc = e // n
    group = mesh.group(("model",))
    xf = x.reshape(t, d)
    buf, slot, keep, gate_vals, gate_idx, probs = _dispatch(xf, params,
                                                            cfg, e)
    cap = buf.shape[1]
    # dispatch: (E, C, d) = (n, E_loc, C, d) -> (E_loc, n C, d)
    recv = part.all_to_all_blocks(buf.reshape(n, e_loc, cap, d), group)
    recv = recv.transpose(0, 1).reshape(e_loc, n * cap, d)
    w = [_local_experts(params[k], mesh, e_loc) for k in ("wi", "wg", "wo")]
    out_e = _expert_mlp(recv, *w).to(xf.dtype)
    # return: (E_loc, n C, d) -> (n, E_loc, C, d) = (E, C, d)
    back = part.all_to_all_blocks(
        out_e.reshape(e_loc, n, cap, d).transpose(0, 1), group)
    out = _combine(back.reshape(e * cap, d), slot, keep, gate_vals, t,
                   cfg.moe.top_k, d)
    if cfg.moe.n_shared:
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
    mesh = part.active_mesh()
    if (mesh is not None and "model" in mesh.axis_names
            and padded_experts(cfg) % mesh.sizes["model"] == 0):
        return _apply_ep(params, x, cfg=cfg, mesh=mesh)
    return _apply_local(params, x, cfg=cfg)
