"""Feed-forward layers: GELU MLP (2 mats), SwiGLU / GeGLU (3 mats, the
gate|up pair one stored panel), RWKV channel-mix (relu^2 + receptance
gate). All matmuls go through the row-wise primitive."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import partitioning as part
from repro_torch.core import quant
from repro_torch.core.params import randn
from repro_torch.core.types import GATED_ACTS as GATED, ModelConfig
from repro_torch.kernels import ops


def _weight(gen, lead, din, dout, dtype, device):
    t = randn(gen, lead + (din, dout)) / math.sqrt(din)
    return t.to(dtype=dtype, device=device)


def init(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
         dtype, device):
    """Gated variants store the gate|up pair PRE-FUSED as one ``wgi``
    (d, 2 d_ff) leaf, gate columns first; non-gated MLPs keep ``wi``."""
    d, f = cfg.d_model, cfg.d_ff
    lead = () if stack is None else (stack,)

    def w(din, dout):
        return _weight(gen, lead, din, dout, dtype, device)

    if cfg.act in GATED:
        return {"wgi": w(d, 2 * f), "wo": w(f, d)}
    return {"wi": w(d, f), "wo": w(f, d)}


def logical_specs(cfg: ModelConfig, stack: Optional[int]):
    """The logical axis names of :func:`init`'s leaves."""
    ll = () if stack is None else ("layers",)
    first = "wgi" if cfg.act in GATED else "wi"
    return {first: ll + ("embed", "ffn"), "wo": ll + ("ffn", "embed")}


def apply(params, x, *, cfg: ModelConfig, norm=None, residual=None):
    """``norm``/``residual`` select the fused pipeline: the pre-norm runs
    as the first kernel's prologue, gated variants stream the stored
    wg|wi panel through ONE kernel whose epilogue computes ``act(g) *
    h``, and the residual add rides the output projection's epilogue.
    With both None this is the per-op composition (the stored panel
    sliced back into wg and wi, two launches)."""
    act = {"silu": "silu", "geglu": "gelu", "gelu": "gelu",
           "relu": "relu"}[cfg.act]
    if cfg.act in GATED:
        if norm is not None:
            h = ops.gate_up_proj(x, params["wgi"], activation=act,
                                 norm=norm)
        else:
            wgi = quant.resolve_weight(params["wgi"], x.dtype)
            f = wgi.shape[-1] // 2
            g = ops.matmul(x, wgi[..., :f], activation=act)
            h = ops.matmul(x, wgi[..., f:]) * g
    else:
        h = ops.matmul(x, params["wi"], activation=act, norm=norm)
    if part.tp_axis() is None:
        return ops.matmul(h, params["wo"], residual=residual)
    # tensor-parallel serving: wo is row-sharded over the hidden dim, so
    # the partial product is summed over the group before the residual
    y = part.tp_reduce(ops.matmul(h, params["wo"]))
    return y if residual is None else y + residual


def init_cmix(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
              dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    lead = () if stack is None else (stack,)

    def w(din, dout):
        return _weight(gen, lead, din, dout, dtype, device)

    return {"wk": w(d, f), "wv": w(f, d), "wr": w(d, d),
            "mu_k": torch.full(lead + (d,), 0.5, dtype=dtype, device=device),
            "mu_r": torch.full(lead + (d,), 0.5, dtype=dtype, device=device)}


def cmix_logical_specs(stack: Optional[int]):
    """The logical axis names of :func:`init_cmix`'s leaves."""
    ll = () if stack is None else ("layers",)
    return {"wk": ll + ("embed", "ffn"), "wv": ll + ("ffn", "embed"),
            "wr": ll + ("embed", "embed"), "mu_k": ll + (None,),
            "mu_r": ll + (None,)}


def apply_cmix(params, x, x_prev):
    """RWKV6 channel-mix. x: (B,S,d); x_prev: token-shifted x."""
    xk = x + (x_prev - x) * params["mu_k"].to(x.dtype)
    xr = x + (x_prev - x) * params["mu_r"].to(x.dtype)
    k = ops.matmul(xk, params["wk"], activation="relu2")
    r = torch.sigmoid(ops.matmul(xr, params["wr"]).to(torch.float32))
    v = ops.matmul(k, params["wv"])
    return (r * v.to(torch.float32)).to(x.dtype)
