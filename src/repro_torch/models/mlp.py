"""Feed-forward layers: GELU MLP (2 mats), SwiGLU / GeGLU (3 mats, the
gate|up pair one stored panel), RWKV channel-mix (relu^2 + receptance
gate). All matmuls go through the row-wise primitive."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quant
from repro_torch.core.types import GATED_ACTS as GATED, ModelConfig
from repro_torch.kernels import ops


def _weight(gen, lead, din, dout, dtype, device):
    t = torch.randn(lead + (din, dout), generator=gen, device=gen.device,
                    dtype=torch.float32) / math.sqrt(din)
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
    return ops.matmul(h, params["wo"], residual=residual)


def init_cmix(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
              dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    lead = () if stack is None else (stack,)

    def w(din, dout):
        return _weight(gen, lead, din, dout, dtype, device)

    return {"wk": w(d, f), "wv": w(f, d), "wr": w(d, d),
            "mu_k": torch.full(lead + (d,), 0.5, dtype=dtype, device=device),
            "mu_r": torch.full(lead + (d,), 0.5, dtype=dtype, device=device)}


def apply_cmix(params, x, x_prev):
    """RWKV6 channel-mix. x: (B,S,d); x_prev: token-shifted x."""
    xk = x + (x_prev - x) * params["mu_k"].to(x.dtype)
    xr = x + (x_prev - x) * params["mu_r"].to(x.dtype)
    k = ops.matmul(xk, params["wk"], activation="relu2")
    r = torch.sigmoid(ops.matmul(xr, params["wr"]).to(torch.float32))
    v = ops.matmul(k, params["wv"])
    return (r * v.to(torch.float32)).to(x.dtype)
