"""Feed-forward layers. This slice ports the RWKV channel-mix (relu^2 +
receptance gate); the GELU / SwiGLU / GeGLU MLP (``init``/``apply``)
comes with the dense LM slice (ROADMAP.md queue 1 item 4). All matmuls
go through the row-wise primitive."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.types import ModelConfig
from repro_torch.kernels import ops


def init_cmix(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
              dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    lead = () if stack is None else (stack,)

    def w(din, dout):
        t = torch.randn(lead + (din, dout), generator=gen, device=gen.device,
                        dtype=torch.float32) / math.sqrt(din)
        return t.to(dtype=dtype, device=device)

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
