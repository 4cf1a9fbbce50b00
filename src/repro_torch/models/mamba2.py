"""Mamba2 (SSD) mixer — zamba2's backbone.

The in/out projections run on the row-wise matmul and the gated RMS
norm on the norm kernel; the causal depthwise conv and the selective
scan are torch ops (the trace's spans ``mamba.conv`` and ``mamba.scan``), as they are jnp in the JAX package. The scan uses
the SSD *chunked* formulation (an intra-chunk attention-like term plus
inter-chunk state passing), walked chunk by chunk in a Python loop as
the JAX package scans it; a decode step is a chunk of one token.

Recurrence (per head h, head dim P, state dim N, scalar decay):
    S_t = exp(dt_t * a_h) * S_{t-1} + dt_t * x_t (outer) B_t
    y_t = S_t C_t + D_h x_t

``A_log``, ``dt_bias`` and ``D`` are fp32 in every model dtype; the
state is fp32, the conv state in the block input's dtype.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import trace
from repro_torch.core.params import randn
from repro_torch.core.types import ModelConfig
from repro_torch.kernels import ops


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim) rolling conv inputs
    ssm: torch.Tensor    # (B, H, P, N) state


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return s, d_in, n_heads, conv_dim


def init(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
         dtype, device):
    """Mixer parameters (stacked over ``stack`` layers when given), drawn
    on the generator's device: the JAX package's tree of keys, shapes
    and dtypes (``A_log``, ``dt_bias`` and ``D`` fp32 in every model
    dtype)."""
    s, d_in, n_heads, conv_dim = _dims(cfg)
    d = cfg.d_model
    lead = () if stack is None else (stack,)
    proj_out = 2 * d_in + 2 * s.d_state + n_heads

    def normal(*shape):
        return randn(gen, lead + shape)

    def w(din, dout):
        return (normal(din, dout) / math.sqrt(din)).to(dtype=dtype,
                                                        device=device)

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "in_proj": w(d, proj_out),
        "out_proj": w(d_in, d),
        "conv_w": (normal(s.d_conv, conv_dim) * 0.1).to(dtype=dtype,
                                                        device=device),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "A_log": full((n_heads,), 0.0, torch.float32),
        "dt_bias": full((n_heads,), 0.0, torch.float32),
        "D": full((n_heads,), 1.0, torch.float32),
        "norm_g": full((d_in,), 1.0, dtype),
    }


def _split(cfg, zxbcdt):
    """(z, x, B|C, dt): column views of the in-projection's output."""
    s, d_in, _, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, 2 * s.d_state,
                                zxbcdt.shape[-1] - 2 * d_in - 2 * s.d_state],
                       dim=-1)


def _conv(x, w, b, state=None):
    """Causal depthwise conv. x: (B,S,C); w: (K,C); b: (C,). state:
    (B,K-1,C), cast to x's dtype. The products take the weights' dtype
    (the caller's fp32); the new state is the last K-1 rows of the
    padded input, in x's dtype, copied out of it (a view would keep the
    whole padded input alive in the prefill's cache)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    sl = x.shape[1]
    out = xp[:, 0:sl] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + sl] * w[i]
    new_state = xp[:, -(k - 1):].clone() if k > 1 else None
    return out + b, new_state


def ssd_chunked(xh, dt, a, B, C, *, chunk: int = 128, s0=None):
    """Chunked SSD scan.

    xh: (Bb, S, H, P); dt: (Bb, S, H); a: (H,) negative;
    B, C: (Bb, S, N). Returns (y, final_state (Bb,H,P,N))."""
    bb, sl, h, p = xh.shape
    n = B.shape[-1]
    chunk = min(chunk, sl)
    pad = (-sl) % chunk
    if pad:
        # zero dt: the pad rows neither decay nor feed the state
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (sl + pad) // chunk
    xc = xh.reshape(bb, nc, chunk, h, p).transpose(0, 1)
    dtc = dt.reshape(bb, nc, chunk, h).transpose(0, 1)
    Bc = B.reshape(bb, nc, chunk, n).transpose(0, 1)
    Cc = C.reshape(bb, nc, chunk, n).transpose(0, 1)
    S = (torch.zeros((bb, h, p, n), dtype=torch.float32, device=xh.device)
         if s0 is None else s0)
    idx = torch.arange(chunk, device=xh.device)
    mask = idx[:, None] >= idx[None, :]                   # j <= i
    ys = []
    for c in range(nc):
        xk, dk, Bk, Ck = xc[c], dtc[c], Bc[c], Cc[c]      # (Bb,L,H,P),...
        lam = dk * a                                      # log decays <= 0
        cs = torch.cumsum(lam, dim=1)                     # inclusive
        # intra: M[b,i,j,h] = exp(cs_i - cs_j) dt_j (C_i . B_j), j <= i
        logd = cs[:, :, None, :] - cs[:, None, :, :]      # (Bb,i,j,H)
        logd = logd.masked_fill(~mask[None, :, :, None], float("-inf"))
        cb = torch.einsum("bin,bjn->bij", Ck, Bk)
        M = torch.exp(logd) * cb[..., None] * dk[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", M, xk)
        # inter: y_i += exp(cs_i) * C_i . S^T
        y = y + torch.exp(cs)[..., None] * torch.einsum("bhpn,bin->bihp",
                                                        S, Ck)
        # state: S' = exp(cs_L) S + sum_j exp(cs_L - cs_j) dt_j x_j B_j
        tail = torch.exp(cs[:, -1:, :] - cs)              # (Bb,L,H)
        S = (torch.exp(cs[:, -1])[:, :, None, None] * S
             + torch.einsum("bjh,bjhp,bjn->bhpn", tail * dk, xk, Bk))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y[:, :sl], S


def ssd_ref(xh, dt, a, B, C, s0=None):
    """Naive per-step scan oracle."""
    bb, sl, h, p = xh.shape
    n = B.shape[-1]
    S = (torch.zeros((bb, h, p, n), dtype=torch.float32, device=xh.device)
         if s0 is None else s0)
    ys = []
    for t in range(sl):
        xt, dtt, Bt, Ct = xh[:, t], dt[:, t], B[:, t], C[:, t]
        decay = torch.exp(dtt * a)                        # (Bb,H)
        S = (S * decay[:, :, None, None]
             + torch.einsum("bh,bhp,bn->bhpn", dtt, xt, Bt))
        ys.append(torch.einsum("bhpn,bn->bhp", S, Ct))
    return torch.stack(ys, dim=1), S


def apply(params, x, *, cfg: ModelConfig, state: Optional[MambaState] = None,
          chunk: Optional[int] = None):
    """Full-sequence forward. x: (B,S,d). Returns (out, final_state)."""
    s, d_in, n_heads, _ = _dims(cfg)
    bsz, sl, _ = x.shape
    f32 = torch.float32
    zxbcdt = ops.matmul(x, params["in_proj"])
    z, xi, bc, dt = _split(cfg, zxbcdt)
    with trace.span("mamba.conv"):
        conv_in = torch.cat([xi, bc], dim=-1)
        conv_out, new_conv = _conv(conv_in, params["conv_w"].to(f32),
                                   params["conv_b"].to(f32),
                                   None if state is None else state.conv)
        conv_out = F.silu(conv_out.to(f32))
    xi = conv_out[..., :d_in]
    B = conv_out[..., d_in:d_in + s.d_state]
    C = conv_out[..., d_in + s.d_state:]
    # softplus as jax.nn.softplus computes it: logaddexp(x, 0)
    dt = dt.to(f32) + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))                # (B,S,H)
    a = -torch.exp(params["A_log"])                               # (H,)
    xh = xi.reshape(bsz, sl, n_heads, s.head_dim)
    with trace.span("mamba.scan"):
        y, s_fin = ssd_chunked(xh, dt, a, B, C, chunk=chunk or s.chunk,
                               s0=None if state is None else state.ssm)
    y = y + params["D"][None, None, :, None] * xh
    y = y.reshape(bsz, sl, d_in)
    # gated RMS norm, then the out-projection
    y = y * F.silu(z.to(f32))
    y = ops.layernorm(y.to(x.dtype), params["norm_g"], eps=cfg.norm_eps,
                      kind="rms")
    out = ops.matmul(y, params["out_proj"])
    return out, MambaState(conv=new_conv.to(x.dtype), ssm=s_fin)


def logical_specs(stack: Optional[int]):
    """The logical axis names of :func:`init`'s leaves."""
    ll = () if stack is None else ("layers",)
    return {"in_proj": ll + ("embed", "ffn"),
            "out_proj": ll + ("ffn", "embed"),
            "conv_w": ll + (None, "ffn"), "conv_b": ll + ("ffn",),
            "A_log": ll + (None,), "dt_bias": ll + (None,),
            "D": ll + (None,), "norm_g": ll + ("ffn",)}


def state_specs() -> MambaState:
    return MambaState(conv=("batch", None, "ffn"),
                      ssm=("batch", None, None, None))


def init_state(cfg: ModelConfig, batch: int, dtype, device) -> MambaState:
    s, d_in, n_heads, conv_dim = _dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device))
