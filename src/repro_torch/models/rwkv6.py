"""RWKV6 "Finch" time-mix — attention-free, data-dependent per-channel decay.

The R/K/V/G/O projections and the decay LoRA run on the row-wise matmul;
the recurrence runs chunkwise, on the WKV kernel for CUDA tensors
(``ops.wkv``):

    y_t = sum_c r_t[c] * (S_{t-1}[c,:] + u[c] k_t[c] v_t)
    S_t[c,:] = w_t[c] * S_{t-1}[c,:] + k_t[c] * v_t
    w_t = exp(-exp(w0 + lora(x_t)))          (data-dependent decay)

Chunked numerics: per-step log decays are clamped to [-CLAMP, -1e-6].
With chunk=16 and CLAMP=3.5 the largest intermediate factor is
exp(16*3.5) ~ 2e24 (fp32-safe) while anything the clamp affects has
decayed below fp32 epsilon.

``wkv_chunked`` (the chunked scan) and ``wkv_ref`` (the per-step
oracle) are the kernel's plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.params import randn
from repro_torch.core.types import ModelConfig
from repro_torch.kernels import ops

CHUNK = 16
CLAMP = 3.5


def init(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
         dtype, device):
    """Time-mix parameters (stacked over ``stack`` layers when given),
    drawn on the generator's device: the JAX package's tree of keys,
    shapes and dtypes (``u`` and ``w0`` are fp32 in every model dtype)."""
    r = cfg.rwkv
    d = cfg.d_model
    h = d // r.head_dim
    lead = () if stack is None else (stack,)

    def normal(*shape):
        return randn(gen, lead + shape)

    def w(din, dout, scale=1.0):
        return (normal(din, dout) * scale / math.sqrt(din)).to(
            dtype=dtype, device=device)

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "wr": w(d, d), "wk": w(d, d), "wv": w(d, d), "wg": w(d, d),
        "wo": w(d, d),
        "w0": full((d,), -2.0, torch.float32),
        "w_lora_a": w(d, r.decay_lora, 0.1),
        "w_lora_b": full((r.decay_lora, d), 0.0, dtype),
        "u": (normal(h, r.head_dim) * 0.1).to(device),
        "mu": full((5, d), 0.5, dtype),
        "ln_g": full((d,), 1.0, dtype),
        "ln_b": full((d,), 0.0, dtype),
    }


def logical_specs(stack: Optional[int]):
    """The logical axis names of :func:`init`'s leaves."""
    ll = () if stack is None else ("layers",)
    return {"wr": ll + ("embed", "qkv"), "wk": ll + ("embed", "qkv"),
            "wv": ll + ("embed", "qkv"), "wg": ll + ("embed", "qkv"),
            "wo": ll + ("qkv", "embed"), "w0": ll + (None,),
            "w_lora_a": ll + ("embed", None),
            "w_lora_b": ll + (None, "embed"), "u": ll + (None, None),
            "mu": ll + (None, None), "ln_g": ll + (None,),
            "ln_b": ll + (None,)}


def wkv_chunked(r, k, v, lw, u, *, chunk: int = CHUNK, s0=None):
    """Chunked WKV6. r,k,v: (B,S,H,P); lw: (B,S,H,P) log decay (<0);
    u: (H,P). Returns (y (B,S,H,P), final state (B,H,P,P))."""
    b, sl, h, p = r.shape
    chunk = min(chunk, sl)
    pad = (-sl) % chunk
    if pad:
        # pad with 0 log-decay: the tokens are unused and S is unchanged
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    nc = (sl + pad) // chunk

    def resh(x):
        return x.reshape(b, nc, chunk, h, p).transpose(0, 1)

    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(lw)
    S = (torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
         if s0 is None else s0)
    idx = torch.arange(chunk, device=r.device)
    strict = idx[:, None] > idx[None, :]          # j < i
    ys = []
    for c in range(nc):
        rk, kk, vk, lwk = rc[c], kc[c], vc[c], lwc[c]     # (B,L,H,P)
        cs = torch.cumsum(lwk, dim=1)             # inclusive
        cs_prev = cs - lwk                        # exclusive: sum_{t<i}
        # intra: A[i,j] = sum_c r_i[c] k_j[c] exp(cs_prev_i - cs_j), j<i
        rd = rk * torch.exp(cs_prev)
        kd = kk * torch.exp(-cs)
        A = torch.einsum("bihp,bjhp->bhij", rd, kd)
        A = A.masked_fill(~strict, 0.0)
        # diagonal bonus term: (r_i . u k_i)
        diag = torch.einsum("bihp,hp,bihp->bih", rk, u, kk)
        y = (torch.einsum("bhij,bjhp->bihp", A, vk)
             + diag[..., None] * vk)
        # inter: y_i += sum_c r_i[c] exp(cs_prev_i[c]) S[c,:]
        y = y + torch.einsum("bihp,bhpq->bihq", rd, S)
        # state: S' = diag(exp(cs_L)) S + sum_j exp(cs_L - cs_j) k_j v_j
        tail = torch.exp(cs[:, -1:] - cs)
        S = (torch.exp(cs[:, -1])[..., None] * S
             + torch.einsum("bjhp,bjhq->bhpq", tail * kk, vk))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y[:, :sl], S


def wkv_ref(r, k, v, lw, u, s0=None):
    """Naive per-step oracle."""
    b, sl, h, p = r.shape
    S = (torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device)
         if s0 is None else s0)
    ys = []
    for t in range(sl):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], lw[:, t]   # (B,H,P)
        kv = torch.einsum("bhp,bhq->bhpq", kt, vt)
        ys.append(torch.einsum("bhp,bhpq->bhq", rt, S + u[..., None] * kv))
        S = torch.exp(lwt)[..., None] * S + kv
    return torch.stack(ys, dim=1), S


def _token_shift(x, x_prev_last):
    """x_{t-1} stream: shift right; position 0 uses carried state."""
    return torch.cat([x_prev_last[:, None], x[:, :-1]], dim=1)


def apply(params, x, *, cfg: ModelConfig, state: Optional[dict] = None):
    """Time-mix forward. x: (B,S,d); state: {'x_prev_t': (B,d),
    'wkv': (B,H,P,P)} or None. Returns (out, (new_x_prev, new_wkv))."""
    rr = cfg.rwkv
    b, sl, d = x.shape
    h, p = d // rr.head_dim, rr.head_dim
    x_last = (state["x_prev_t"] if state is not None
              else torch.zeros_like(x[:, 0]))
    xp = _token_shift(x, x_last)
    mu = params["mu"].to(x.dtype)                 # (5, d)
    dx = xp - x
    xr, xk, xv, xg, xw = (x + dx * mu[i] for i in range(5))
    f32 = torch.float32
    r = ops.matmul(xr, params["wr"]).reshape(b, sl, h, p).to(f32)
    k = ops.matmul(xk, params["wk"]).reshape(b, sl, h, p).to(f32)
    v = ops.matmul(xv, params["wv"]).reshape(b, sl, h, p).to(f32)
    g = ops.matmul(xg, params["wg"])
    # data-dependent decay (the Finch contribution)
    lora = torch.tanh(ops.matmul(xw, params["w_lora_a"], out_dtype=f32))
    wlog = params["w0"] + ops.matmul(lora.to(x.dtype), params["w_lora_b"],
                                     out_dtype=f32)
    lw = -torch.exp(wlog).reshape(b, sl, h, p)
    lw = torch.clamp(lw, -CLAMP, -1e-6)
    s0 = state["wkv"] if state is not None else None
    y, s_fin = ops.wkv(r, k, v, lw, params["u"], s0=s0)
    y = y.reshape(b, sl, d).to(x.dtype)
    y = ops.layernorm(y, params["ln_g"], params["ln_b"], kind="layer")
    y = (y.to(f32) * F.silu(g.to(f32))).to(x.dtype)
    out = ops.matmul(y, params["wo"])
    return out, (x[:, -1], s_fin)
