"""Plain PyTorch versions of every kernel: the ground truth the kernels
are held against, and what a kernel wrapper runs for a CPU tensor.

Same numerics as the JAX package's oracles: GELU is the tanh
approximation, masked scores are -1e30, products accumulate in fp32.
On the card the fp32 products are full fp32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default);
``chip_smoke.py`` sets and states it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.layernorm import rownorm

NEG_INF = -1e30

ACTIVATIONS = {
    None: lambda x: x,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def _dot_f32(x, w):
    """(..., K) @ (K, N) with exact products accumulated in fp32."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def matmul_ref(x, w, *, bias=None, activation=None, out_dtype=None):
    out_dtype = out_dtype or x.dtype
    acc = _dot_f32(x, w)
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    return ACTIVATIONS[activation](acc).to(out_dtype)


def pipeline_ref(x, w, *, bias=None, activation=None, w_gate=None,
                 bias_gate=None, residual=None, norm_kind=None,
                 gamma=None, beta=None, eps=1e-6, out_dtype=None):
    """The fused block pipeline as a composition: optional pre-norm
    (cast back to the streaming dtype), one or two (gated) matmuls,
    bias/activation/gating, residual add, cast."""
    out_dtype = out_dtype or x.dtype
    if norm_kind is not None:
        x = layernorm_ref(x, gamma, beta, eps=eps, kind=norm_kind)
    h = _dot_f32(x, w)
    if bias is not None:
        h = h + bias.to(torch.float32)
    if w_gate is not None:
        g = _dot_f32(x, w_gate)
        if bias_gate is not None:
            g = g + bias_gate.to(torch.float32)
        h = ACTIVATIONS[activation](g) * h
    else:
        h = ACTIVATIONS[activation](h)
    if residual is not None:
        h = h + residual.to(torch.float32)
    return h.to(out_dtype)


def attention_ref(q, k, v, *, causal=True, window: int = 0,
                  scale: Optional[float] = None, q_offset: int = 0,
                  kv_len: Optional[int] = None, bias=None):
    """Dense softmax attention. q: (B,Hq,Sq,hd); k,v: (B,Hkv,Skv,hd).

    ``bias``: (nb, Hq, Sq, Skv) additive score bias, batch b uses row
    b % nb (Swin relative-position bias / shift masks).
    """
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    scale = hd ** -0.5 if scale is None else scale
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if bias is not None:
        nb = bias.shape[0]
        s = (s.reshape(b // nb, nb, hq, sq, skv)
             + bias[None].to(torch.float32)).reshape(b, hq, sq, skv)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= k_pos < kv_len
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def layernorm_ref(x, gamma, beta=None, *, eps=1e-6, kind="layer"):
    return rownorm(x, gamma, beta, kind=kind, eps=eps).to(x.dtype)


def space_to_depth(img, patch: int):
    """(B, H, W, C) -> (B, H/p, W/p, p*p*C), the patch-embed conv's
    receptive fields laid out as rows of the matmul primitive."""
    bsz, h, wd, c = img.shape
    gh, gw = h // patch, wd // patch
    x = img.reshape(bsz, gh, patch, gw, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(bsz, gh, gw,
                                               patch * patch * c)


def patch_embed_ref(img, w, b=None, *, patch: int = 4):
    """img: (B, H, W, C); w: (patch*patch*C, D). Conv stride=kernel=patch,
    written as space-to-depth and a matmul (no cuDNN, no TF32)."""
    k = _dot_f32(space_to_depth(img, patch), w)
    if b is not None:
        k = k + b.to(torch.float32)
    return k.to(img.dtype)
