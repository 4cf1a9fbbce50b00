"""Attention layer: GQA/MQA, RoPE, dense KV caches.

The projections go through the row-wise matmul primitive (one launch
over the stored ``wqkv`` panel with the pre-norm in its prologue when
fused; the residual in the output projection's epilogue). The core op
dispatches as the JAX package's ``_sdpa`` does:

  * full-sequence attention at a static offset (train, prefill) —
    ``ops.attention``: the hand-written flash kernel for CUDA tensors,
    its plain version for CPU tensors and under ``use_impl("ref")``
    (which takes the chunked scan past ``DENSE_MAX_SEQ``);
  * a decode step, whose valid keys end at a per-row ``kv_len`` —
    :func:`chunked_attention`, the online-softmax scan over KV chunks in
    torch ops, as JAX runs it in jnp (the kernel takes no ``kv_len``).

Not ported yet: cross-attention (ROADMAP.md queue 1 item 4,
encoder-decoder), the paged pools and their gathers (item 5), the
sequence-sharded decode (item 7) and the flash backward (item 9).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import quant, runtime
from repro_torch.core.types import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import rope as rope_lib

DENSE_MAX_SEQ = 2048      # above this, 'ref' impl switches to chunked
NEG_INF = -1e30


def proj_splits(cfg: ModelConfig):
    """(q, k, v) output widths inside the fused ``wqkv`` panel."""
    qo = cfg.n_heads * cfg.head_dim
    kvo = cfg.n_kv_heads * cfg.head_dim
    return (qo, kvo, kvo)


def init(gen: torch.Generator, cfg: ModelConfig, stack: Optional[int],
         dtype, device, cross: bool = False):
    """Self-attention parameters: the PRE-FUSED ``wqkv`` (d, (Hq + 2 Hkv)
    hd) panel, q, k and v columns in that order, and ``wo``; drawn on
    the generator's device, placed on ``device``."""
    if cross:
        raise NotImplementedError(
            "not ported yet: cross-attention, ROADMAP.md queue 1 item 4 "
            "(encoder-decoder)")
    d, hd = cfg.d_model, cfg.head_dim
    qo = cfg.n_heads * hd
    lead = () if stack is None else (stack,)

    def w(din, dout):
        t = torch.randn(lead + (din, dout), generator=gen, device=gen.device,
                        dtype=torch.float32) / math.sqrt(din)
        return t.to(dtype=dtype, device=device)

    return {"wqkv": w(d, sum(proj_splits(cfg))), "wo": w(qo, d)}


def _out_proj(out, wo, residual):
    """Output projection with the residual in its epilogue."""
    return ops.matmul(out, wo, residual=residual)


class KVCache(NamedTuple):
    """Per-layer KV cache. k/v: (B, S_alloc, Hkv, hd)."""
    k: torch.Tensor
    v: torch.Tensor


def _apply_rope(q, k, cfg: ModelConfig, positions):
    if cfg.rope == "none":
        return q, k
    if cfg.rope == "mrope":
        raise NotImplementedError(
            "not ported yet: M-RoPE, ROADMAP.md queue 1 item 8")
    return (rope_lib.apply_rope(q, positions, cfg.rope_theta),
            rope_lib.apply_rope(k, positions, cfg.rope_theta))


def _chunk_mask(base, chunk, q_pos, limit, causal, window):
    """(B,1,1,Sq,chunk) validity mask for one KV chunk."""
    k_pos = base + torch.arange(chunk, device=limit.device)
    mask = (k_pos[None, :] < limit[:, None])[:, None, None, None, :]
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos)[None, None, None]
    if window > 0:
        mask = mask & (k_pos[None, :] > q_pos - window)[None, None, None]
    return mask


def _bmm32(a, b):
    """(N, m, k) @ (N, k, n) of one stored dtype, accumulated and
    returned in fp32 without fp32 copies of the operands: cuBLAS's bf16 /
    fp16 product with an fp32 output on the card. The CPU's bmm takes no
    ``out_dtype``; there the operands are widened first, which gives the
    same values (a product of two bf16 or fp16 values is exact in
    fp32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _online_update(carry, qg, kb, vb, mask, scale):
    """One online-softmax accumulation step over a KV chunk.

    carry: (m, l, acc) running max / denominator / output accumulator;
    qg: (B,Hkv,g,Sq,hd); kb/vb: (B,Hkv,chunk,hd); mask broadcastable to
    the (B,Hkv,g,Sq,chunk) score shape. Products of the stored dtype,
    accumulated in fp32 (:func:`_bmm32`); the probabilities are rounded
    to v's dtype before the PV product, as JAX does. A dense cache's
    chunk (its heads inside its positions) is gathered into one
    contiguous copy of its stored dtype for the batched product.
    """
    m, l, acc = carry
    b, hkv, g, sq, hd = qg.shape
    ck = kb.shape[2]
    s = _bmm32(qg.reshape(b * hkv, g * sq, hd),
               kb.reshape(b * hkv, ck, hd).transpose(1, 2))
    s = s.reshape(b, hkv, g, sq, ck) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    pv = _bmm32(p.to(vb.dtype).reshape(b * hkv, g * sq, ck),
                vb.reshape(b * hkv, ck, hd))
    acc_new = acc * alpha[..., None] + pv.reshape(b, hkv, g, sq, hd)
    return m_new, l_new, acc_new


def _chunked_fwd(q, k, v, limit, *, causal, window, q_offset, chunk):
    """Returns out (B,Hq,Sq,hd). The chunks are slices of k and v (the
    JAX package pads the last one; its padded keys lie past ``limit``
    and are masked either way). The JAX package also returns the
    log-sum-exp for its flash backward, which the port has not yet
    (ROADMAP.md queue 1 item 9)."""
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    chunk = min(chunk, skv)
    qg = q.reshape(b, hkv, g, sq, hd)
    scale = hd ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for base in range(0, skv, chunk):
        kb, vb = k[:, :, base:base + chunk], v[:, :, base:base + chunk]
        mask = _chunk_mask(base, chunk, q_pos, limit, causal, window)
        m, l, acc = _online_update((m, l, acc), qg, kb, vb,
                                   mask[..., :kb.shape[2]], scale)
    l = torch.clamp(l, min=1e-30)
    return (acc / l[..., None]).reshape(b, hq, sq, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window: int = 0,
                      q_offset=0, kv_len=None, chunk: int = 1024,
                      pages=None):
    """Online-softmax scan over KV chunks. q: (B,Hq,Sq,hd); k/v GQA.

    ``q_offset`` may be a tensor; ``kv_len`` (int or (B,)) masks the
    padded cache. Forward only (the flash backward comes with training,
    ROADMAP.md queue 1 item 9).
    """
    if pages is not None:
        raise NotImplementedError(
            "not ported yet: paged attention, ROADMAP.md queue 1 item 5")
    b = q.shape[0]
    limit = k.shape[2] if kv_len is None else kv_len
    limit = torch.as_tensor(limit, device=q.device).expand(b)
    return _chunked_fwd(q, k, v, limit, causal=causal, window=window,
                        q_offset=q_offset, chunk=chunk)


def _sdpa(q, k, v, *, causal, window):
    """Impl dispatch for full-sequence attention (static offset 0, every
    key valid): the kernel, or its plain version; the plain path takes
    the chunked scan past ``DENSE_MAX_SEQ``."""
    if (runtime.resolve_impl() == "ref"
            and max(q.shape[2], k.shape[2]) > DENSE_MAX_SEQ):
        return chunked_attention(q, k, v, causal=causal, window=window)
    return ops.attention(q, k, v, causal=causal, window=window)


def apply(params, x, *, cfg: ModelConfig, positions, window: int = 0,
          causal: bool = True, kv=None,
          norm: Optional[ops.NormSpec] = None, residual=None):
    """Full-sequence forward (train / prefill).

    norm: fused-pipeline mode — x arrives *un-normalized* and the
    pre-norm runs as the qkv kernel's prologue over the stored panel.
    residual: folded into the output projection's epilogue.
    Returns (out, (k_heads, v_heads)) — the heads prefill caches: k
    RoPE'd, v a view of the projection's output.
    """
    if kv is not None:
        raise NotImplementedError(
            "not ported yet: cross-attention, ROADMAP.md queue 1 item 4 "
            "(encoder-decoder)")
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, norm)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    q, k = _apply_rope(q, k, cfg, positions)
    # head views, read through their strides by the kernel
    out = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return _out_proj(out, params["wo"], residual), (k, v)


def write_cache(cache: KVCache, k_new, v_new, pos):
    """Insert (B, S_new, Hkv, hd) states at position ``pos`` (int or
    (B,)), wrapping at the cache's length. Written IN PLACE into the
    cache's storage (a step would otherwise copy the whole cache); the
    cache is returned."""
    b, alloc = cache.k.shape[:2]
    dev = cache.k.device
    pos = torch.as_tensor(pos, device=dev).expand(b)
    idx = (pos[:, None] + torch.arange(k_new.shape[1], device=dev)[None]
           ) % alloc                                           # (B,S_new)
    bidx = torch.arange(b, device=dev)[:, None]
    cache.k[bidx, idx] = k_new.to(cache.k.dtype)
    cache.v[bidx, idx] = v_new.to(cache.v.dtype)
    return cache


def _project_qkv(params, x, cfg: ModelConfig, norm):
    """q/k/v projections from the stored fused ``wqkv`` panel: one
    launch over the whole panel when fused (a norm spec rides along),
    three launches over its column slices when not (the per-op
    baseline)."""
    splits = proj_splits(cfg)
    if norm is not None:
        return ops.qkv_proj(x, params["wqkv"], splits, norm=norm)
    w = quant.resolve_weight(params["wqkv"], x.dtype)
    qo, kvo, _ = splits
    return (ops.matmul(x, w[..., :qo]),
            ops.matmul(x, w[..., qo:qo + kvo]),
            ops.matmul(x, w[..., qo + kvo:]))


def _decode_qkv(params, x, cfg: ModelConfig, lengths, norm):
    """Shared decode-step projections: q/k/v heads for the new token,
    RoPE'd at the token's position. x: (B, 1, d)."""
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, cfg, norm)
    q = q.reshape(b, 1, hq, hd)
    k = k.reshape(b, 1, hkv, hd)
    v = v.reshape(b, 1, hkv, hd)
    return _apply_rope(q, k, cfg, lengths[:, None]) + (v,)


def decode_apply(params, x, cache: KVCache, *, cfg: ModelConfig,
                 lengths, norm: Optional[ops.NormSpec] = None,
                 residual=None):
    """One-token decode on a global (non-window) layer. x: (B, 1, d);
    lengths: (B,) tokens already in cache. The new token's k/v are
    written into ``cache`` in place. Returns (out, cache). norm/residual
    as in :func:`apply`."""
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _decode_qkv(params, x, cfg, lengths, norm)
    cache = write_cache(cache, k, v, lengths)
    out = chunked_attention(q.transpose(1, 2), cache.k.transpose(1, 2),
                            cache.v.transpose(1, 2), causal=False, window=0,
                            q_offset=0, kv_len=lengths + 1)
    out = out.reshape(b, 1, hq * hd)
    return _out_proj(out, params["wo"], residual), cache
