"""Attention layer: GQA/MQA, RoPE, dense KV caches, sliding-window ring
buffers, cross-attention.

The projections go through the row-wise matmul primitive (one launch
over the stored ``wqkv`` panel with the pre-norm in its prologue when
fused; the residual in the output projection's epilogue). The core op
dispatches as the JAX package's ``_sdpa`` does:

  * full-sequence attention at a static offset (train, prefill, and
    cross-attention to the encoder's output) — ``ops.attention``: the
    hand-written flash kernel for CUDA tensors, its plain version for
    CPU tensors and under ``use_impl("ref")`` (which takes the chunked
    scan past ``DENSE_MAX_SEQ``);
  * a decode step, whose valid keys end at a per-row ``kv_len`` —
    :func:`chunked_attention`, the online-softmax scan over KV chunks in
    torch ops, as JAX runs it in jnp (the kernel takes no ``kv_len``).

A windowed layer's decode cache is a ring of at most ``window`` slots:
position p lives at slot p % slots, and every slot written attends.

Paged serving keeps each layer's KV in a pool of pages shared by every
slot (:class:`PagedKVCache`), addressed through per-slot block tables:
decode (:func:`paged_decode_apply`), chunked prefill
(:func:`paged_chunk_apply`) and the speculative verify
(:func:`paged_verify_apply`) gather a slot's pages in the same
online-softmax scan (:func:`_paged_fwd`), in torch ops as JAX runs them
in jnp; the pool is written in place (:func:`write_pages`,
:func:`write_chunk_pages`, :func:`copy_page`).

Not ported yet: the sequence-sharded decode (ROADMAP.md queue 1 item 7)
and the flash backward (item 9).
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
    hd) panel, q, k and v columns in that order, and ``wo``. Cross
    attention (``cross``) projects q from the decoder stream and k, v
    from the encoder's output: ``wq`` (d, Hq hd), the fused encoder-side
    ``wkv`` (d, 2 Hkv hd) and ``wo``. Drawn on the generator's device,
    placed on ``device``."""
    d, hd = cfg.d_model, cfg.head_dim
    qo = cfg.n_heads * hd
    lead = () if stack is None else (stack,)

    def w(din, dout):
        t = torch.randn(lead + (din, dout), generator=gen, device=gen.device,
                        dtype=torch.float32) / math.sqrt(din)
        return t.to(dtype=dtype, device=device)

    if cross:
        return {"wq": w(d, qo), "wkv": w(d, 2 * cfg.n_kv_heads * hd),
                "wo": w(qo, d)}
    return {"wqkv": w(d, sum(proj_splits(cfg))), "wo": w(qo, d)}


def _out_proj(out, wo, residual):
    """Output projection with the residual in its epilogue."""
    return ops.matmul(out, wo, residual=residual)


class KVCache(NamedTuple):
    """Per-layer KV cache. k/v: (B, S_alloc, Hkv, hd)."""
    k: torch.Tensor
    v: torch.Tensor


class PagedKVCache(NamedTuple):
    """Per-layer paged KV pool. k/v: (n_pages + n_slots, page_size,
    Hkv, hd).

    Physical pages are shared by every slot in the serving batch; the
    logical order of a slot's tokens lives in the engine's block table
    ((B, max_pages) int32: logical page ``l`` of row ``b`` is physical
    page ``table[b, l]``). The last ``n_slots`` physical pages are
    per-slot scratch pages — idle and mid-prefill slots' tables point
    at their own row so lockstep writes from those slots never touch
    live storage. Sliding-window layers reuse the first ``window //
    page_size`` table entries as a ring of pages.
    """
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


def _scan_start(qg):
    """The online softmax's running max, denominator and accumulator for
    grouped queries qg (B,Hkv,g,Sq,hd), all fp32."""
    m = torch.full(qg.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=qg.device)
    return m, torch.zeros_like(m), torch.zeros(qg.shape, dtype=torch.float32,
                                               device=qg.device)


def _scan_end(m, l, acc, q):
    """(out (B,Hq,Sq,hd) in q's dtype, lse (B,Hkv,g,Sq) fp32); the
    denominator floored at 1e-30, as JAX does."""
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).reshape(q.shape).to(q.dtype)
    return out, m + torch.log(l)


def _chunked_fwd(q, k, v, limit, *, causal, window, q_offset, chunk):
    """Returns (out (B,Hq,Sq,hd), lse (B,Hkv,g,Sq) fp32): the log-sum-exp
    lets a partial over these keys merge with another
    (:func:`_merge_partials`). The chunks are slices of k and v (the JAX
    package pads the last one; its padded keys lie past ``limit`` and
    are masked either way)."""
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    chunk = min(chunk, skv)
    qg = q.reshape(b, hkv, g, sq, hd)
    scale = hd ** -0.5
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m, l, acc = _scan_start(qg)
    for base in range(0, skv, chunk):
        kb, vb = k[:, :, base:base + chunk], v[:, :, base:base + chunk]
        mask = _chunk_mask(base, chunk, q_pos, limit, causal, window)
        m, l, acc = _online_update((m, l, acc), qg, kb, vb,
                                   mask[..., :kb.shape[2]], scale)
    return _scan_end(m, l, acc, q)


def _paged_fwd(q, k_pool, v_pool, pages, limit, *, chunk, q_offset=None,
               window: int = 0):
    """Online-softmax over a paged KV pool — the same row-wise LSE math
    as :func:`_chunked_fwd`, but each chunk *gathers* its KV rows from
    the pool through the block table instead of slicing a dense per-slot
    cache, so only a slot's live pages stream.

    q: (B,Hq,Sq,hd); k_pool/v_pool: (n_pages, page_size, Hkv, hd);
    pages: (B, n_logical_pages) block table; limit: (B,) valid token
    counts (logical positions >= limit are masked out).

    ``q_offset`` ((B,)) turns the single-position decode gather into a
    multi-query *prefix* gather for chunked prefill: query row i sits at
    absolute position ``q_offset + i`` and attends causally. ``window``
    marks the table as a sliding-window *ring* of ``window / page_size``
    pages: ring slot r holds the newest written position ≡ r (mod
    window) strictly below ``limit``, and each query also masks keys at
    or below ``q_pos - window``.
    Returns (out (B,Hq,Sq,hd), lse (B,Hkv,g,Sq) fp32).
    """
    b, hq, sq, hd = q.shape
    _, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    dev = q.device
    pages = pages.long()
    n_log = pages.shape[1]
    ppc = max(1, min(n_log, chunk // ps))      # pages gathered per chunk
    pad = (-n_log) % ppc
    if pad:
        # padding repeats the table's last entry; fully masked below
        pages = torch.cat([pages, pages[:, -1:].expand(b, pad)], dim=1)
    qg = q.reshape(b, hkv, g, sq, hd)
    scale = hd ** -0.5
    limit = limit[:, None]
    if q_offset is not None:
        q_pos = (q_offset[:, None]
                 + torch.arange(sq, device=dev)[None])[:, :, None]
    m, l, acc = _scan_start(qg)
    for base in range(0, n_log + pad, ppc):
        pid = pages[:, base:base + ppc]                         # (B, ppc)
        kb = k_pool[pid].reshape(b, ppc * ps, hkv, hd).transpose(1, 2)
        vb = v_pool[pid].reshape(b, ppc * ps, hkv, hd).transpose(1, 2)
        # logical slot index of each gathered row
        r = (base * ps + torch.arange(ppc * ps, device=dev))[None]
        if window:
            # ring: recover the absolute position each slot holds (the
            # newest p ≡ r (mod window) below limit); unwritten slots
            # (limit < window) resolve negative and mask out, padded
            # table slots (r >= window) are never ring storage. Integer
            # // floors, as JAX's does
            k_pos = r + ((limit - 1 - r) // window) * window       # (B, K)
            valid = (r < window) & (k_pos >= 0) & (k_pos < limit)
        else:
            k_pos = r
            valid = r < limit
        if q_offset is None:
            mask = valid[:, None, None, None, :]
        else:
            qm = k_pos[:, None, :] <= q_pos                        # causal
            if window:
                qm = qm & (k_pos[:, None, :] > q_pos - window)
            mask = (valid[:, None, :] & qm)[:, None, None]
        m, l, acc = _online_update((m, l, acc), qg, kb, vb, mask, scale)
    return _scan_end(m, l, acc, q)


def chunked_attention(q, k, v, *, causal=True, window: int = 0,
                      q_offset=0, kv_len=None, chunk: int = 1024,
                      pages=None):
    """Online-softmax scan over KV chunks. q: (B,Hq,Sq,hd); k/v GQA.

    ``q_offset`` may be a tensor; ``kv_len`` (int or (B,)) masks the
    padded cache. Forward only (the flash backward comes with training,
    ROADMAP.md queue 1 item 9).

    pages: optional (B, n_logical_pages) block table. When given, k/v
    are page *pools* (n_pages, page_size, Hkv, hd) and every chunk
    gathers its KV rows through the table (paged decode; causality and
    windowing are expressed through kv_len by the caller).
    """
    b = q.shape[0]
    if pages is not None:
        limit = torch.as_tensor(kv_len, device=q.device).expand(b)
        return _paged_fwd(q, k, v, pages, limit, chunk=chunk)[0]
    limit = k.shape[2] if kv_len is None else kv_len
    limit = torch.as_tensor(limit, device=q.device).expand(b)
    return _chunked_fwd(q, k, v, limit, causal=causal, window=window,
                        q_offset=q_offset, chunk=chunk)[0]


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

    kv: (enc_out, enc_out) for cross-attention — k and v project from
    that ONE encoder stream through the fused ``wkv`` panel (one launch
    when fused, two over its halves when not); q from ``wq``, unroped.
    norm: fused-pipeline mode — x arrives *un-normalized* and the
    pre-norm runs as the qkv kernel's prologue over the stored panel.
    residual: folded into the output projection's epilogue.
    Returns (out, (k_heads, v_heads)) — the heads prefill caches: k
    RoPE'd, v a view of the projection's output.
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kv is None:
        q, k, v = _project_qkv(params, x, cfg, norm)
        q = q.reshape(b, s, hq, hd)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
        q, k = _apply_rope(q, k, cfg, positions)
    else:
        xk, xv = kv
        if xk is not xv:
            raise ValueError("cross-attention projects k and v from one "
                             "encoder stream through the fused wkv panel")
        sk, kvo = xk.shape[1], hkv * hd
        q = ops.matmul(x, params["wq"], norm=norm).reshape(b, s, hq, hd)
        if runtime.pipeline_fusion():
            k, v = ops.qkv_proj(xk, params["wkv"], (kvo, kvo))
        else:
            wkv = quant.resolve_weight(params["wkv"], xk.dtype)
            k = ops.matmul(xk, wkv[..., :kvo])
            v = ops.matmul(xk, wkv[..., kvo:])
        k = k.reshape(b, sk, hkv, hd)
        v = v.reshape(b, sk, hkv, hd)
    # head views, read through their strides by the kernel
    out = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return _out_proj(out, params["wo"], residual), (k, v)


def write_cache(cache: KVCache, k_new, v_new, pos):
    """Insert (B, S_new, Hkv, hd) states at position ``pos`` (int or
    (B,)), wrapping at the cache's length: a windowed layer's ring
    buffer takes position p at slot p % slots, as a global layer's cache
    wraps past ``alloc``. Written IN PLACE into the cache's storage (a
    step would otherwise copy the whole cache); the cache is returned."""
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
                 lengths, window: int = 0,
                 norm: Optional[ops.NormSpec] = None, residual=None):
    """One-token decode. x: (B, 1, d); lengths: (B,) tokens already in
    cache. The new token's k/v are written into ``cache`` in place (a
    windowed layer's at its ring slot). Returns (out, cache).
    norm/residual as in :func:`apply`."""
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _decode_qkv(params, x, cfg, lengths, norm)
    cache = write_cache(cache, k, v, lengths)
    alloc = cache.k.shape[1]
    if window and window <= alloc:
        # the ring holds exactly the last ``window`` tokens: every slot
        # written attends (causality is implied by what was written)
        kv_len = torch.clamp(lengths + 1, max=alloc)
    else:
        kv_len = lengths + 1
    out = chunked_attention(q.transpose(1, 2), cache.k.transpose(1, 2),
                            cache.v.transpose(1, 2), causal=False, window=0,
                            q_offset=0, kv_len=kv_len)
    out = out.reshape(b, 1, hq * hd)
    return _out_proj(out, params["wo"], residual), cache


# ----------------------------------------------------------------------
# Paged serving: the pool's writes and copies, and the paged forwards
# ----------------------------------------------------------------------


def write_pages(pool: PagedKVCache, k_new, v_new, pos, pages,
                window: int = 0):
    """Append the decode token's K/V (B,1,Hkv,hd) at logical position
    ``pos`` (B,) through the block table ``pages`` (B, n_logical), IN
    PLACE. Windowed layers treat the first ``window // page_size`` table
    entries as a ring of pages (the paged analog of the dense ring
    buffer's ``pos % window`` write). The logical page is clipped to the
    table, as in JAX, so no row is dropped and no host sync is needed."""
    ps = pool.k.shape[1]
    r = pos if window == 0 else pos % window
    lp = torch.clamp(r // ps, 0, pages.shape[1] - 1).long()
    pid = torch.gather(pages.long(), 1, lp[:, None])[:, 0]        # (B,)
    off = (r % ps).long()
    pool.k[pid, off] = k_new[:, 0].to(pool.k.dtype)
    pool.v[pid, off] = v_new[:, 0].to(pool.v.dtype)
    return pool


def _merge_partials(out_a, lse_a, out_b, lse_b):
    """Combine two partial online-softmax results over *disjoint* KV
    sets (the prefix-page gather and the in-flight chunk) into the exact
    softmax over their union — the flash-decode LSE merge.
    out: (B,Hq,Sq,hd); lse: (B,Hkv,g,Sq) fp32. A fully-masked partial
    carries lse ≈ -1e30 and drops out with weight 0 (the max-shift keeps
    the other side's weight at exp(0) = 1, so the denominator never
    vanishes)."""
    b, hq, sq, hd = out_a.shape
    hkv, g = lse_a.shape[1], lse_a.shape[2]
    oa = out_a.reshape(b, hkv, g, sq, hd).float()
    ob = out_b.reshape(b, hkv, g, sq, hd).float()
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    out = ((oa * wa[..., None] + ob * wb[..., None])
           / (wa + wb)[..., None])
    return out.reshape(b, hq, sq, hd).to(out_a.dtype)


def chunk_targets(offset, chunk_len, pages, sc: int, windows, page_size):
    """Where a panel of ``sc`` rows per table row lands in the pool, for
    each window of ``windows``: ``{window: (bi, si, pid, off)}``, the
    panel rows ``(bi, si)`` that are written and their physical page and
    row. Row i of table row b sits at logical position ``offset[b] + i``
    and is written when ``i < chunk_len[b]`` and, for a windowed layer,
    when it is among the chunk's last ``window`` positions (an earlier
    row would be clobbered by a later one at the same ring slot, and no
    query needs it), which keeps the targets duplicate-free.

    JAX routes the other rows to the out-of-range page id and its
    scatter drops them; a torch scatter has no such mode, so the rows to
    keep are listed instead. The mask depends only on the offsets,
    lengths and windows, the same for every layer: a caller builds the
    targets once and hands each layer its window's, for one host read
    of the mask a call. ``offset`` and ``chunk_len``: int or (B,)."""
    pages = pages.long()
    b, n_log = pages.shape
    dev = pages.device
    offset = torch.as_tensor(offset, device=dev).long().expand(b)
    clen = torch.as_tensor(chunk_len, device=dev).long().expand(b)
    i = torch.arange(sc, device=dev)
    pos = offset[:, None] + i[None]                                # (B, Sc)
    real = i[None] < clen[:, None]
    masks = torch.stack([real & (pos >= (offset + clen)[:, None] - w)
                         if w else real for w in windows])
    masks = masks.cpu()                   # the call's one host read
    out = {}
    for w, mask in zip(windows, masks):
        bi, si = (t.to(dev, non_blocking=True)
                  for t in mask.nonzero(as_tuple=True))
        r = pos[bi, si] % w if w else pos[bi, si]
        lp = torch.clamp(r // page_size, 0, n_log - 1)
        out[w] = (bi, si, pages[bi, lp], r % page_size)
    return out


def write_chunk_pages(pool: PagedKVCache, k_new, v_new, offset, chunk_len,
                      pages, window: int = 0, targets=None):
    """Append a prefill chunk's K/V (B, Sc, Hkv, hd) at logical
    positions ``offset .. offset + chunk_len - 1`` through the block
    table ``pages`` (B, n_logical), IN PLACE — the multi-token
    generalization of :func:`write_pages`. ``offset`` and ``chunk_len``
    are scalar or per-row (B,) — per-row ``chunk_len`` is how the
    speculative verify step writes only each slot's *accepted* draft
    rows (a row with ``chunk_len == 0`` writes nothing). Right padding
    (rows >= chunk_len) is not written. Windowed layers write through
    the ring (``pos % window``) and keep only the chunk's last
    ``window`` positions. ``targets``: this window's entry of
    :func:`chunk_targets` for these arguments, built once per call by
    the caller (else built here).

    Every page this scatter can touch must be slot-private (refcount 1):
    a shared prefix page is remapped by :func:`copy_page` first."""
    if targets is None:
        targets = chunk_targets(offset, chunk_len, pages, k_new.shape[1],
                                (window,), pool.k.shape[1])[window]
    bi, si, pid, off = targets
    pool.k[pid, off] = k_new[bi, si].to(pool.k.dtype)
    pool.v[pid, off] = v_new[bi, si].to(pool.v.dtype)
    return pool


def copy_page(pool: PagedKVCache, src, dst):
    """Copy one physical page's K/V rows ``src`` → ``dst`` on the
    *stored* 5-D leaves (R, P, ps, Hkv, hd), in place — the
    copy-on-write step before a slot's first write into a shared
    prefix-cache page. ``src == dst`` is the identity (the non-COW
    steady state). Rows past the kept prefix carry donor garbage; length
    masking hides them until the slot overwrites them."""
    src, dst = int(src), int(dst)
    if src != dst:
        pool.k[:, dst] = pool.k[:, src]
        pool.v[:, dst] = pool.v[:, src]
    return pool


def paged_chunk_apply(params, x, pool: PagedKVCache, *, cfg: ModelConfig,
                      offset, chunk_len, pages, window: int = 0,
                      norm: Optional[ops.NormSpec] = None, residual=None,
                      targets=None):
    """Chunked-prefill forward for one attention layer: a row panel of
    ``Sc`` prompt tokens starting at absolute position ``offset`` ((B,)),
    of which the first ``chunk_len`` are real (right padding masked).
    x: (B, Sc, d). Returns (out, pool), the chunk's K/V written into the
    pool in place; norm/residual as in :func:`apply`; ``targets`` as in
    :func:`write_chunk_pages`.

    Attention is the exact softmax over prefix ∪ chunk, from two
    partials sharing the row-wise ``_online_update`` math: the written
    KV pages through the multi-query :func:`_paged_fwd` prefix gather
    (per-query window masking, ring position recovery), and the chunk
    itself, causally, through :func:`_chunked_fwd` in chunk-relative
    coordinates (the window is translation-invariant); merged by
    :func:`_merge_partials`. The chunk's K/V are written strictly after
    the prefix gather, so ring writes cannot clobber prefix keys the
    chunk's queries still need.
    """
    out, k, v = _chunk_attn_core(params, x, pool, cfg=cfg, offset=offset,
                                 chunk_len=chunk_len, pages=pages,
                                 window=window, norm=norm,
                                 residual=residual)
    pool = write_chunk_pages(pool, k, v, offset, chunk_len, pages, window,
                             targets=targets)
    return out, pool


def _chunk_attn_core(params, x, pool: PagedKVCache, *, cfg: ModelConfig,
                     offset, chunk_len, pages, window: int,
                     norm: Optional[ops.NormSpec], residual):
    """Shared math of :func:`paged_chunk_apply` /
    :func:`paged_verify_apply`: exact softmax over prefix ∪ chunk with
    no pool mutation. Returns (projected out, chunk k, chunk v)."""
    b, sc, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = x.device
    offset = torch.as_tensor(offset, device=dev).expand(b)
    clen = torch.as_tensor(chunk_len, device=dev).expand(b)
    positions = offset[:, None] + torch.arange(sc, dtype=torch.int32,
                                               device=dev)[None]
    q, k, v = _project_qkv(params, x, cfg, norm)
    q = q.reshape(b, sc, hq, hd)
    k = k.reshape(b, sc, hkv, hd)
    v = v.reshape(b, sc, hkv, hd)
    q, k = _apply_rope(q, k, cfg, positions)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out_c, lse_c = _chunked_fwd(qh, kh, vh, clen, causal=True,
                                window=window, q_offset=0, chunk=1024)
    ps = pool.k.shape[1]
    tbl = pages[:, :max(window // ps, 1)] if window else pages
    out_p, lse_p = _paged_fwd(qh, pool.k, pool.v, tbl, offset, chunk=1024,
                              q_offset=offset, window=window)
    out = _merge_partials(out_c, lse_c, out_p, lse_p)
    out = out.transpose(1, 2).reshape(b, sc, hq * hd)
    return _out_proj(out, params["wo"], residual), k, v


def paged_verify_apply(params, x, pool: PagedKVCache, *,
                       cfg: ModelConfig, offset, chunk_len, pages,
                       window: int = 0,
                       norm: Optional[ops.NormSpec] = None,
                       residual=None):
    """Speculative-verify forward for one attention layer: the attention
    math of :func:`paged_chunk_apply` over the draft panel, but the
    panel's K/V are NOT written to the pool — they are returned so the
    engine can score the logits first and then write only the accepted
    prefix rows (``lm.insert_verify``). A rejected draft never touches
    the pool, which matters for sliding-window rings: its write would
    clobber prefix keys the re-decode of that position still needs.
    Returns (out, (k, v))."""
    out, k, v = _chunk_attn_core(params, x, pool, cfg=cfg, offset=offset,
                                 chunk_len=chunk_len, pages=pages,
                                 window=window, norm=norm,
                                 residual=residual)
    return out, (k, v)


def paged_decode_apply(params, x, pool: PagedKVCache, *, cfg: ModelConfig,
                       lengths, pages, window: int = 0,
                       norm: Optional[ops.NormSpec] = None, residual=None):
    """One-token decode against a paged KV pool. x: (B, 1, d); lengths:
    (B,) tokens already written; pages: (B, max_pages) block table.
    The token's K/V are written into the pool in place. Returns (out,
    pool); norm/residual as in :func:`apply`.

    The attention core is the dense decode's online-softmax scan, each
    chunk gathering only the slot's pages; idle table entries point at
    the slot's scratch page and are masked by kv_len.
    """
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _decode_qkv(params, x, cfg, lengths, norm)
    pool = write_pages(pool, k, v, lengths, pages, window)
    ps = pool.k.shape[1]
    if window:
        tbl = pages[:, :max(window // ps, 1)]
        kv_len = torch.clamp(lengths + 1, max=window)
    else:
        tbl = pages
        kv_len = lengths + 1
    out = chunked_attention(q.transpose(1, 2), pool.k, pool.v, causal=False,
                            window=0, kv_len=kv_len, pages=tbl)
    out = out.reshape(b, 1, hq * hd)
    return _out_proj(out, params["wo"], residual), pool
