"""Vision transformers (Swin / ViT) — the paper's own target workload.

Runs the row-wise kernels end to end: patch-embed conv -> the same
matmul primitive (Sec. IV-C), FC layers -> row-wise matmul (Sec. IV-D),
W-MSA -> Q-stationary attention within 7x7 windows (Sec. IV-E).

With pipeline fusion on (the default) a Swin block runs as four
row-wise matmul launches — [ln1-prologue + qkv], [proj + residual],
[ln2-prologue + mlp1 + gelu], [mlp2 + residual] — plus the flash window
attention kernel, which takes the relative-position bias (and shift
mask) as an additive score operand. With fusion off, the per-op
composition runs: separate norm kernels, dense 49x49 window scores in
plain torch, residual adds outside the kernels.

``swin_forward`` is an entry point of the port's trace
(``core/trace.py``): under it, the spans ``vision.stage``,
``vision.block``, ``vision.merge`` and ``vision.head``.

The functional forwards take a parameter tree of nested dicts and lists
of tensors, the same tree as the JAX package's (``from_jax_params``
converts one); the ``nn.Module`` wrappers hold such a tree as
parameters.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from repro_torch.configs.swin_t import CONFIG, VIT_CONFIG, SwinConfig, ViTConfig
from repro_torch.core import runtime, trace
from repro_torch.core.params import ParamTree
from repro_torch.kernels import ops


def _w(gen, din, dout, dtype, device):
    w = torch.randn((din, dout), generator=gen, device=gen.device,
                    dtype=torch.float32) / math.sqrt(din)
    return w.to(dtype=dtype, device=device)


def _window_partition(x, w):
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(xw, w, h, wd):
    b = xw.shape[0] // ((h // w) * (wd // w))
    x = xw.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


@functools.lru_cache(maxsize=16)
def _rel_pos_index(w: int, device: torch.device):
    """(w*w, w*w) index into the relative-position table. Cached per
    geometry: a constant, never written."""
    ar = torch.arange(w)
    coords = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), 0)
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (w - 1)
    return (rel[0] * (2 * w - 1) + rel[1]).to(device)


@functools.lru_cache(maxsize=16)
def _shift_mask(h, wd, w, shift, device: torch.device):
    """Attention mask for shifted windows (standard Swin): (nW, w*w,
    w*w), 0 within a region and -1e9 across. Cached per geometry: a
    constant, never written."""
    img = torch.zeros((1, h, wd, 1))
    cnt = 0
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = _window_partition(img, w).reshape(-1, w * w)
    diff = mw[:, :, None] - mw[:, None, :]
    return torch.where(diff == 0, 0.0, -1e9).to(torch.float32).to(device)


def init_swin(cfg: SwinConfig, generator: torch.Generator, device="cuda",
              dtype=torch.float32):
    """Random Swin parameters (the JAX package's tree of keys), drawn
    from ``generator`` and placed on ``device``."""
    device = runtime.resolve_device(device)
    d = cfg.embed_dim

    def w(din, dout):
        return _w(generator, din, dout, dtype, device)

    def const(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    params = {
        "patch_w": w(cfg.patch * cfg.patch * cfg.in_chans, d),
        "patch_b": const(d, 0.0),
        "stages": [],
    }
    c = d
    for si, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        stage = {"blocks": []}
        hidden = int(cfg.mlp_ratio * c)
        for _bi in range(depth):
            rel = torch.randn(((2 * cfg.window - 1) ** 2, heads),
                              generator=generator, device=generator.device)
            stage["blocks"].append({
                "ln1_g": const(c, 1.0), "ln1_b": const(c, 0.0),
                "qkv": w(c, 3 * c), "qkv_b": const(3 * c, 0.0),
                "proj": w(c, c), "proj_b": const(c, 0.0),
                "ln2_g": const(c, 1.0), "ln2_b": const(c, 0.0),
                "mlp1": w(c, hidden), "mlp1_b": const(hidden, 0.0),
                "mlp2": w(hidden, c), "mlp2_b": const(c, 0.0),
                "rel_bias": (rel * 0.02).to(dtype=dtype, device=device),
            })
        if si < len(cfg.depths) - 1:
            stage["merge"] = w(4 * c, 2 * c)
            c *= 2
        params["stages"].append(stage)
    params["norm_g"] = const(c, 1.0)
    params["norm_b"] = const(c, 0.0)
    params["head"] = w(c, cfg.num_classes)
    params["head_b"] = const(cfg.num_classes, 0.0)
    return params


def _rel_bias(blk, rel_idx, heads, shift, mask):
    """Additive score bias (nb, heads, t, t): the relative-position
    table gathered per window geometry, plus the shift mask per
    window position when the block is shifted."""
    t = rel_idx.shape[0]
    rel = blk["rel_bias"][rel_idx.reshape(-1)]
    bias = rel.reshape(t, t, heads).permute(2, 0, 1)[None]    # (1,h,t,t)
    if shift:
        bias = bias + mask[:, None]                 # (nW_img, h, t, t)
    return bias


def _wmsa(blk, x, heads, w, shift, rel_idx, mask):
    """Per-op window attention: dense 49x49 scores in plain torch (the
    JAX package leaves them to XLA), separate norm/residual launches
    handled by the caller. The fusion-off baseline."""
    b, h, wd, c = x.shape
    hd = c // heads
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = _window_partition(x, w)                   # (B*nW, w*w, C)
    qkv = ops.matmul(xw, blk["qkv"], bias=blk["qkv_b"])
    q, k, v = torch.split(qkv, c, dim=-1)
    nw, t, _ = q.shape

    def heads_of(z):
        return z.reshape(nw, t, heads, hd).permute(0, 2, 1, 3)

    q, k, v = heads_of(q), heads_of(k), heads_of(v)
    s = torch.einsum("nhqd,nhkd->nhqk", q, k) * hd ** -0.5
    bias = blk["rel_bias"][rel_idx.reshape(-1)]
    s = s + bias.reshape(t, t, heads).permute(2, 0, 1)[None]
    if shift:
        n_img = (h // w) * (wd // w)
        # JAX's mask is weakly typed (jnp.where of Python scalars), so it
        # joins in the scores' dtype and bf16 scores stay bf16 there too
        s = s.reshape(-1, n_img, heads, t, t) + mask[None, :, None].to(s.dtype)
        s = s.reshape(nw, heads, t, t)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("nhqk,nhkd->nhqd", p, v)
    o = o.permute(0, 2, 1, 3).reshape(nw, t, c)
    o = ops.matmul(o, blk["proj"], bias=blk["proj_b"])
    x = _window_reverse(o, w, h, wd)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    return x


def _swin_block_fused(blk, x, heads, w, shift, rel_idx, mask):
    """One Swin block as the fused pipeline: [ln1-prologue + qkv],
    flash window attention with the bias operand, [proj + residual],
    [ln2-prologue + mlp1 + gelu], [mlp2 + residual]."""
    b, h, wd, c = x.shape
    hd = c // heads
    xr = torch.roll(x, (-shift, -shift), dims=(1, 2)) if shift else x
    xw = _window_partition(xr, w)                  # (B*nW, t, C)
    nw, t, _ = xw.shape
    q, k, v = ops.qkv_proj(xw, blk["qkv"], (c, c, c), bias=blk["qkv_b"],
                           norm=ops.NormSpec("layer", blk["ln1_g"],
                                             blk["ln1_b"]))

    def heads_of(z):
        return z.reshape(nw, t, heads, hd).permute(0, 2, 1, 3)

    bias = _rel_bias(blk, rel_idx, heads, shift, mask)
    o = ops.attention(heads_of(q), heads_of(k), heads_of(v),
                      causal=False, bias=bias)
    o = o.permute(0, 2, 1, 3).reshape(nw, t, c)
    # residual add in window layout == image layout (pure permutation)
    o = ops.matmul(o, blk["proj"], bias=blk["proj_b"], residual=xw)
    xr = _window_reverse(o, w, h, wd)
    x = torch.roll(xr, (shift, shift), dims=(1, 2)) if shift else xr

    xf = x.reshape(-1, c)
    hdn = ops.matmul(xf, blk["mlp1"], bias=blk["mlp1_b"],
                     activation="gelu",
                     norm=ops.NormSpec("layer", blk["ln2_g"],
                                       blk["ln2_b"]))
    return ops.matmul(hdn, blk["mlp2"], bias=blk["mlp2_b"],
                      residual=xf).reshape(x.shape)


def _swin_block(blk, x, heads, w, shift, rel_idx, mask):
    """One Swin block as the per-op composition (fusion off)."""
    c = x.shape[-1]
    res = x
    xn = ops.layernorm(x.reshape(-1, c), blk["ln1_g"],
                       blk["ln1_b"]).reshape(x.shape)
    x = res + _wmsa(blk, xn, heads, w, shift, rel_idx, mask)
    res = x
    xn = ops.layernorm(x.reshape(-1, c), blk["ln2_g"],
                       blk["ln2_b"]).reshape(x.shape)
    hdn = ops.matmul(xn, blk["mlp1"], bias=blk["mlp1_b"], activation="gelu")
    return res + ops.matmul(hdn, blk["mlp2"], bias=blk["mlp2_b"])


@trace.traced("vision.swin_forward", is_entry=True)
def swin_forward(params, images, cfg: SwinConfig):
    """images: (B, H, W, 3) -> logits (B, classes), fp32."""
    w = cfg.window
    x = ops.patch_embed(images, params["patch_w"], params["patch_b"],
                        patch=cfg.patch)          # (B, H/4, W/4, D)
    rel_idx = _rel_pos_index(w, x.device)
    block = (_swin_block_fused if runtime.pipeline_fusion()
             else _swin_block)
    for si, (_depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        stage = params["stages"][si]
        with trace.span("vision.stage"):
            b, h, wd, c = x.shape
            mask = _shift_mask(h, wd, w, w // 2, x.device) if h > w else None
            for bi, blk in enumerate(stage["blocks"]):
                shift = (w // 2) if (bi % 2 == 1 and h > w) else 0
                with trace.span("vision.block"):
                    x = block(blk, x, heads, w, shift, rel_idx, mask)
            if "merge" in stage:
                with trace.span("vision.merge"):
                    b, h, wd, c = x.shape
                    x = x.reshape(b, h // 2, 2, wd // 2, 2, c)
                    x = x.permute(0, 1, 3, 2, 4, 5).reshape(
                        b, h // 2, wd // 2, 4 * c)
                    x = ops.matmul(x, stage["merge"])
    with trace.span("vision.head"):
        b, h, wd, c = x.shape
        x = ops.layernorm(x.reshape(-1, c), params["norm_g"],
                          params["norm_b"]).reshape(b, h * wd, c)
        x = torch.mean(x, dim=1)
        return ops.matmul(x, params["head"], bias=params["head_b"],
                          out_dtype=torch.float32)


# ------------------------------- ViT ----------------------------------


def init_vit(cfg: ViTConfig, generator: torch.Generator, device="cuda",
             dtype=torch.float32):
    device = runtime.resolve_device(device)
    d = cfg.embed_dim
    tokens = (cfg.img_size // cfg.patch) ** 2
    hidden = int(cfg.mlp_ratio * d)

    def w(din, dout):
        return _w(generator, din, dout, dtype, device)

    def const(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    pos = torch.randn((1, tokens + 1, d), generator=generator,
                      device=generator.device) * 0.02
    params = {
        "patch_w": w(cfg.patch * cfg.patch * cfg.in_chans, d),
        "patch_b": const(d, 0.0),
        "cls": torch.zeros((1, 1, d), dtype=dtype, device=device),
        "pos": pos.to(dtype=dtype, device=device),
        "blocks": [],
    }
    for _ in range(cfg.depth):
        params["blocks"].append({
            "ln1_g": const(d, 1.0), "ln1_b": const(d, 0.0),
            "qkv": w(d, 3 * d),
            "proj": w(d, d),
            "ln2_g": const(d, 1.0), "ln2_b": const(d, 0.0),
            "mlp1": w(d, hidden),
            "mlp2": w(hidden, d),
        })
    params["norm_g"] = const(d, 1.0)
    params["norm_b"] = const(d, 0.0)
    params["head"] = w(d, cfg.num_classes)
    return params


def vit_forward(params, images, cfg: ViTConfig):
    x = ops.patch_embed(images, params["patch_w"], params["patch_b"],
                        patch=cfg.patch)
    b = x.shape[0]
    d = cfg.embed_dim
    x = x.reshape(b, -1, d)
    x = torch.cat([params["cls"].expand(b, 1, d).to(x.dtype), x], 1)
    x = x + params["pos"].to(x.dtype)
    heads = cfg.num_heads
    hd = d // heads
    fuse = runtime.pipeline_fusion()
    for blk in params["blocks"]:
        def hsplit(z):
            return z.reshape(b, -1, heads, hd).permute(0, 2, 1, 3)

        if fuse:
            q, k, v = ops.qkv_proj(x, blk["qkv"], (d, d, d),
                                   norm=ops.NormSpec("layer", blk["ln1_g"],
                                                     blk["ln1_b"]))
            o = ops.attention(hsplit(q), hsplit(k), hsplit(v),
                              causal=False)
            o = o.permute(0, 2, 1, 3).reshape(b, -1, d)
            x = ops.matmul(o, blk["proj"], residual=x)
            h = ops.matmul(x, blk["mlp1"], activation="gelu",
                           norm=ops.NormSpec("layer", blk["ln2_g"],
                                             blk["ln2_b"]))
            x = ops.matmul(h, blk["mlp2"], residual=x)
            continue
        xn = ops.layernorm(x, blk["ln1_g"], blk["ln1_b"])
        q, k, v = torch.split(ops.matmul(xn, blk["qkv"]), d, dim=-1)
        o = ops.attention(hsplit(q), hsplit(k), hsplit(v), causal=False)
        o = o.permute(0, 2, 1, 3).reshape(b, -1, d)
        x = x + ops.matmul(o, blk["proj"])
        xn = ops.layernorm(x, blk["ln2_g"], blk["ln2_b"])
        h = ops.matmul(xn, blk["mlp1"], activation="gelu")
        x = x + ops.matmul(h, blk["mlp2"])
    x = ops.layernorm(x, params["norm_g"], params["norm_b"])
    return ops.matmul(x[:, 0], params["head"], out_dtype=torch.float32)


# --------------------------- nn.Module wrappers ------------------------


class SwinTransformer(nn.Module):
    """Swin forward as a module. ``params``: a tree as ``init_swin`` or
    ``from_jax_params`` make it; by default a random one drawn from
    ``generator`` (seed 0). Runs on the card unless ``device="cpu"``."""

    def __init__(self, cfg: SwinConfig = CONFIG, params=None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        device = runtime.resolve_device(device)
        if params is None:
            params = init_swin(cfg, generator or torch.Generator()
                               .manual_seed(0), device=device, dtype=dtype)
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return swin_forward(self.params.tree(), images, self.cfg)


class VisionTransformer(nn.Module):
    """ViT forward as a module; see :class:`SwinTransformer`."""

    def __init__(self, cfg: ViTConfig = VIT_CONFIG, params=None, *,
                 device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        device = runtime.resolve_device(device)
        if params is None:
            params = init_vit(cfg, generator or torch.Generator()
                              .manual_seed(0), device=device, dtype=dtype)
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return vit_forward(self.params.tree(), images, self.cfg)
