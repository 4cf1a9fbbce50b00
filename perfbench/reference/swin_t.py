"""Plain fp32 Swin-T (Liu et al. 2021, arXiv:2103.14030; the layer
equations of Sec. 3.1-3.2), from the weights the harness makes.

Shifted-window attention as the paper computes it: the pre-norm, the
cyclic shift by half a window, window partition, multi-head attention
with the relative-position bias table and the shift mask, the window
reverse and the shift back, then the pre-norm MLP; patch merging
between stages; the final norm, the mean over tokens and the head.
Where the port departs from the paper (``configs/swin_t.json``,
``departures``) this computes what the port computes: no norm after the
patch embedding or before a merge, the merge reading the 2x2
neighbours in row-major order, GELU's tanh form, LayerNorm eps 1e-6.
The shift mask adds -100, as the paper's code does (the port adds -1e9:
the same softmax in fp32).

``precision="fp8"`` is the control: every projection's operands
rounded to e4m3 (``common.linear``).
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.common import (gelu_tanh, layer_norm, linear,
                                        no_tf32)

EPS = 1e-6


def _layout(cfg, take):
    """The weights in the paper's terms, each drawn by ``take(shape,
    kind, fan_in)``: kind "w" N(0, 1/fan_in), "b" N(0, 0.02^2),
    "g" 1 + N(0, 0.1^2), "t" N(0, 0.02^2) (relative-position tables)."""
    p, cin, d = cfg["patch_size"], cfg["in_chans"], cfg["embed_dim"]
    w = {"patch_w": take((p * p * cin, d), "w", p * p * cin),
         "patch_b": take((d,), "b"), "stages": []}
    c = d
    n = len(cfg["depths"])
    for si, (depth, heads) in enumerate(zip(cfg["depths"],
                                            cfg["num_heads"])):
        hid = int(cfg["mlp_ratio"] * c)
        ws = cfg["window_size"]
        blocks = [{
            "norm1_g": take((c,), "g"), "norm1_b": take((c,), "b"),
            "qkv_w": take((c, 3 * c), "w", c), "qkv_b": take((3 * c,), "b"),
            "table": take(((2 * ws - 1) ** 2, heads), "t"),
            "proj_w": take((c, c), "w", c), "proj_b": take((c,), "b"),
            "norm2_g": take((c,), "g"), "norm2_b": take((c,), "b"),
            "fc1_w": take((c, hid), "w", c), "fc1_b": take((hid,), "b"),
            "fc2_w": take((hid, c), "w", hid), "fc2_b": take((c,), "b"),
        } for _ in range(depth)]
        stage = {"blocks": blocks}
        if si < n - 1:
            stage["merge_w"] = take((4 * c, 2 * c), "w", 4 * c)
            c *= 2
        w["stages"].append(stage)
    w["norm_g"] = take((c,), "g")
    w["norm_b"] = take((c,), "b")
    w["head_w"] = take((c, cfg["num_classes"]), "w", c)
    w["head_b"] = take((cfg["num_classes"],), "b")
    return w


# each leaf starts ALIGN elements into the buffer: 256 bytes, as a
# tensor of its own would (the port's matmul reads weights through TMA
# only from 16-byte aligned rows)
ALIGN = 128


def make_weights(cfg, seed: int, device, dtype):
    """The weights from ``seed``: one buffer of standard normals drawn on
    ``device`` in one call, in ``dtype`` (the served type), then each
    leaf, a view of it at an aligned offset, scaled in place."""
    from perfbench.harness import derive_seed
    sizes = []
    _layout(cfg, lambda shape, kind, fan_in=None:
            sizes.append(-(-math.prod(shape) // ALIGN) * ALIGN))
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "weights"))
    flat = torch.empty(sum(sizes), device=device, dtype=dtype)
    flat.normal_(0.0, 1.0, generator=gen)
    at = [0]

    def take(shape, kind, fan_in=None):
        n = math.prod(shape)
        v = flat[at[0]:at[0] + n].view(shape)
        at[0] += -(-n // ALIGN) * ALIGN
        if kind == "w":
            v.mul_(fan_in ** -0.5)
        elif kind in ("b", "t"):
            v.mul_(0.02)
        else:
            v.mul_(0.1).add_(1.0)
        return v

    return _layout(cfg, take)


def make_images(cfg, n: int, batch: int, seed: int, device, dtype):
    """``n`` batches of ``batch`` images (B, H, W, C), standard normals
    as normalised pixels, drawn on ``device``."""
    from perfbench.harness import derive_seed
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "images"))
    s, c = cfg["img_size"], cfg["in_chans"]
    out = torch.empty((n, batch, s, s, c), device=device, dtype=dtype)
    return out.normal_(0.0, 1.0, generator=gen)


def _rel_index(ws, device):
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).to(device)                        # (t, t)


def _partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def _reverse(xw, ws, h, w):
    b = xw.shape[0] // ((h // ws) * (w // ws))
    x = xw.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _shift_mask(h, w, ws, shift, device):
    img = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = _partition(img, ws).squeeze(-1)                 # (nW, t)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)           # (nW, t, t)


def _block(x, blk, heads, ws, shift, precision):
    b, h, w, c = x.shape
    hd = c // heads
    t = ws * ws
    shortcut = x
    y = layer_norm(x, blk["norm1_g"], blk["norm1_b"], EPS)
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    yw = _partition(y, ws)
    nwb = yw.shape[0]
    qkv = linear(yw, blk["qkv_w"], precision, blk["qkv_b"])
    qkv = qkv.view(nwb, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1)
    table = blk["table"].float()[_rel_index(ws, x.device).view(-1)]
    attn = attn + table.view(t, t, heads).permute(2, 0, 1)[None]
    if shift:
        mask = _shift_mask(h, w, ws, shift, x.device)
        nw = mask.shape[0]
        attn = (attn.view(nwb // nw, nw, heads, t, t)
                + mask[None, :, None]).view(nwb, heads, t, t)
    o = (attn.softmax(-1) @ v).transpose(1, 2).reshape(nwb, t, c)
    o = _reverse(linear(o, blk["proj_w"], precision, blk["proj_b"]),
                 ws, h, w)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    x = shortcut + o
    y = layer_norm(x, blk["norm2_g"], blk["norm2_b"], EPS)
    y = gelu_tanh(linear(y, blk["fc1_w"], precision, blk["fc1_b"]))
    return x + linear(y, blk["fc2_w"], precision, blk["fc2_b"])


@torch.no_grad()
def logits(w, cfg, images, precision: str = "fp32"):
    """images (B, H, W, C) -> fp32 logits (B, classes)."""
    with no_tf32():
        p = cfg["patch_size"]
        b, s, _, cin = images.shape
        # the stride-p p x p convolution, on each patch's (py, px, c) row
        x = images.float().view(b, s // p, p, s // p, p, cin)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, s // p, s // p,
                                               p * p * cin)
        x = linear(x, w["patch_w"], precision, w["patch_b"])
        for stage, heads in zip(w["stages"], cfg["num_heads"]):
            res = x.shape[1]
            ws = min(cfg["window_size"], res)
            for bi, blk in enumerate(stage["blocks"]):
                shift = ws // 2 if (bi % 2 == 1 and res > ws) else 0
                x = _block(x, blk, heads, ws, shift, precision)
            if "merge_w" in stage:
                x = torch.cat([x[:, 0::2, 0::2], x[:, 0::2, 1::2],
                               x[:, 1::2, 0::2], x[:, 1::2, 1::2]], -1)
                x = linear(x, stage["merge_w"], precision)
        x = layer_norm(x, w["norm_g"], w["norm_b"], EPS)
        x = x.flatten(1, 2).mean(1)
        return linear(x, w["head_w"], precision, w["head_b"])
