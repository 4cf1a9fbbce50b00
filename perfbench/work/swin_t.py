"""The work of Swin-T from the configuration's shapes, whatever computes
it: the operations and the least bytes of its projections and of its
window attention, in the configuration's dtype.

A projection (M, K) @ (K, N) does 2 M K N operations and moves at least
its input, its weight and its output once each; window attention does
4 t^2 hd operations a head a window of t tokens (q k^T and p v) and
moves at least q, k, v and its output. The least time of a piece of
work is the larger of its operations over the card's peak and its bytes
over the card's bandwidth (the port's ``launch/roofline.py::bound``,
copied).
"""
from __future__ import annotations

ITEM = 2        # bytes an element of bf16


def projections(cfg, batch):
    """Every projection of a forward of ``batch`` images: (M, K, N)."""
    p, res = cfg["patch_size"], cfg["img_size"] // cfg["patch_size"]
    c = cfg["embed_dim"]
    out = [(batch * res * res, p * p * cfg["in_chans"], c)]
    n = len(cfg["depths"])
    for si, depth in enumerate(cfg["depths"]):
        m, hid = batch * res * res, int(cfg["mlp_ratio"] * c)
        out += [(m, c, 3 * c), (m, c, c), (m, c, hid), (m, hid, c)] * depth
        if si < n - 1:
            res //= 2
            out.append((batch * res * res, 4 * c, 2 * c))
            c *= 2
    out.append((batch, c, cfg["num_classes"]))
    return out


def attentions(cfg, batch):
    """Every window attention of a forward: (windows, heads, t, hd)."""
    res = cfg["img_size"] // cfg["patch_size"]
    c = cfg["embed_dim"]
    out = []
    for depth, heads in zip(cfg["depths"], cfg["num_heads"]):
        ws = min(cfg["window_size"], res)
        out += [(batch * (res // ws) ** 2, heads, ws * ws, c // heads)] \
            * depth
        res //= 2
        c *= 2
    return out


def _least(flops, nbytes, peak, bw):
    return max(flops / peak, nbytes / bw)


def matmul_flops(unit, cfg):
    return sum(2 * m * k * n for m, k, n in projections(cfg, unit["batch"]))


def attention_flops(unit, cfg):
    return sum(4 * w * h * t * t * hd
               for w, h, t, hd in attentions(cfg, unit["batch"]))


def flops(unit, cfg) -> float:
    """The useful operations of a unit (a batch of images)."""
    return float(matmul_flops(unit, cfg) + attention_flops(unit, cfg))


def matmul_least_s(unit, cfg, peak, bw) -> float:
    return sum(_least(2 * m * k * n, ITEM * (m * k + k * n + m * n),
                      peak, bw)
               for m, k, n in projections(cfg, unit["batch"]))


def attention_least_s(unit, cfg, peak, bw) -> float:
    return sum(_least(4 * w * h * t * t * hd, ITEM * 4 * w * t * h * hd,
                      peak, bw)
               for w, h, t, hd in attentions(cfg, unit["batch"]))
