"""The work of granite-4.0-h-small's share (its held experts) from the
configuration's shapes, whatever computes it, in the configuration's
dtype.

A prefill of B prompts of S tokens, at M = B S rows: every projection
at 2 M K N operations, input, weight and output moved once: each Mamba2
layer's in- and out-projection, each attention layer's q / k / v and
output projections, each layer's router (N = ``router_experts``) and
shared expert ([gate | up], then down); the held experts at their
expected rows, M top_k / router_experts each, so M top_k held /
router_experts rows in all (which rows reach an expert depends on the
data; the count is the expectation of uniform routing); causal
attention in the attention layers (4 hd operations a (query, key) pair
a head, S (S + 1) / 2 pairs); the SSD's linear recurrence at 4 H P N
operations a token a Mamba2 layer (the state's update and its read);
and the tied head at the last row alone (M = B). The count is the same
whatever implements the work. The least time of a piece of work is the
larger of its operations over the card's peak and its bytes over the
card's bandwidth (``work/deepseek_7b.py``'s rule).
"""
from __future__ import annotations

from perfbench.reference.granite_4_h_small import dims

ITEM = 2        # bytes an element of bf16


def _least(flops, nbytes, peak, bw):
    return max(flops / peak, nbytes / bw)


def _mm_flops(shapes):
    return sum(2 * m * k * n for m, k, n in shapes)


def _mm_least(shapes, peak, bw):
    return sum(_least(2 * m * k * n, ITEM * (m * k + k * n + m * n), peak, bw)
               for m, k, n in shapes)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def projections(cfg, m: float):
    """Every (M, K, N) product of a prefill at M rows but the router's
    and the head: the row-wise matmul's calls, each held expert one at
    its expected rows."""
    s = dims(cfg)
    d, hd = s["d"], s["hd"]
    rows = m * cfg["num_experts_per_tok"] / s["router"]
    mamba = [(m, d, 2 * s["d_in"] + 2 * s["n"] + s["mh"]),
             (m, s["d_in"], d)]
    attn = [(m, d, (s["h"] + 2 * s["hkv"]) * hd), (m, s["h"] * hd, d)]
    ffn = ([(rows, d, 2 * s["f"]), (rows, s["f"], d)] * s["e"]
           + [(m, d, 2 * s["fs"]), (m, s["fs"], d)])
    return (mamba * s["mamba"] + attn * s["attn"] + ffn * s["layers"])


def prefill_flops(cfg, b: int, sl: int) -> float:
    s = dims(cfg)
    m = b * sl
    router = s["layers"] * 2 * m * s["d"] * s["router"]
    attn = s["attn"] * 4 * b * s["h"] * s["hd"] * causal_pairs(sl)
    ssd = s["mamba"] * 4 * s["mh"] * s["mp"] * s["n"] * m
    head = 2 * b * s["d"] * cfg["vocab_size"]
    return float(_mm_flops(projections(cfg, m)) + router + attn + ssd
                 + head)


def flops(unit, cfg) -> float:
    """The useful operations of a prefill batch."""
    return prefill_flops(cfg, unit["batch"], unit["seq"])


def matmul_least_s(unit, cfg, peak, bw) -> float:
    """A prefill batch's row-wise matmul work (:func:`projections` and
    the head), at the least time."""
    b = unit["batch"]
    head = [(b, cfg["hidden_size"], cfg["vocab_size"])]
    return _mm_least(projections(cfg, b * unit["seq"]) + head, peak, bw)
