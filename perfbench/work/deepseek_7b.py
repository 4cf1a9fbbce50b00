"""The work of DeepSeek LLM 7B from the configuration's shapes, whatever
computes it, in the configuration's dtype.

A prefill of B prompts of S tokens: the q / k / v, output, gate / up
and down projections of every layer at M = B S (2 M K N operations;
input, weight and output moved once), causal attention (4 hd operations
a (query, key) pair a head, S (S + 1) / 2 pairs; q, k, v and the output
moved once) and the head at the last row alone (M = B). A decode step
of one request whose cache holds L tokens: the projections at M = 1,
the head, and attention over L + 1 keys. The least time of a piece of
work is the larger of its operations over the card's peak and its bytes
over the card's bandwidth (the port's ``launch/roofline.py::bound``,
copied). Bucket padding is not useful work and is not counted.
"""
from __future__ import annotations

ITEM = 2        # bytes an element of bf16


def _dims(cfg):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    return d, f, h, hkv, hd, cfg["vocab_size"], cfg["num_hidden_layers"]


def layer_projections(cfg, m):
    """One layer's projections at M rows: (M, K, N)."""
    d, f, h, hkv, hd, _v, _n = _dims(cfg)
    return [(m, d, (h + 2 * hkv) * hd), (m, h * hd, d), (m, d, 2 * f),
            (m, f, d)]


def _least(flops, nbytes, peak, bw):
    return max(flops / peak, nbytes / bw)


def _mm_flops(shapes):
    return sum(2 * m * k * n for m, k, n in shapes)


def _mm_least(shapes, peak, bw):
    return sum(_least(2 * m * k * n, ITEM * (m * k + k * n + m * n), peak, bw)
               for m, k, n in shapes)


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def prefill_flops(cfg, b: int, s: int) -> float:
    d, _f, h, _hkv, hd, v, n = _dims(cfg)
    proj = n * _mm_flops(layer_projections(cfg, b * s))
    attn = n * 4 * b * h * hd * causal_pairs(s)
    return float(proj + attn + 2 * b * d * v)


def decode_flops(cfg, kv_len: int) -> float:
    """One token of one request whose cache held ``kv_len`` tokens."""
    d, _f, h, _hkv, hd, v, n = _dims(cfg)
    proj = n * _mm_flops(layer_projections(cfg, 1))
    attn = n * 4 * h * hd * (kv_len + 1)
    return float(proj + attn + 2 * d * v)


def flops(unit, cfg) -> float:
    """The useful operations of a unit: a prefill batch, or a wave of
    requests (each prompt's prefill and every decode step after it)."""
    if unit["kind"] == "prefill":
        return prefill_flops(cfg, unit["batch"], unit["seq"])
    total = 0.0
    for plen, new in zip(unit["prompt_lens"], unit["new_tokens"]):
        total += prefill_flops(cfg, 1, plen)
        total += sum(decode_flops(cfg, plen + j) for j in range(new - 1))
    return total


def matmul_least_s(unit, cfg, peak, bw) -> float:
    """A prefill batch's projections and head, at the least time."""
    if unit["kind"] != "prefill":
        return 0.0
    d, _f, _h, _hkv, _hd, v, n = _dims(cfg)
    m = unit["batch"] * unit["seq"]
    return (n * _mm_least(layer_projections(cfg, m), peak, bw)
            + _mm_least([(unit["batch"], d, v)], peak, bw))


def attention_least_s(unit, cfg, peak, bw) -> float:
    """A prefill batch's causal attention, at the least time."""
    if unit["kind"] != "prefill":
        return 0.0
    _d, _f, h, hkv, hd, _v, n = _dims(cfg)
    b, s = unit["batch"], unit["seq"]
    ops = 4 * b * h * hd * causal_pairs(s)
    nbytes = ITEM * b * s * hd * (2 * h + 2 * hkv)
    return n * _least(ops, nbytes, peak, bw)
