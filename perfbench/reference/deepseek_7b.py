"""Plain fp32 DeepSeek LLM 7B (arXiv:2401.02954; the llama decoder of
its ``config.json``), from the weights the harness makes.

Each layer: RMSNorm, the q, k and v projections, RoPE (the half-split
rotation, theta from the config) on q and k at positions 0..S-1, causal
softmax attention over all heads, the output projection and the
residual; RMSNorm, the SwiGLU MLP (silu(x W_gate) * (x W_up)) W_down and
the residual. Then the final RMSNorm and the untied head, at the rows
asked for alone. Layer by layer and, in attention, a block of query
rows at a time, so that it fits beside the port's bf16 weights; each
layer's weights are widened to fp32 as it runs.

``precision="fp8"`` is the control: every projection's operands
rounded to e4m3 (``common.linear``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import linear, no_tf32, rms_norm

Q_BLOCK = 512


def _shapes(cfg):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    v, n = cfg["vocab_size"], cfg["num_hidden_layers"]
    hd = d // cfg["num_attention_heads"]
    qo = cfg["num_attention_heads"] * hd
    kvo = cfg["num_key_value_heads"] * hd
    # name: (shape, kind, fan_in): "w" N(0, 1/fan_in), "e" N(0, 0.02^2),
    # "g" 1 + N(0, 0.1^2)
    return {
        "embed": ((v, d), "e", None),
        "attn_norm": ((n, d), "g", None),
        "wq": ((n, d, qo), "w", d), "wk": ((n, d, kvo), "w", d),
        "wv": ((n, d, kvo), "w", d), "wo": ((n, qo, d), "w", qo),
        "mlp_norm": ((n, d), "g", None),
        "w_gate": ((n, d, f), "w", d), "w_up": ((n, d, f), "w", d),
        "w_down": ((n, f, d), "w", f),
        "final_norm": ((d,), "g", None),
        "lm_head": ((d, v), "w", d),
    }


def make_weights(cfg, seed: int, device, dtype):
    """The weights from ``seed``, stacked over the layers: one tensor a
    kind of matrix, each drawn on ``device`` in one call in ``dtype``
    (the served type) and scaled in place."""
    from perfbench.harness import derive_seed
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "weights"))
    out = {}
    for name, (shape, kind, fan_in) in _shapes(cfg).items():
        t = torch.empty(shape, device=device, dtype=dtype)
        t.normal_(0.0, 1.0, generator=gen)
        if kind == "w":
            t.mul_(fan_in ** -0.5)
        elif kind == "e":
            t.mul_(0.02)
        else:
            t.mul_(0.1).add_(1.0)
        out[name] = t
    return out


def _rope(x, theta):
    """x (B, S, H, hd) fp32 rotated at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _causal(q, k, v):
    """Softmax attention, each query over the keys at or before it."""
    b, s, h, hd = q.shape
    group = h // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(group, 1)
    vh = v.transpose(1, 2).repeat_interleave(group, 1)
    out = torch.empty_like(qh)
    scale = hd ** -0.5
    for s0 in range(0, s, Q_BLOCK):
        s1 = min(s, s0 + Q_BLOCK)
        sc = (qh[:, :, s0:s1] @ kh[:, :, :s1].transpose(-1, -2)) * scale
        keep = (torch.arange(s0, s1, device=q.device)[:, None]
                >= torch.arange(s1, device=q.device)[None])
        sc = sc.masked_fill(~keep, float("-inf"))
        out[:, :, s0:s1] = sc.softmax(-1) @ vh[:, :, :s1]
    return out.transpose(1, 2).reshape(b, s, h * hd)


@torch.no_grad()
def logits(w, cfg, tokens, rows, precision: str = "fp32"):
    """tokens (B, S) -> fp32 logits (B, R, vocab) at positions ``rows``
    (B, R) of each sequence."""
    with no_tf32():
        b, s = tokens.shape
        h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg["hidden_size"] // h
        eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
        x = w["embed"][tokens].float()
        for i in range(cfg["num_hidden_layers"]):
            y = rms_norm(x, w["attn_norm"][i], eps)
            q = linear(y, w["wq"][i], precision).view(b, s, h, hd)
            k = linear(y, w["wk"][i], precision).view(b, s, hkv, hd)
            v = linear(y, w["wv"][i], precision).view(b, s, hkv, hd)
            o = _causal(_rope(q, theta), _rope(k, theta), v)
            x = x + linear(o, w["wo"][i], precision)
            y = rms_norm(x, w["mlp_norm"][i], eps)
            y = F.silu(linear(y, w["w_gate"][i], precision)) \
                * linear(y, w["w_up"][i], precision)
            x = x + linear(y, w["w_down"][i], precision)
        xr = torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))
        return linear(rms_norm(xr, w["final_norm"], eps), w["lm_head"],
                      precision)
