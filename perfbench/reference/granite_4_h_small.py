"""Plain fp32 IBM Granite 4.0-H Small (``granitemoehybrid``, its
``config.json``), from the weights the harness makes: this card's share
of an expert-parallel deployment, the held experts (``held_experts`` of
the router's ``router_experts``) in every layer.

Each layer (``layer_types``): h = RMSNorm(x); the mixer, Mamba2 or
attention; x = x + residual_multiplier * mixer(h); h = RMSNorm(x);
x = x + residual_multiplier * (experts(h) + shared(h)).

* Mamba2, one group: the in-projection's [z | x B C | dt]; the causal
  depthwise conv (width ``mamba_d_conv``, with bias) over [x B C], then
  SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD over
  chunks of ``mamba_chunk_size`` in the segment-sum form of the Mamba2
  paper (arXiv:2405.21060, Listing 1); y + D x; y * silu(z), RMS over
  all channels times the gain; the out-projection.
* Attention: q, k, v, no position embedding, causal softmax(q k^T *
  attention_multiplier) over the GQA heads, the out-projection.
* Experts: the router's fp32 logits over every expert, the top
  ``num_experts_per_tok`` of them and a softmax over those as the gates;
  each held expert's rows silu(h W_gate) * (h W_up) W_down, times the
  gate, summed per token; a pair routed to an expert held elsewhere adds
  nothing. The shared expert the same SwiGLU at its own width, ungated.

Then the final RMSNorm and the tied head, the logits over
``logits_scaling``, at the rows asked for alone; the embedding rows
times ``embedding_multiplier``. Layer by layer, the SSD one sequence at
a time and attention a block of query rows at a time, so that it fits
beside the port's bf16 weights; each layer's weights are widened to
fp32 as it runs.

``precision="fp8"`` is the control: every projection's operands (the
router's too) rounded to e4m3 (``common.linear``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import linear, no_tf32, rms_norm

Q_BLOCK = 256


def dims(cfg):
    """The shapes the reference and the adapter read."""
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    d_in = cfg["mamba_expand"] * d
    n = cfg["mamba_d_state"]
    types = cfg["layer_types"]
    return {
        "d": d, "h": h, "hkv": cfg["num_key_value_heads"], "hd": d // h,
        "d_in": d_in, "n": n, "mh": cfg["mamba_n_heads"],
        "mp": cfg["mamba_d_head"], "conv": d_in + 2 * n,
        "k_conv": cfg["mamba_d_conv"], "f": cfg["intermediate_size"],
        "fs": cfg["shared_intermediate_size"],
        "e": cfg["num_local_experts"], "router": cfg["router_experts"],
        "layers": len(types),
        "mamba": sum(t == "mamba" for t in types),
        "attn": sum(t == "attention" for t in types),
    }


def _shapes(cfg):
    """name: (shape, kind, fan_in). Kinds: "w" N(0, 1/fan_in), "e"
    N(0, 0.02^2), "g" 1 + N(0, 0.1^2), "c" N(0, 1/4) (the conv), and
    fp32 "alog" log U(1, 16), "dtb" the inverse softplus of a dt
    log-uniform in [0.001, 0.1], "one" 1."""
    s = dims(cfg)
    d, L, m, a = s["d"], s["layers"], s["mamba"], s["attn"]
    qo, kvo = s["h"] * s["hd"], s["hkv"] * s["hd"]
    proj = 2 * s["d_in"] + 2 * s["n"] + s["mh"]
    return {
        "embed": ((cfg["vocab_size"], d), "e", None),
        "input_norm": ((L, d), "g", None),
        "post_norm": ((L, d), "g", None),
        "m_in": ((m, d, proj), "w", d),
        "m_conv_w": ((m, s["k_conv"], s["conv"]), "c", None),
        "m_conv_b": ((m, s["conv"]), "c", None),
        "m_dt_bias": ((m, s["mh"]), "dtb", None),
        "m_A_log": ((m, s["mh"]), "alog", None),
        "m_D": ((m, s["mh"]), "one", None),
        "m_norm": ((m, s["d_in"]), "g", None),
        "m_out": ((m, s["d_in"], d), "w", s["d_in"]),
        "a_wq": ((a, d, qo), "w", d), "a_wk": ((a, d, kvo), "w", d),
        "a_wv": ((a, d, kvo), "w", d), "a_wo": ((a, qo, d), "w", qo),
        "router": ((L, d, s["router"]), "w", d),
        # [gate | up], as granite's ``input_linear`` chunks its output
        "e_in": ((L, s["e"], d, 2 * s["f"]), "w", d),
        "e_out": ((L, s["e"], s["f"], d), "w", s["f"]),
        "s_in": ((L, d, 2 * s["fs"]), "w", d),
        "s_out": ((L, s["fs"], d), "w", s["fs"]),
        "final_norm": ((d,), "g", None),
    }


def make_weights(cfg, seed: int, device, dtype):
    """The weights from ``seed``, stacked over the layers of their kind:
    one tensor a kind of matrix, each drawn on ``device`` in one call,
    in ``dtype`` (the served type) and scaled in place; A_log, dt_bias
    and D in fp32, as the port holds them."""
    from perfbench.harness import derive_seed
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "weights"))
    out = {}
    for name, (shape, kind, fan_in) in _shapes(cfg).items():
        dt = torch.float32 if kind in ("alog", "dtb", "one") else dtype
        t = torch.empty(shape, device=device, dtype=dt)
        if kind == "alog":
            t.uniform_(1.0, 16.0, generator=gen).log_()
        elif kind == "dtb":
            t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
            t.add_(torch.log(-torch.expm1(-t)))
        elif kind == "one":
            t.fill_(1.0)
        else:
            t.normal_(0.0, 1.0, generator=gen)
            if kind == "w":
                t.mul_(fan_in ** -0.5)
            elif kind == "e":
                t.mul_(0.02)
            elif kind == "c":
                t.mul_(0.5)
            else:
                t.mul_(0.1).add_(1.0)
        out[name] = t
    return out


def _segsum(a):
    """a (..., T) -> (..., T, T): sum of a over (j, i] at [i, j], j <= i;
    -inf above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd(x, dt, a, b, c, chunk: int, s0=None):
    """The chunked SSD of one sequence: x (S, H, P), dt (S, H), a (H,),
    b and c (S, N) (one group) -> y (S, H, P), the final state (H, P, N).
    The recurrence S_t = exp(dt_t a) S_{t-1} + dt_t x_t b_t^T,
    y_t = S_t c_t, in the Mamba2 paper's segment-sum form."""
    s, h, p = x.shape
    pad = (-s) % chunk
    # zero rows at the end: no decay (dt 0) and no input
    X = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    A = F.pad(dt * a, (0, 0, 0, pad))
    B = F.pad(b, (0, 0, 0, pad))
    C = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    X = X.view(nc, chunk, h, p)
    A = A.view(nc, chunk, h).permute(2, 0, 1)              # (h, c, l)
    B = B.view(nc, chunk, -1)
    C = C.view(nc, chunk, -1)
    a_cs = torch.cumsum(A, -1)
    # within each chunk
    L = torch.exp(_segsum(A))                              # (h, c, l, s)
    cb = torch.einsum("cln,csn->cls", C, B)
    y_diag = torch.einsum("hcls,cshp->clhp", L * cb[None], X)
    # each chunk's state, then the states passed between chunks
    decay = torch.exp(a_cs[..., -1:] - a_cs)               # (h, c, l)
    states = torch.einsum("cln,hcl,clhp->chpn", B, decay, X)
    if s0 is None:
        s0 = torch.zeros_like(states[0])
    states = torch.cat([s0[None], states])                 # (c + 1, ...)
    decay_chunk = torch.exp(_segsum(F.pad(a_cs[..., -1], (1, 0))))
    states = torch.einsum("hzc,chpn->zhpn", decay_chunk, states)
    states, final = states[:-1], states[-1]
    y_off = torch.einsum("cln,chpn,hcl->clhp", C, states, torch.exp(a_cs))
    return (y_diag + y_off).reshape(nc * chunk, h, p)[:s], final


def mamba(w, i, y, cfg, precision):
    """Mamba2 layer ``i`` (of the Mamba layers) over y (B, S, d)."""
    s = dims(cfg)
    bsz, sl, _ = y.shape
    d_in, n, mh, mp = s["d_in"], s["n"], s["mh"], s["mp"]
    zxbcdt = linear(y, w["m_in"][i], precision)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, mh], dim=-1)
    k = s["k_conv"]
    cw = w["m_conv_w"][i].float()                          # (K, conv)
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    conv = w["m_conv_b"][i].float() + sum(
        xp[:, j:j + sl] * cw[j] for j in range(k))
    xbc = F.silu(conv)
    xs, B, C = torch.split(xbc, [d_in, n, n], dim=-1)
    dt = F.softplus(dt + w["m_dt_bias"][i])
    a = -torch.exp(w["m_A_log"][i])
    out = torch.empty((bsz, sl, mh, mp), device=y.device)
    for r in range(bsz):
        out[r] = ssd(xs[r].view(sl, mh, mp), dt[r], a, B[r], C[r],
                     cfg["mamba_chunk_size"])[0]
    out = out + w["m_D"][i][:, None] * xs.view(bsz, sl, mh, mp)
    out = out.reshape(bsz, sl, d_in) * F.silu(z)
    out = rms_norm(out, w["m_norm"][i], cfg["rms_norm_eps"])
    return linear(out, w["m_out"][i], precision)


def attention(w, i, y, cfg, precision):
    """Attention layer ``i`` (of the attention layers) over y (B, S, d):
    causal, GQA, no positions, a block of query rows at a time."""
    s = dims(cfg)
    b, sl, _ = y.shape
    h, hkv, hd = s["h"], s["hkv"], s["hd"]
    q = linear(y, w["a_wq"][i], precision).view(b, sl, h, hd)
    k = linear(y, w["a_wk"][i], precision).view(b, sl, hkv, hd)
    v = linear(y, w["a_wv"][i], precision).view(b, sl, hkv, hd)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(h // hkv, 1)
    vh = v.transpose(1, 2).repeat_interleave(h // hkv, 1)
    out = torch.empty_like(qh)
    scale = cfg["attention_multiplier"]
    for s0 in range(0, sl, Q_BLOCK):
        s1 = min(sl, s0 + Q_BLOCK)
        sc = (qh[:, :, s0:s1] @ kh[:, :, :s1].transpose(-1, -2)) * scale
        keep = (torch.arange(s0, s1, device=y.device)[:, None]
                >= torch.arange(s1, device=y.device)[None])
        sc = sc.masked_fill(~keep, float("-inf"))
        out[:, :, s0:s1] = sc.softmax(-1) @ vh[:, :, :s1]
    out = out.transpose(1, 2).reshape(b, sl, h * hd)
    return linear(out, w["a_wo"][i], precision)


def swiglu(y, w_in, w_out, precision):
    g, u = linear(y, w_in, precision).chunk(2, dim=-1)
    return linear(F.silu(g) * u, w_out, precision)


def route(w, li, y, cfg, precision):
    """Layer ``li``'s routing of the rows y (T, d): (gates (T, k), experts
    (T, k)), granite's: the top-k logits, then a softmax over them."""
    logits = linear(y, w["router"][li], precision)
    top, idx = logits.topk(cfg["num_experts_per_tok"], dim=-1)
    return top.softmax(-1), idx


def experts(w, li, y, cfg, precision):
    """The held experts' part of layer ``li``'s MoE over y (B, S, d)."""
    d = y.shape[-1]
    yf = y.reshape(-1, d)
    gates, idx = route(w, li, yf, cfg, precision)
    first = cfg["held_experts"][0]
    out = torch.zeros_like(yf)
    for e in range(cfg["num_local_experts"]):
        tok, choice = (idx == first + e).nonzero(as_tuple=True)
        if tok.numel():
            h = swiglu(yf[tok], w["e_in"][li, e], w["e_out"][li, e],
                       precision)
            out.index_add_(0, tok, h * gates[tok, choice][:, None])
    return out.view_as(y)


@torch.no_grad()
def logits(w, cfg, tokens, rows, precision: str = "fp32"):
    """tokens (B, S) -> fp32 logits (B, R, vocab) at positions ``rows``
    (B, R) of each sequence."""
    with no_tf32():
        eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
        x = w["embed"][tokens].float() * cfg["embedding_multiplier"]
        im = ia = 0
        for li, kind in enumerate(cfg["layer_types"]):
            y = rms_norm(x, w["input_norm"][li], eps)
            if kind == "mamba":
                y = mamba(w, im, y, cfg, precision)
                im += 1
            else:
                y = attention(w, ia, y, cfg, precision)
                ia += 1
            x = x + rm * y
            y = rms_norm(x, w["post_norm"][li], eps)
            y = (experts(w, li, y, cfg, precision)
                 + swiglu(y, w["s_in"][li], w["s_out"][li], precision))
            x = x + rm * y
        xr = torch.gather(x, 1, rows[..., None].expand(-1, -1, x.shape[-1]))
        xr = rms_norm(xr, w["final_norm"], eps)
        return linear(xr, w["embed"].t(), precision) / cfg["logits_scaling"]
