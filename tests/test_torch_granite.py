"""granite-4.0-h-small on the port at ``reduced()`` size, on the CPU,
against the benchmark's plain fp32 reference
(``perfbench/reference/granite_4_h_small.py``, no kernel, no cache):
prefill logits, prefill then decode through the cache, the dropless
expert layer cut into shares, its routing against granite's, skewed
routing, the experts' grouped launches against a call a group, the
folded scalars, the norm eps, and the reference's chunked SSD against a
per-step scan.

The weights are the reference's (``make_weights``, seeded); the port's
tree is the benchmark adapter's (``perfbench/port/granite_hybrid.py``),
which folds the scalars into the weights it is given, so each side
draws its own copy. Tolerances, each with its reason:

* 2e-5 relative (fp32, the whole model): the same maths in another
  order (the port's SSD chunk loop against the segment-sum form, fused
  [gate | up] panels, the experts' rows summed in another order, the
  folded scalars); a lost term or a wrong fold is of order 1e-1;
* 1e-5 (fp32, one layer or the scan): the same, over one layer;
* 0 (routing): the same picks, index for index.
"""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.port import granite_hybrid as adapter  # noqa: E402
from perfbench.reference import granite_4_h_small as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.types import jax_fields  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rowwise_matmul as rm  # noqa: E402
from repro_torch.models import lm, mamba2, moe  # noqa: E402

ARCH = "granite-4.0-h-small"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
WHOLE = 2e-5
LAYER = 1e-5


def ref_config(cfg, held=None):
    """The reference's (``config.json``'s) keys of a port config."""
    mo, s = cfg.moe, cfg.ssm
    first, stop = held or mo.held_range
    kinds = {"M": "mamba", "A": "attention"}
    period = [kinds[c] for c in cfg.layer_pattern]
    return {
        "name": cfg.name, "model": "granite_hybrid", "dtype": "float32",
        "hidden_size": cfg.d_model, "vocab_size": cfg.vocab,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": mo.d_ff,
        "shared_intermediate_size": mo.shared_width,
        "num_local_experts": stop - first, "held_experts": [first, stop],
        "router_experts": mo.n_experts, "num_experts_per_tok": mo.top_k,
        "layer_types": period * (cfg.n_layers // len(period)),
        "mamba_expand": s.expand, "mamba_d_state": s.d_state,
        "mamba_n_heads": s.expand * cfg.d_model // s.head_dim,
        "mamba_d_head": s.head_dim, "mamba_d_conv": s.d_conv,
        "mamba_chunk_size": s.chunk, "mamba_n_groups": 1,
        "mamba_conv_bias": True, "mamba_proj_bias": False,
        "attention_bias": False, "hidden_act": "silu",
        "normalization_function": "rmsnorm",
        "position_embedding_type": "nope", "tie_word_embeddings": True,
        "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "logits_scaling": cfg.logits_scaling,
    }


def weights(rcfg, dtype=torch.float32):
    return ref.make_weights(rcfg, SEED, CPU, dtype)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def tokens(rcfg, b, s, seed=1):
    return torch.randint(0, rcfg["vocab_size"], (b, s),
                         generator=torch.Generator().manual_seed(seed))


def test_config_registered_and_port_only():
    cfg = configs.get_config(ARCH)
    assert ARCH not in configs.ARCHS and ARCH in configs.PORT_ONLY
    assert configs.get_reduced(ARCH).layer_pattern == "MMAM"
    st = cfg.stages()
    assert len(st) == 1 and st[0].repeat == 4
    assert "".join("A" if b.mixer == "attn" else "M"
                   for b in st[0].body) == "MMMMMAMMMM"
    assert all(b.ffn == "moe" and not b.shared for b in st[0].body)
    # the benchmark's configuration file is this config with its cut
    file = adapter.port_config(json.loads(
        (ROOT / "perfbench/configs/granite_4_h_small.json").read_text()))
    held = dataclasses.replace(cfg.moe, held=(0, 36))
    assert dataclasses.replace(file, name=cfg.name) == \
        dataclasses.replace(cfg, moe=held)


def test_port_fields_stay_in_the_jax_view():
    cfg = configs.get_config(ARCH)
    view = jax_fields(cfg)
    assert view["norm_eps"] == 1e-5 and view["moe"]["dropless"] is True
    assert "held" not in view["moe"]
    plain = configs.get_config("deepseek-7b")
    assert "norm_eps" not in jax_fields(plain)


def test_adapter_config_round_trip():
    cfg = configs.get_reduced(ARCH)
    assert adapter.port_config(ref_config(cfg)) == dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, held=(0, cfg.moe.n_experts)),
        dtype="float32")


@pytest.mark.parametrize("held", [None, (0, 4)])
def test_prefill_logits_match_the_reference(held):
    rcfg = ref_config(configs.get_reduced(ARCH), held)
    system = adapter.build(rcfg, weights(rcfg), CPU)
    toks = tokens(rcfg, 2, 37)
    got = system.prefill(toks)
    want = ref.logits(weights(rcfg), rcfg, toks,
                      torch.full((2, 1), 36))[:, 0]
    assert rel(got, want) < WHOLE


def test_prefill_then_decode_through_the_cache():
    """Prefill 21 tokens, then 4 ``lm.decode_step`` steps from the
    cache (the 6 Mamba states, the 2 attention layers' KV), each step's
    logits against the reference's full forward of the same tokens."""
    rcfg = ref_config(configs.get_reduced(ARCH))
    system = adapter.build(rcfg, weights(rcfg), CPU)
    cfg, params = system.cfg, system.params
    toks = tokens(rcfg, 2, 25)
    logits, cache = lm.prefill(params, toks[:, :21], cfg, alloc=25)
    kinds = [sorted(c) for c in cache[0].values()]
    assert kinds.count(["mamba"]) == 3 and kinds.count(["kv"]) == 1
    got = [logits]
    for j in range(21, 25 - 1):
        lengths = torch.full((2,), j, dtype=torch.int32)
        logits, cache = lm.decode_step(params, cache, toks[:, j:j + 1],
                                       lengths, cfg)
        got.append(logits)
    rows = torch.arange(20, 24)[None].expand(2, 4)
    want = ref.logits(weights(rcfg), rcfg, toks, rows)
    for i, g in enumerate(got):
        assert rel(g, want[:, i]) < WHOLE, i


def test_bf16_prefill_stays_near_the_reference():
    """The served dtype: bf16 weights and activations against the fp32
    reference of the same bf16 weights, within 0.05 (bf16's 8 bits of
    mantissa through 8 layers, about 0.02 here; the fp8 control, one
    precision lower, reads about 0.2)."""
    rcfg = {**ref_config(configs.get_reduced(ARCH)), "dtype": "bfloat16"}
    system = adapter.build(rcfg, weights(rcfg, torch.bfloat16), CPU)
    toks = tokens(rcfg, 2, 37)
    got = system.prefill(toks)
    w = weights(rcfg, torch.bfloat16)
    rows = torch.full((2, 1), 36)
    want = ref.logits(w, rcfg, toks, rows)[:, 0]
    assert rel(got, want) < 0.05
    control = ref.logits(w, rcfg, toks, rows, "fp8")[:, 0]
    assert rel(control, want) > 0.1


def _layer_params(w, li, lo=None, hi=None, shared=True):
    p = {"router": w["router"][li], "wgi": w["e_in"][li, lo:hi],
         "wo": w["e_out"][li, lo:hi]}
    if shared:
        p.update(shared_wgi=w["s_in"][li], shared_wo=w["s_out"][li])
    return p


@pytest.mark.parametrize("shares", [2, 4])
def test_shares_add_up_to_the_uncut_layer(shares):
    """Each share holds E / shares experts and computes their part; the
    shares' parts plus the shared expert once equal the uncut reference
    layer (every expert, the shared expert)."""
    cfg = configs.get_reduced(ARCH)
    rcfg = ref_config(cfg)
    w = weights(rcfg)
    e = cfg.moe.n_experts
    x = torch.randn(2, 13, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    total = ref.swiglu(x, w["s_in"][1], w["s_out"][1], "fp32")
    step = e // shares
    for i in range(shares):
        lo, hi = i * step, (i + 1) * step
        mo = dataclasses.replace(cfg.moe, held=(lo, hi), n_shared=0)
        part, _aux = moe.apply(_layer_params(w, 1, lo, hi, shared=False), x,
                               cfg=dataclasses.replace(cfg, moe=mo))
        total = total + part
    want = (ref.experts(w, 1, x, rcfg, "fp32")
            + ref.swiglu(x, w["s_in"][1], w["s_out"][1], "fp32"))
    assert rel(total, want) < LAYER
    whole, _aux = moe.apply(_layer_params(w, 1), x, cfg=cfg)
    assert rel(whole, want) < LAYER


def test_routing_is_granites():
    """The port's softmax -> top-k -> renormalise picks granite's top-k
    of the logits then a softmax over those k, index for index (the
    softmax is monotone; renormalising restricts it to the k)."""
    cfg = configs.get_reduced(ARCH)
    rcfg = ref_config(cfg)
    w = weights(rcfg)
    x = torch.randn(400, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    gates, idx, _probs = moe._route(x, w["router"][2], cfg,
                                    cfg.moe.n_experts)
    want_gates, want_idx = ref.route(w, 2, x, rcfg, "fp32")
    assert torch.equal(idx, want_idx)
    assert torch.allclose(gates, want_gates, atol=1e-6, rtol=0)


def test_dropless_computes_every_row_under_skew():
    """A router biased to one expert sends every token there: the
    capacity path would drop most of its rows; the dropless layer
    computes each of them, as the reference does, and counts them."""
    cfg = configs.get_reduced(ARCH)
    rcfg = ref_config(cfg)
    w = weights(rcfg)
    # rows of positive mean and a router column of ones: expert 5's
    # logit leads every token's by about d_model
    w["router"][0][:, 5] += 1.0
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5)) + 1.0
    t, k = 32, cfg.moe.top_k
    gates, idx, _p = moe._route(x.reshape(t, -1), w["router"][0], cfg,
                                cfg.moe.n_experts)
    assert bool((idx == 5).any(-1).all())
    cap = max(int(t * k / cfg.moe.n_experts * cfg.moe.capacity_factor), k)
    assert cap < t
    with trace.recording():
        trace.take()
        got, _aux = moe.apply(_layer_params(w, 0), x, cfg=cfg)
        _spans, counters = trace.take()
    want = (ref.experts(w, 0, x, rcfg, "fp32")
            + ref.swiglu(x, w["s_in"][0], w["s_out"][0], "fp32"))
    assert rel(got, want) < LAYER
    used = len(torch.unique(idx))
    assert counters["moe.rows_routed"] == t * k
    assert counters["moe.rows_held"] == t * k
    assert counters["moe.expert_calls"] == 2 * used
    # half the experts held: the rows of the other half are not computed
    mo = dataclasses.replace(cfg.moe, held=(0, 4))
    with trace.recording():
        trace.take()
        moe.apply(_layer_params(w, 0, 0, 4), x,
                  cfg=dataclasses.replace(cfg, moe=mo))
        _spans, counters = trace.take()
    assert counters["moe.rows_held"] == int((idx < 4).sum())


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_matmul_groups_match_a_call_a_group(gated, device):
    """``rowwise_matmul_groups_p`` against ``rowwise_matmul_p`` on each
    group's rows: the same numbers, bitwise (the same kernels on the
    card), and the same records, one a non-empty group. The sizes take
    both of the card's designs for few rows and the persistent one."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device(device)
    dt = torch.bfloat16 if device == "cuda" else torch.float32
    sizes = [0, 1, 7, 70, 0, 130]
    k, f = 64, 48
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(sum(sizes), k, generator=gen).to(dev, dt)
    w = (torch.randn(len(sizes), k, 2 * f if gated else f, generator=gen)
         / 8).to(dev, dt)
    act = "silu" if gated else None
    with trace.recording() as got_recs:
        got = rm.rowwise_matmul_groups_p(x, w, sizes, gated=gated,
                                         activation=act)
    want = torch.empty_like(got)
    with trace.recording() as want_recs:
        start = 0
        for g, m in enumerate(sizes):
            if m:
                wg = w[g]
                want[start:start + m] = rm.rowwise_matmul_p(
                    x[start:start + m], wg[:, f:] if gated else wg,
                    w_gate=wg[:, :f] if gated else None, activation=act)
            start += m
    assert torch.equal(got, want)
    assert got_recs == want_recs
    assert len(got_recs) == sum(1 for m in sizes if m)


def test_folded_scalars_against_the_published_ones():
    """``fold_multipliers`` scales exactly the leaves the published
    scalars act on: each out-projection by the residual multiplier, the
    q columns by attention_multiplier / head_dim ** -0.5, the final gain
    by 1 / logits_scaling; a config whose scalars are 1 folds nothing."""
    cfg = configs.get_reduced(ARCH)
    rcfg = ref_config(cfg)
    w = weights(rcfg)
    tree = lm.fuse_params(cfg, adapter.seed_tree(cfg, w))
    before = copy.deepcopy(tree)
    lm.fold_multipliers(cfg, tree)
    rm, qo = cfg.residual_multiplier, cfg.n_heads * cfg.head_dim
    qs = cfg.attention_multiplier * cfg.head_dim ** 0.5
    for key, blk in tree["stages"][0]["stacked"].items():
        old = before["stages"][0]["stacked"][key]
        mixer = "attn" if "attn" in blk else "mamba"
        out = "wo" if mixer == "attn" else "out_proj"
        assert torch.equal(blk[mixer][out], old[mixer][out] * rm)
        for leaf in ("wo", "shared_wo"):
            assert torch.equal(blk["ffn"][leaf], old["ffn"][leaf] * rm)
        for leaf in ("wgi", "shared_wgi", "router"):
            assert torch.equal(blk["ffn"][leaf], old["ffn"][leaf])
        if mixer == "attn":
            wqkv, old_qkv = blk["attn"]["wqkv"], old["attn"]["wqkv"]
            assert torch.equal(wqkv[..., :qo], old_qkv[..., :qo] * qs)
            assert torch.equal(wqkv[..., qo:], old_qkv[..., qo:])
        else:
            assert torch.equal(blk["mamba"]["in_proj"],
                               old["mamba"]["in_proj"])
    assert torch.equal(tree["final_norm"]["g"],
                       before["final_norm"]["g"] / cfg.logits_scaling)
    assert torch.equal(tree["embed"], before["embed"])
    plain = dataclasses.replace(cfg, residual_multiplier=1.0,
                                attention_multiplier=0.0,
                                logits_scaling=1.0)
    again = copy.deepcopy(before)
    lm.fold_multipliers(plain, again)
    for a, b in zip(_leaves(again), _leaves(before)):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_norm_eps_reaches_every_norm(monkeypatch):
    """The config's eps (granite's 1e-5) reaches every standalone norm
    and the fused norm prologue; deepseek-7b's stays 1e-6."""
    seen = []
    real_ln, real_mm = ops.layernorm, ops.matmul

    def layernorm(x, gamma, beta=None, *, eps=1e-6, **kw):
        seen.append(eps)
        return real_ln(x, gamma, beta, eps=eps, **kw)

    def matmul(x, w, *, norm=None, **kw):
        if norm is not None:
            seen.append(norm.eps)
        return real_mm(x, w, norm=norm, **kw)

    monkeypatch.setattr(ops, "layernorm", layernorm)
    monkeypatch.setattr(ops, "matmul", matmul)
    rcfg = ref_config(configs.get_reduced(ARCH))
    system = adapter.build(rcfg, weights(rcfg), CPU)
    system.prefill(tokens(rcfg, 1, 9))
    # per Mamba layer: pre-norm, post-norm, the gated norm; per attention
    # layer: the two pre-norms; the final norm
    assert len(seen) == 6 * 3 + 2 * 2 + 1
    assert set(seen) == {1e-5}
    seen.clear()
    dcfg = configs.get_reduced("deepseek-7b")
    params = lm.init_lm(dcfg, torch.Generator().manual_seed(0), device=CPU,
                        dtype=torch.float32)
    lm.prefill(params, tokens({"vocab_size": dcfg.vocab}, 1, 9), dcfg)
    assert seen and set(seen) == {1e-6}


@pytest.mark.parametrize("sl,chunk", [(37, 8), (16, 16), (1, 4)])
def test_reference_ssd_against_a_per_step_scan(sl, chunk):
    """The reference's segment-sum SSD (and the port's chunk loop) against
    the recurrence one step at a time, from a starting state."""
    g = torch.Generator().manual_seed(sl)
    h, p, n = 3, 4, 5
    x = torch.randn(sl, h, p, generator=g)
    dt = F.softplus(torch.randn(sl, h, generator=g) - 1)
    a = -torch.rand(h, generator=g) * 4 - 0.5
    b, c = torch.randn(sl, n, generator=g), torch.randn(sl, n, generator=g)
    s0 = torch.randn(h, p, n, generator=g)
    state, ys = s0.clone(), []
    for t in range(sl):
        state = (torch.exp(dt[t] * a)[:, None, None] * state
                 + dt[t][:, None, None] * x[t][:, :, None] * b[t])
        ys.append(state @ c[t])
    want = torch.stack(ys)
    got, final = ref.ssd(x, dt, a, b, c, chunk, s0)
    assert rel(got, want) < LAYER and rel(final, state) < LAYER
    port, pfinal = mamba2.ssd_chunked(x[None], dt[None], a, b[None],
                                      c[None], chunk=chunk, s0=s0[None])
    assert rel(port[0], want) < LAYER and rel(pfinal[0], state) < LAYER
