"""The port's MoE FFN and the MoE LMs against the JAX package's, on CPU.

At the ``reduced()`` sizes of qwen2-moe-a2.7b (qwen2-moe-smoke: 6
experts top-2, one shared expert, RMSNorm) and phi3.5-moe-42b-a6.6b
(phi3.5-moe-smoke: 4 experts top-2, GQA 4:2, LayerNorm with beta), and
at the small configs of ``tests/test_moe.py`` (capacity drops, shared
experts, 60 experts padded to 64). Weights come from the JAX
initializer (norm gains jittered in numpy), inputs from a numpy seed;
both packages get the same arrays. Tolerances, each with its reason:

* the routing (``gate_idx``), ``_dispatch_indices`` (``slot``, ``keep``,
  ``token_idx``) and greedy streams: exactly equal;
* gate values, probabilities, the aux loss, the FFN and the models'
  logits and caches in fp32: rtol = atol = 2e-4, the JAX package's
  prefill/decode-vs-forward tolerance (only the order of fp32 sums
  differs);
* a weight-only int8 tree: its int8 leaves and scales bitwise, its
  logits (the tree dequantizes to the config's bf16) within 3e-2 x
  max(1, max|logit|), chip_smoke.py's bf16 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import manual_greedy

from repro.configs import phi35_moe, qwen2_moe
from repro.core import quant as jquant
from repro.core import runtime as jruntime
from repro.core.types import ModelConfig as JModelConfig
from repro.core.types import MoEConfig as JMoEConfig
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import quant, trace
from repro_torch.core.types import ModelConfig, MoEConfig
from repro_torch.models import lm, moe

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 3e-2
ARCHS = {"qwen2-moe-a2.7b": qwen2_moe, "phi3.5-moe-42b-a6.6b": phi35_moe}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _same(port, want):
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _cfgs(e=4, k=2, cf=8.0, n_shared=0):
    """``tests/test_moe.py``'s small config, in both packages."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=32, vocab=64, act="silu")
    mo = dict(n_experts=e, top_k=k, d_ff=32, capacity_factor=cf,
              n_shared=n_shared)
    return (JModelConfig(**kw, moe=JMoEConfig(**mo)),
            ModelConfig(**kw, moe=MoEConfig(**mo)))


def _ffn(jcfg, seed=0):
    """JAX initializer's FFN leaves (numpy) and both packages' trees."""
    params, _ = jmoe.init(jax.random.PRNGKey(seed), jcfg, stack=None,
                          dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            {k: _t(v) for k, v in tree.items()}, tree)


def jitter(tree, seed):
    rng = np.random.default_rng(seed)

    def jit(path, leaf):
        a = np.asarray(leaf)
        if path[-1].key in ("g", "b"):
            return a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(jit, tree)


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = ARCHS[arch].reduced()
        params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg,
                                dtype=jnp.float32)
        tree = jitter(jax.tree_util.tree_map(np.asarray, params), 1)
        _MODELS[arch] = (jcfg, get_reduced(arch),
                         jax.tree_util.tree_map(jnp.asarray, tree),
                         from_jax_params(tree, get_reduced(arch),
                                         device="cpu"), tree)
    return _MODELS[arch]


@pytest.fixture(scope="module", autouse=True)
def _drop_models():
    yield
    _MODELS.clear()


# ------------------------------ routing --------------------------------


@pytest.mark.parametrize("e,k", [(4, 2), (6, 2), (60, 4), (16, 2)])
def test_route_matches_jax(e, k):
    """Gate values, expert picks (exactly) and probabilities; 60 experts
    pad to 64 and no token reaches a pad."""
    jcfg, tcfg = _cfgs(e=e, k=k)
    e_pad = moe.padded_experts(tcfg)
    assert e_pad == jmoe.padded_experts(jcfg) == (64 if e == 60 else e)
    jp, tp, _ = _ffn(jcfg)
    x = np.random.default_rng(e).standard_normal((40, 16)).astype(np.float32)
    jv, ji, jpr = jmoe._route(jnp.asarray(x), jp["router"], jcfg, e_pad)
    tv, ti, tpr = moe._route(_t(x), tp["router"], tcfg, e_pad)
    _same(ti, ji)
    _close(tv, jv)
    _close(tpr, jpr)
    assert int(ti.max()) < e and not tpr[:, e:].any()


def test_route_breaks_exact_ties_as_jax():
    """Seeded exact ties: a router with a duplicated column gives two
    experts the same probability for every token, and a zero router
    gives all of them the same: ``lax.top_k`` picks the lower index,
    and so must the port."""
    jcfg, tcfg = _cfgs(e=6, k=2)
    rng = np.random.default_rng(7)
    router = rng.standard_normal((16, 6)).astype(np.float32)
    router[:, 3] = router[:, 1]
    x = rng.standard_normal((64, 16)).astype(np.float32)
    for w in (router, np.zeros_like(router)):
        jv, ji, jpr = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg, 6)
        tv, ti, tpr = moe._route(_t(x), _t(w), tcfg, 6)
        _same(ti, ji)
        _close(tv, jv)
        tied = tpr[:, 1] == tpr[:, 3]
        assert bool(tied.all())
        # a row that keeps one of the pair keeps expert 1, never 3
        one = (ti == 1).any(-1) ^ (ti == 3).any(-1)
        assert not (ti[one] == 3).any()
    assert ti[:, 0].tolist() == [0] * 64 and ti[:, 1].tolist() == [1] * 64


@pytest.mark.parametrize("t,k,e,cap", [(40, 2, 4, 100), (40, 2, 4, 7),
                                       (33, 4, 64, 3), (6, 1, 2, 1),
                                       (9, 2, 6, 2)])
def test_dispatch_indices_bitwise(t, k, e, cap):
    """``slot``, ``keep`` and ``token_idx`` exactly as JAX's: capacity
    assigned in token order, a dropped pair sent to the last row."""
    gate_idx = np.stack([np.random.default_rng(t * e + i).choice(
        e, k, replace=False) for i in range(t)]).astype(np.int32)
    js, jk, jt = jmoe._dispatch_indices(jnp.asarray(gate_idx), e, cap)
    ts, tk, tt = moe._dispatch_indices(torch.from_numpy(gate_idx), e, cap)
    _same(ts, js)
    _same(tk, jk)
    _same(tt, jt)
    if cap < t * k // e:
        assert not bool(tk.all()) and int(ts.max()) == e * cap


def test_aux_loss_matches_jax():
    """The load-balance loss on a balanced and a collapsed routing (the
    cases of ``tests/test_moe.py``) and on a router's own."""
    jcfg, tcfg = _cfgs(e=4, k=1)
    bal = np.tile(np.arange(4), 16)[:, None].astype(np.int32)
    col = np.zeros((64, 1), np.int32)
    p_bal = np.full((64, 4), 0.25, np.float32)
    p_col = np.full((64, 4), 0.01, np.float32)
    p_col[:, 0] = 0.97
    for idx, probs in ((bal, p_bal), (col, p_col)):
        want = jmoe._aux_loss(jnp.asarray(idx), jnp.asarray(probs), jcfg)
        _close(moe._aux_loss(torch.from_numpy(idx), _t(probs), tcfg), want)
    assert (moe._aux_loss(torch.from_numpy(bal), _t(p_bal), tcfg)
            < moe._aux_loss(torch.from_numpy(col), _t(p_col), tcfg))


# ------------------------------ the FFN --------------------------------


@pytest.mark.parametrize("case", ["dense", "drops", "shared", "padded"])
def test_apply_matches_jax(case):
    """``moe.apply`` against JAX's local path on ``tests/test_moe.py``'s
    cases: capacity never binding, capacity 1 (at most 2 of 6 tokens get
    output), a shared expert, 60 experts padded to 64. The output and
    the aux loss."""
    kw = {"dense": dict(cf=16.0), "drops": dict(e=2, k=1, cf=1e-6),
          "shared": dict(n_shared=1, cf=16.0), "padded": dict(e=60, k=4)}
    jcfg, tcfg = _cfgs(**kw[case])
    jp, tp, _ = _ffn(jcfg)
    if case == "shared":         # a live gate (zero at init)
        g = np.random.default_rng(2).standard_normal((16, 1)) * 0.5
        jp["shared_gate"] = jnp.asarray(g, jnp.float32)
        tp["shared_gate"] = _t(g)
    x = np.random.default_rng(1).standard_normal((2, 6, 16)).astype(
        np.float32)
    want, jaux = jmoe.apply(jp, jnp.asarray(x), cfg=jcfg)
    got, aux = moe.apply(tp, _t(x), cfg=tcfg)
    _close(got, want)
    _close(aux, jaux)
    if case == "drops":
        assert int((got.abs() > 1e-9).any(-1).sum()) <= 2


def test_apply_bf16_matches_jax():
    """A bf16 block input (the experts' einsums in fp32 either way): the
    output in bf16 within the bf16 tolerance."""
    jcfg, tcfg = _cfgs(e=6, k=2, n_shared=1)
    jp, tp, tree = _ffn(jcfg, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 9, 16)).astype(
        np.float32)
    want, _ = jmoe.apply({k: v.astype(jnp.bfloat16) for k, v in jp.items()},
                         jnp.asarray(x).astype(jnp.bfloat16), cfg=jcfg)
    got, _ = moe.apply({k: v.to(torch.bfloat16) for k, v in tp.items()},
                       _t(x).to(torch.bfloat16), cfg=tcfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err


def test_quantized_expert_tree():
    """A weight-only int8 qwen2-moe-smoke tree: ``quantize_tree`` with
    ``lm_weight_predicate`` turns the stacked (R, E, d, f) expert leaves
    into ``{"q", "s"}`` with JAX's bits and scales (the router and the
    shared experts stay float); ``lm.forward`` dequantizes them in
    ``moe.apply`` and its logits and aux loss hold against JAX's."""
    jcfg, tcfg = qwen2_moe.reduced(), get_reduced("qwen2-moe-a2.7b")
    params, _ = jlm.init_lm(jax.random.PRNGKey(6), jcfg, dtype=jnp.float32)
    jq = jquant.quantize_tree(params, jquant.lm_weight_predicate)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg,
                         device="cpu")
    tq = quant.quantize_tree(tp, quant.lm_weight_predicate)
    ffn = tq["stages"][0]["stacked"]["0"]["ffn"]
    assert quant.is_quantized(ffn["wi"]) and ffn["wi"]["q"].dim() == 4
    assert not quant.is_quantized(ffn["router"])
    assert not quant.is_quantized(ffn["shared_wi"])
    for t, j in zip(_leaves(tq), jax.tree_util.tree_leaves(jq)):
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        _same(t, j)
    toks = _tokens(6, (1, 8))
    with jruntime.use_impl("ref"):
        want, jaux = jlm.forward(jq, jnp.asarray(toks), jcfg, remat=False)
    got, aux = lm.forward(tq, torch.from_numpy(toks).long(), tcfg)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err
    assert torch.isfinite(got).all()
    _close(aux, jaux, dict(rtol=2e-3, atol=2e-5))


# ------------------------------ the LMs --------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_prefill_decode_match_jax(arch, trace_on):
    """Forward (logits and the aux loss), then prefill at S = 13 into a
    cache of 16 and three decode steps: logits and every KV leaf. CPU
    tensors launch no kernel."""
    jcfg, tcfg, jparams, tparams, _ = _model(arch)
    toks = _tokens(9, (2, 16))
    before = trace.launches()
    with jruntime.use_impl("ref"):
        want, jaux = jlm.forward(jparams, jnp.asarray(toks), jcfg,
                                 remat=False)
    got, aux = lm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    _close(got, want)
    assert aux.dtype == torch.float32 and float(aux) > 0
    _close(aux, jaux)
    with jruntime.use_impl("ref"):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :13]), jcfg,
                                  alloc=16)
    tlg, tcache = lm.prefill(tparams, torch.from_numpy(toks[:, :13]).long(),
                             tcfg, alloc=16)
    _close(tlg, jlg)
    jlen = jnp.full((2,), 13, jnp.int32)
    tlen = torch.full((2,), 13, dtype=torch.int32)
    for t in range(13, 16):
        with jruntime.use_impl("ref"):
            jlg, jcache = jlm.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t:t + 1]),
                                          jlen, jcfg)
        tlg, tcache = lm.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, t:t + 1]).long(),
            tlen, tcfg)
        _close(tlg, jlg)
        for tleaf, jleaf in zip(_leaves(tcache),
                                jax.tree_util.tree_leaves(jcache)):
            _close(tleaf, jleaf)
        jlen, tlen = jlen + 1, tlen + 1
    assert trace.launches() == before


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_matches_manual_greedy(arch):
    jcfg, tcfg, jparams, tparams, _ = _model(arch)
    for seed, s in ((11, 9), (12, 17)):
        prompt = _tokens(seed, (s,))
        with jruntime.use_impl("ref"):
            want = manual_greedy(jparams, jcfg, jnp.asarray(prompt), 6,
                                 s + 6)
        got = lm.greedy(tparams, torch.from_numpy(prompt).long()[None],
                        tcfg, 6)
        assert got[0].tolist() == want


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_tree_and_checks_match_jax(arch):
    """init_lm builds the JAX package's tree (keys, shapes, dtypes: the
    experts padded, the shared experts where the config has them);
    from_jax_params refuses a tree of another expert count, expert width
    or shared-expert count, naming the block and the leaf."""
    jcfg, cfg = ARCHS[arch].reduced(), get_reduced(arch)
    jtree, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    ttree = lm.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
    tree = jax.tree_util.tree_map(np.asarray, jtree)
    from_jax_params(tree, cfg, device="cpu")
    mo = cfg.moe
    bad = [({"moe": dataclasses.replace(mo, n_experts=mo.n_experts + 1)},
            "stage 0 block 0: moe router"),
           ({"moe": dataclasses.replace(mo, d_ff=mo.d_ff * 2)},
            "stage 0 block 0: moe wi"),
           ({"moe": dataclasses.replace(mo, n_shared=mo.n_shared + 1)},
            "moe shared_wi" if mo.n_shared else "no 'shared_wi' leaf")]
    for change, match in bad:
        with pytest.raises(ValueError, match=match):
            from_jax_params(tree, dataclasses.replace(cfg, **change),
                            device="cpu")


def test_configs_match_jax():
    for arch, mod in ARCHS.items():
        for mine, theirs in ((get_config(arch), mod.CONFIG),
                             (get_reduced(arch), mod.reduced())):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.param_counts() == theirs.param_counts()
            assert [dataclasses.asdict(s) for s in mine.stages()] == [
                dataclasses.asdict(s) for s in theirs.stages()]
    assert moe.padded_experts(get_config("qwen2-moe-a2.7b")) == 64
    assert moe.padded_experts(get_config("phi3.5-moe-42b-a6.6b")) == 16
