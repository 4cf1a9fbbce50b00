"""The port's RWKV6 language model against the JAX package's, on CPU.

At ``reduced()`` size (2 layers, d 64, head dim 16, vocab 256). Weights
come from the JAX initializer with their vector leaves jittered in
numpy (the decay LoRA and the ``w0`` spread among them, so some channels
clamp at -3.5 and some at -1e-6), inputs from a numpy seed; both
packages get the same arrays. Tolerances, each with its reason:

* WKV against the Pallas kernel (interpret mode), the JAX oracle and
  JAX's chunked scan with a starting state: rtol = atol = 3e-4, the JAX
  package's own kernel tolerance (exp(+-cs) factors up to e^56 make the
  chunked and per-step forms differ in the last bits);
* time-mix, channel-mix, prefill and decode logits and caches:
  rtol = atol = 2e-4, the JAX package's prefill/decode-vs-forward
  tolerance (only the order of fp32 sums differs);
* greedy streams: exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import manual_greedy

from repro.configs import rwkv6_3b as jconfigs
from repro.core import runtime as jruntime
from repro.kernels.wkv import wkv_p as jwkv_p
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import PENDING, get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import runtime, trace
from repro_torch.kernels import ops
from repro_torch.kernels.wkv import wkv_p
from repro_torch.models import lm, mlp, rope, rwkv6

WKV_TOL = dict(rtol=3e-4, atol=3e-4)
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _counts():
    return (trace.launches("rowwise_matmul"), trace.launches("layernorm"),
            trace.launches("wkv"))


def jitter(tree, seed):
    """Spread the initializer's constant leaves (numpy, in place of a
    copy): the decay LoRA ``w_lora_b`` and the token-shift mixes, norm
    gains and biases, ``u``, and ``w0`` over [-16, 2] so that
    -exp(w0 + lora) reaches both clamp ends (-3.5 and -1e-6)."""
    rng = np.random.default_rng(seed)

    def jit(path, leaf):
        a = np.asarray(leaf)
        name = path[-1].key

        def noise(scale):
            return (scale * rng.standard_normal(a.shape)).astype(a.dtype)

        if name == "w0":
            return rng.uniform(-16.0, 2.0, a.shape).astype(a.dtype)
        if name in ("mu", "mu_k", "mu_r"):
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        if name in ("w_lora_b", "b", "ln_b"):
            return a + noise(0.1)
        if name in ("g", "ln_g"):
            return a + noise(0.1)
        if name == "u":
            return a + noise(0.5)
        return a
    return jax.tree_util.tree_map_with_path(jit, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.reduced()
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tree = jitter(jax.tree_util.tree_map(np.asarray, params), 1)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = from_jax_params(tree, get_reduced("rwkv6-3b"), device="cpu")
    return jcfg, get_reduced("rwkv6-3b"), jparams, tparams


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ------------------------------- WKV ----------------------------------


def _wkv_inputs(seed, b, s, h, p):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    lw = np.clip(-np.exp(rng.standard_normal((b, s, h, p))),
                 -rwkv6.CLAMP, -1e-6).astype(np.float32)
    u = rng.standard_normal((h, p)).astype(np.float32)
    return r, k, v, lw, u


@pytest.mark.parametrize("b,s,h,p", [(2, 45, 3, 16), (1, 16, 1, 8),
                                     (2, 64, 2, 32), (1, 7, 2, 16)])
def test_wkv_plain_versions_match_jax(b, s, h, p):
    args = _wkv_inputs(b * 100 + s, b, s, h, p)
    jy, js = jwkv_p(*map(jnp.asarray, args), interpret=True)
    ry, rs = jrwkv6.wkv_ref(*map(jnp.asarray, args))
    ty, ts = rwkv6.wkv_chunked(*map(_t, args))
    _close(ty, jy, WKV_TOL)
    _close(ts, js, WKV_TOL)
    ty, ts = rwkv6.wkv_ref(*map(_t, args))
    _close(ty, ry, WKV_TOL)
    _close(ts, rs, WKV_TOL)


@pytest.mark.parametrize("s", [1, 20, 45])
def test_wkv_with_state_matches_jax(s):
    """A starting state s0 (the decode step's, with S=1): the chunked
    scan against JAX's ``wkv_chunked(s0=...)``."""
    b, h, p = 2, 3, 16
    args = _wkv_inputs(7 + s, b, s, h, p)
    s0 = np.random.default_rng(8).standard_normal((b, h, p, p)).astype(
        np.float32)
    jy, js = jrwkv6.wkv_chunked(*map(jnp.asarray, args), s0=jnp.asarray(s0))
    ty, ts = rwkv6.wkv_chunked(*map(_t, args), s0=_t(s0))
    _close(ty, jy, WKV_TOL)
    _close(ts, js, WKV_TOL)
    # the per-step oracle agrees too
    ry, rs = rwkv6.wkv_ref(*map(_t, args), s0=_t(s0))
    _close(ty, ry.numpy(), WKV_TOL)
    _close(ts, rs.numpy(), WKV_TOL)


def test_wkv_wrappers_take_the_plain_version_on_cpu(trace_on):
    """On CPU tensors ``wkv_p`` runs the chunked scan in fp32 and returns
    y in the input dtype (as the kernel does), launching nothing;
    ``ops.wkv`` is the chunked scan under either impl."""
    r, k, v, lw, u = map(_t, _wkv_inputs(3, 2, 21, 2, 16))
    s0 = _t(np.random.default_rng(4).standard_normal((2, 2, 16, 16)))
    before = _counts()
    want_y, want_s = rwkv6.wkv_chunked(r, k, v, lw, u, s0=s0)
    y, s = wkv_p(r, k, v, lw, u, s0=s0)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    for impl in ("auto", "ref"):
        with runtime.use_impl(impl):
            y, s = ops.wkv(r, k, v, lw, u, s0=s0)
        torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    bf = [t.to(torch.bfloat16) for t in (r, k, v, lw)]
    y16, s16 = wkv_p(*bf, u)
    want16, want_s16 = rwkv6.wkv_chunked(*(t.float() for t in bf), u)
    assert y16.dtype == torch.bfloat16 and s16.dtype == torch.float32
    torch.testing.assert_close(y16, want16.to(torch.bfloat16), rtol=0,
                               atol=0)
    torch.testing.assert_close(s16, want_s16, rtol=0, atol=0)
    assert _counts() == before


# --------------------------- time / channel mix ------------------------


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["prefill", "state"])
def test_time_mix_matches_jax(model, with_state):
    jcfg, tcfg, jparams, tparams = model
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stages"][0][
        "stacked"]["0"]["tmix"])
    tp = {k: v[0] for k, v in tparams["stages"][0]["stacked"]["0"][
        "tmix"].items()}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, 64)).astype(np.float32)
    jstate = tstate = None
    if with_state:
        xp = rng.standard_normal((2, 64)).astype(np.float32)
        wkv = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
        jstate = {"x_prev_t": jnp.asarray(xp), "wkv": jnp.asarray(wkv)}
        tstate = {"x_prev_t": _t(xp), "wkv": _t(wkv)}
    with jruntime.use_impl("ref"):
        jout, (jx, jwkv) = jrwkv6.apply(jp, jnp.asarray(x), cfg=jcfg,
                                        state=jstate)
    tout, (tx, twkv) = rwkv6.apply(tp, _t(x), cfg=tcfg, state=tstate)
    _close(tout, jout)
    _close(tx, jx)
    _close(twkv, jwkv)


def test_channel_mix_matches_jax(model):
    _jcfg, _tcfg, jparams, tparams = model
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["stages"][0][
        "stacked"]["0"]["ffn"])
    tp = {k: v[1] for k, v in tparams["stages"][0]["stacked"]["0"][
        "ffn"].items()}
    rng = np.random.default_rng(6)
    x, xp = (rng.standard_normal((2, 11, 64)).astype(np.float32)
             for _ in range(2))
    with jruntime.use_impl("ref"):
        want = jmlp.apply_cmix(jp, jnp.asarray(x), jnp.asarray(xp))
    _close(mlp.apply_cmix(tp, _t(x), _t(xp)), want)


# ------------------------------ the LM ---------------------------------


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_forward_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(9, (2, 21))
    with jruntime.use_impl("ref"):
        want, _ = jlm.forward(jparams, jnp.asarray(toks), jcfg, remat=False)
    got, aux = lm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.shape == (2, 21, 256) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("jimpl", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(model, jimpl, trace_on):
    """Prefill at a ragged length (S=21: one full chunk and a tail), then
    three decode steps: logits and every cache leaf, held against JAX's
    plain path and, for the prefill, its Pallas kernels in interpret
    mode (decode runs JAX's plain scan either way: its kernel takes no
    starting state)."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(10, (2, 24))
    before = _counts()
    with jruntime.use_impl(jimpl):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :21]), jcfg)
    tlg, tcache = lm.prefill(tparams, torch.from_numpy(toks[:, :21]).long(),
                             tcfg)
    _close(tlg, jlg)
    jl = jax.tree_util.tree_leaves(jcache)
    tl = _leaves(tcache)
    assert len(jl) == len(tl) == 3
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    if jimpl == "interpret":
        return
    jlen = jnp.full((2,), 21, jnp.int32)
    tlen = torch.full((2,), 21, dtype=torch.int32)
    for t in range(21, 24):
        with jruntime.use_impl("ref"):
            jlg, jcache = jlm.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t:t + 1]),
                                          jlen, jcfg)
        tlg, tcache = lm.decode_step(tparams, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]).long(),
                                     tlen, tcfg)
        _close(tlg, jlg)
        for tleaf, jleaf in zip(_leaves(tcache), jax.tree_util.tree_leaves(
                jcache)):
            _close(tleaf, jleaf)
        jlen, tlen = jlen + 1, tlen + 1
    assert _counts() == before          # CPU tensors launch no kernel


def test_greedy_matches_manual_greedy(model):
    jcfg, tcfg, jparams, tparams = model
    for seed, s in ((11, 9), (12, 17)):
        prompt = _tokens(seed, (s,))
        with jruntime.use_impl("ref"):
            want = manual_greedy(jparams, jcfg, jnp.asarray(prompt), 6,
                                 s + 6)
        got = lm.greedy(tparams, torch.from_numpy(prompt).long()[None],
                        tcfg, 6)
        assert got[0].tolist() == want


def test_module_matches_functional(model):
    _jcfg, tcfg, _jparams, tparams = model
    m = lm.LanguageModel(tcfg, tparams, device="cpu")
    assert all(not p.requires_grad for p in m.parameters())
    toks = torch.from_numpy(_tokens(13, (2, 7))).long()
    with torch.no_grad():
        a, cache = m.prefill(toks)
        b, _ = lm.prefill(tparams, toks, tcfg)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        lengths = torch.full((2,), 7, dtype=torch.int32)
        a, _ = m.decode_step(cache, toks[:, :1], lengths)
        b, _ = lm.decode_step(tparams, cache, toks[:, :1], lengths, tcfg)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert m.greedy(toks, 3).tolist() == lm.greedy(tparams, toks, tcfg,
                                                       3).tolist()


def test_init_cache_matches_jax():
    jc = jlm.init_cache(jconfigs.reduced(), 3, 16, jnp.bfloat16)
    tc = lm.init_cache(get_reduced("rwkv6-3b"), 3, device="cpu")
    for t, j in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()


def test_init_tree_matches_jax():
    """init_lm builds the JAX package's tree: the same keys, shapes and
    dtypes, ``u`` and ``w0`` fp32 in a bf16 model."""
    jtree, _ = jlm.init_lm(jax.random.PRNGKey(0), jconfigs.reduced())
    ttree = lm.init_lm(get_reduced("rwkv6-3b"),
                       torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jleaves) == len(tleaves) == 25
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


def test_from_jax_params_lm_tree_keeps_dtypes():
    jcfg = jconfigs.reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg)[0])
    out = from_jax_params(tree, get_reduced("rwkv6-3b"), device="cpu")
    tmix = out["stages"][0]["stacked"]["0"]["tmix"]
    assert tmix["u"].dtype == tmix["w0"].dtype == torch.float32
    assert tmix["wr"].dtype == out["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["embed"].float().numpy(), np.asarray(tree["embed"], np.float32))
    cfg = get_reduced("rwkv6-3b")
    for bad, match in (({"n_layers": 3}, "wants"), ({"d_model": 32}, "embed"),
                       ({"vocab": 300}, "embed")):
        with pytest.raises(ValueError, match=match):
            from_jax_params(tree, type(cfg)(**{**cfg.__dict__, **bad}),
                            device="cpu")


def test_positions_and_configs_match_jax():
    """The sinusoidal table: its frequencies come from each framework's
    fp32 exp, which may differ in the last bit, so an angle p * f may
    differ by p ulps of f: atol 2e-4 holds to position 333. The rows a
    decode step takes equal the whole table's rows exactly."""
    np.testing.assert_allclose(
        rope.sinusoidal_embedding(334, 64).numpy(),
        np.asarray(jrope.sinusoidal_embedding(334, 64)), rtol=0, atol=2e-4)
    rows = torch.tensor([0, 5, 333, 4097, 65535])
    torch.testing.assert_close(rope.sinusoidal_rows(rows, 64),
                               rope.sinusoidal_embedding(1 << 16, 64)[rows],
                               rtol=0, atol=0)
    for mine, theirs in ((get_config("rwkv6-3b"), jconfigs.CONFIG),
                         (get_reduced("rwkv6-3b"), jconfigs.reduced())):
        assert mine.param_counts() == theirs.param_counts()
        assert [dataclasses.asdict(s) for s in mine.stages()] == [
            dataclasses.asdict(s) for s in theirs.stages()]
    assert lm.padded_vocab(get_config("rwkv6-3b")) == 65536
    for arch in PENDING:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_config(arch)
