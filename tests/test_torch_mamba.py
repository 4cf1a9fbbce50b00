"""The port's Mamba2 hybrid (zamba2) against the JAX package's, on CPU.

At ``reduced()`` size (zamba2-smoke: 5 layers, d 64, a shared attention
block every 3rd layer, 4 SSD heads of 32, state 16). Weights come from
the JAX initializer with their constant leaves jittered in numpy
(``A_log``, ``dt_bias``, ``D``, the conv bias and the norm gains), inputs
from a numpy seed; both packages get the same arrays. Tolerances, each
with its reason:

* the SSD scan (chunked and per-step), the conv, the mixer and the
  model's logits and caches in fp32: rtol = atol = 2e-4, the JAX
  package's prefill/decode-vs-forward tolerance (only the order of fp32
  sums differs; every SSD decay factor is at most 1);
* the mixer in bf16: 3e-2 x max(1, max|ref|), chip_smoke.py's bf16
  tolerance (bf16 keeps 8 bits of mantissa, and the two packages' fp32
  sums may round a projection's output to neighbouring bf16 values);
* greedy streams: exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import manual_greedy

from repro.configs import zamba2 as jconfigs
from repro.core import runtime as jruntime
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba2
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import trace
from repro_torch.core.types import jax_fields
from repro_torch.models import lm, mamba2

ARCH = "zamba2-1.2b"
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = 3e-2


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


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order (dict keys
    sorted, tuples in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def jitter(tree, seed):
    """Spread the initializer's constant leaves: ``A_log`` over [-1, 1.5]
    (decays from e^-0.37 to e^-4.5 per unit dt), ``dt_bias`` by 0.5,
    ``D``, the conv bias and every norm gain by 0.1."""
    rng = np.random.default_rng(seed)

    def jit(path, leaf):
        a = np.asarray(leaf)
        name = path[-1].key

        def noise(scale):
            return (scale * rng.standard_normal(a.shape)).astype(a.dtype)

        if name == "A_log":
            return rng.uniform(-1.0, 1.5, a.shape).astype(a.dtype)
        if name == "dt_bias":
            return a + noise(0.5)
        if name in ("D", "conv_b", "g", "b", "norm_g"):
            return a + noise(0.1)
        return a
    return jax.tree_util.tree_map_with_path(jit, tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.reduced()
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tree = jitter(jax.tree_util.tree_map(np.asarray, params), 1)
    return (jcfg, get_reduced(ARCH),
            jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, get_reduced(ARCH), device="cpu"), tree)


def _counts():
    return trace.launches("rowwise_matmul"), trace.launches("layernorm")


# ------------------------------- SSD ----------------------------------


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.uniform(-1.0, 1.0, (h,))).astype(np.float32)
    B, C = (rng.standard_normal((b, s, n)).astype(np.float32)
            for _ in range(2))
    return xh, dt, a, B, C


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 45, 3, 8, 16, 16), (1, 16, 2, 8, 4, 16), (2, 64, 2, 16, 8, 32),
    (1, 7, 2, 8, 8, 128), (2, 1, 4, 8, 16, 128), (1, 33, 1, 4, 4, 8)])
def test_ssd_matches_jax(b, s, h, p, n, chunk):
    """The chunked scan at S a multiple of the chunk, not one (padded
    tail), shorter than it and S = 1 (a decode step), and the per-step
    oracle, each against JAX's; the two forms agree."""
    args = _ssd_inputs(b * 100 + s, b, s, h, p, n)
    jy, js = jmamba2.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    ty, ts = mamba2.ssd_chunked(*map(_t, args), chunk=chunk)
    _close(ty, jy)
    _close(ts, js)
    ry, rs = jmamba2.ssd_ref(*map(jnp.asarray, args))
    ty2, ts2 = mamba2.ssd_ref(*map(_t, args))
    _close(ty2, ry)
    _close(ts2, rs)
    _close(ty, ty2.numpy())
    _close(ts, ts2.numpy())


@pytest.mark.parametrize("split", [1, 20, 32])
def test_ssd_state_continues(split):
    """A starting state: the scan over a prefix, then over the rest from
    the prefix's final state, equals the scan over the whole (and JAX's
    with the same ``s0``)."""
    b, s, h, p, n = 2, 45, 3, 8, 16
    args = [_t(a) for a in _ssd_inputs(5, b, s, h, p, n)]
    y, st = mamba2.ssd_chunked(*args, chunk=16)
    head = [a[:, :split] if a.dim() > 1 else a for a in args]
    rest = [a[:, split:] if a.dim() > 1 else a for a in args]
    y1, s1 = mamba2.ssd_chunked(*head, chunk=16)
    y2, s2 = mamba2.ssd_chunked(*rest, chunk=16, s0=s1)
    _close(torch.cat([y1, y2], 1), y.numpy())
    _close(s2, st.numpy())
    jy2, js2 = jmamba2.ssd_chunked(
        *(jnp.asarray(a.numpy()) for a in rest), chunk=16,
        s0=jnp.asarray(s1.numpy()))
    _close(y2, jy2)
    _close(s2, js2)


@pytest.mark.parametrize("with_state", [False, True], ids=["pad", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_matches_jax(with_state, dtype):
    """The causal depthwise conv with and without a rolling state (fp32
    weights, the input in ``dtype``): the output (fp32) and the new
    state (the input's dtype, bitwise) as JAX gives them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (0.3 * rng.standard_normal((4, 24))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((24,))).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    jout, jst = jmamba2._conv(jx, jnp.asarray(w), jnp.asarray(bias),
                              jnp.asarray(st) if with_state else None)
    tout, tst = mamba2._conv(tx, _t(w), _t(bias),
                             _t(st) if with_state else None)
    assert tout.dtype == torch.float32 and tst.dtype == tdt
    _close(tout, jout)
    np.testing.assert_array_equal(tst.float().numpy(),
                                  np.asarray(jst, np.float32))


def _mixer(tree, layer=0):
    return {k: v[layer] for k, v in tree["stages"][0]["stacked"]["0"][
        "mamba"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_mixer_matches_jax(model, dtype, with_state):
    """``mamba2.apply`` on one layer's weights: the output and both
    state leaves, fp32 and bf16 (``A_log``, ``dt_bias`` and ``D`` stay
    fp32 in the bf16 tree, as in JAX's); S = 19 with the chunk at 8, so
    the scan pads a tail."""
    jcfg, tcfg, _jparams, _tparams, tree = model
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    keep = ("A_log", "dt_bias", "D")
    mixer = {k: v if k in keep else v.astype(jdt)
             for k, v in _mixer(tree).items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 19, 64)).astype(np.float32)
    _, d_in, h, conv_dim = mamba2._dims(tcfg)
    jstate = tstate = None
    if with_state:
        conv = rng.standard_normal((2, 3, conv_dim)).astype(np.float32)
        ssm = rng.standard_normal((2, h, 32, 16)).astype(np.float32)
        jstate = jmamba2.MambaState(jnp.asarray(conv).astype(jdt),
                                    jnp.asarray(ssm))
        tstate = mamba2.MambaState(_t(conv).to(tdt), _t(ssm))
    with jruntime.use_impl("ref"):
        jout, jst = jmamba2.apply(
            jax.tree_util.tree_map(jnp.asarray, mixer),
            jnp.asarray(x).astype(jdt), cfg=jcfg, state=jstate, chunk=8)
    tmix = {k: _t(v).to(torch.float32 if k in keep else tdt)
            for k, v in mixer.items()}
    tout, tst = mamba2.apply(tmix, _t(x).to(tdt), cfg=tcfg, state=tstate,
                             chunk=8)
    assert tout.dtype == tdt and tst.conv.dtype == tdt
    assert tst.ssm.dtype == torch.float32
    if dtype == "float32":
        for t, j in zip((tout, *tst), (jout, *jst)):
            _close(t, j)
        return
    for t, j in zip((tout, *tst), (jout, *jst)):
        j = np.asarray(j, np.float32)
        err = np.abs(t.float().numpy() - j).max()
        assert err <= BF16_TOL * max(1.0, np.abs(j).max()), err


# ------------------------------ the LM ---------------------------------


def test_forward_matches_jax(model):
    jcfg, tcfg, jparams, tparams, _ = model
    toks = _tokens(9, (2, 21))
    with jruntime.use_impl("ref"):
        want, jaux = jlm.forward(jparams, jnp.asarray(toks), jcfg,
                                 remat=False)
    got, aux = lm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.shape == (2, 21, 256)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("jimpl", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(model, jimpl, trace_on):
    """Prefill at S = 21 into a cache of 24, then three decode steps:
    the logits and every cache leaf (each Mamba layer's ``conv`` and
    ``ssm``, the shared block's KV per repeat), held against JAX's
    plain path and, for the prefill, its Pallas kernels in interpret
    mode. CPU tensors launch no kernel."""
    jcfg, tcfg, jparams, tparams, _ = model
    toks = _tokens(10, (2, 24))
    before = _counts()
    with jruntime.use_impl(jimpl):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :21]), jcfg,
                                  alloc=24)
    tlg, tcache = lm.prefill(tparams, torch.from_numpy(toks[:, :21]).long(),
                             tcfg, alloc=24)
    _close(tlg, jlg)
    jl, tl = jax.tree_util.tree_leaves(jcache), _leaves(tcache)
    # stage 0: 2 Mamba layers (conv, ssm) and the shared block's (k, v);
    # stage 1: 1 Mamba layer
    assert len(jl) == len(tl) == 8
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        _close(t, j)
    assert tcache[0]["2"]["kv"].k.shape[0] == 1       # one KV per repeat
    if jimpl == "interpret":
        return
    jlen = jnp.full((2,), 21, jnp.int32)
    tlen = torch.full((2,), 21, dtype=torch.int32)
    for t in range(21, 24):
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
    assert _counts() == before


def test_shared_block_keeps_one_kv_cache_per_repeat():
    """zamba2-smoke at 6 layers: the shared block repeats twice on one
    weight copy (its leaves unstacked) with a KV cache per repeat
    (leaves (R=2, B, alloc, Hkv, hd), as JAX's): a prefill and two
    decode steps, logits and every cache leaf against JAX; the two
    repeats' K differ."""
    jcfg = dataclasses.replace(jconfigs.reduced(), n_layers=6)
    tcfg = dataclasses.replace(get_reduced(ARCH), n_layers=6)
    assert [st.repeat for st in tcfg.stages()] == [2]
    params, _ = jlm.init_lm(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tree = jitter(jax.tree_util.tree_map(np.asarray, params), 2)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = from_jax_params(tree, tcfg, device="cpu")
    assert tparams["stages"][0]["shared"]["2"]["attn"]["wqkv"].dim() == 2
    toks = _tokens(15, (2, 11))
    with jruntime.use_impl("ref"):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :9]), jcfg,
                                  alloc=11)
    tlg, tcache = lm.prefill(tparams, torch.from_numpy(toks[:, :9]).long(),
                             tcfg, alloc=11)
    _close(tlg, jlg)
    k = tcache[0]["2"]["kv"].k
    assert tuple(k.shape) == (2, 2, 11, 4, 16)
    assert not torch.equal(k[0], k[1])
    jlen, tlen = jnp.full((2,), 9, jnp.int32), torch.full((2,), 9,
                                                          dtype=torch.int32)
    for t in (9, 10):
        with jruntime.use_impl("ref"):
            jlg, jcache = jlm.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t:t + 1]),
                                          jlen, jcfg)
        tlg, tcache = lm.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, t:t + 1]).long(),
            tlen, tcfg)
        _close(tlg, jlg)
        jlen, tlen = jlen + 1, tlen + 1
    for t, j in zip(_leaves(tcache), jax.tree_util.tree_leaves(jcache)):
        assert tuple(t.shape) == j.shape
        _close(t, j)


def test_greedy_matches_manual_greedy(model):
    jcfg, tcfg, jparams, tparams, _ = model
    for seed, s in ((11, 9), (12, 17)):
        prompt = _tokens(seed, (s,))
        with jruntime.use_impl("ref"):
            want = manual_greedy(jparams, jcfg, jnp.asarray(prompt), 6,
                                 s + 6)
        got = lm.greedy(tparams, torch.from_numpy(prompt).long()[None],
                        tcfg, 6)
        assert got[0].tolist() == want


def test_insert_prefill_mixes_pools_and_state(model):
    """A paged zamba2 cache holds the shared block's page pools (one per
    repeat) and every Mamba layer's per-slot state: one
    ``insert_prefill`` of a 13-token prompt into slot 1 writes both,
    and every leaf of the cache after it equals JAX's."""
    jcfg, tcfg, jparams, tparams, _ = model
    prompt = _tokens(14, (1, 13))
    pages = np.array([4, 1, 0, 0], np.int32)        # 13 tokens: 2 pages
    jc = jlm.init_paged_cache(jcfg, 3, 32, page_size=8, dtype=jnp.float32)
    tc = lm.init_paged_cache(tcfg, 3, 32, page_size=8, dtype=torch.float32,
                             device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jc), _leaves(tc)
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
    with jruntime.use_impl("ref"):
        jlg, jst = jlm.prefill_states(jparams, jnp.asarray(prompt), jcfg)
        jc = jlm.insert_prefill(jcfg, jc, jst, slot=1,
                                pages=jnp.asarray(pages), plen=13,
                                page_size=8)
    tlg, tst = lm.prefill_states(tparams, torch.from_numpy(prompt).long(),
                                 tcfg)
    tc = lm.insert_prefill(tcfg, tc, tst, slot=1, pages=pages, plen=13,
                           page_size=8)
    _close(tlg, jlg)
    for t, j in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(t, j)
    mamba = tc[1]["0"]["mamba"]
    assert mamba.ssm[:, 1].abs().sum() > 0
    assert not mamba.ssm[:, [0, 2]].any()           # other slots untouched


# ------------------------------ trees ----------------------------------


def test_init_tree_and_cache_match_jax():
    """init_lm builds the JAX package's tree (the same keys, shapes and
    dtypes: ``A_log``, ``dt_bias`` and ``D`` fp32 in a bf16 model, the
    shared block unstacked); init_cache the same zeroed leaves."""
    jtree, _ = jlm.init_lm(jax.random.PRNGKey(0), jconfigs.reduced())
    ttree = lm.init_lm(get_reduced(ARCH), torch.Generator().manual_seed(0),
                       device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
    jc = jlm.init_cache(jconfigs.reduced(), 3, 16, jnp.bfloat16)
    tc = lm.init_cache(get_reduced(ARCH), 3, 16, device="cpu")
    for t, j in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()


def test_from_jax_params_checks_the_mamba_leaves():
    """The bf16 hybrid tree crosses leaf for leaf, its fp32 vectors
    fp32; a tree of another SSD width, state or conv, or with a bf16
    ``A_log``, is refused naming the block and the leaf."""
    jcfg = jconfigs.reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg)[0])
    cfg = get_reduced(ARCH)
    out = from_jax_params(tree, cfg, device="cpu")
    mix = out["stages"][0]["stacked"]["0"]["mamba"]
    assert mix["A_log"].dtype == mix["D"].dtype == torch.float32
    assert mix["in_proj"].dtype == torch.bfloat16
    ssm = cfg.ssm
    for bad, match in (
            ({"ssm": dataclasses.replace(ssm, expand=4)},
             "stage 0 block 0: mamba in_proj"),
            ({"ssm": dataclasses.replace(ssm, d_state=8)}, "in_proj"),
            ({"ssm": dataclasses.replace(ssm, d_conv=3)},
             "stage 0 block 0: mamba conv_w"),
            ({"ssm": dataclasses.replace(ssm, head_dim=16)}, "in_proj"),
            ({"n_layers": 4}, "stage 1 block 0: norm1")):
        with pytest.raises(ValueError, match=match):
            from_jax_params(tree, dataclasses.replace(cfg, **bad),
                            device="cpu")
    stacked = tree["stages"][1]["stacked"]["0"]["mamba"]
    saved = stacked["A_log"]
    stacked["A_log"] = saved.astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="stage 1 block 0: mamba A_log"):
        from_jax_params(tree, cfg, device="cpu")
    stacked["A_log"] = saved


def test_configs_match_jax():
    """The configs equal JAX's, stages and ``param_counts`` included.
    ``param_counts`` is the reference's and undercounts zamba2's tree:
    it prices ``in_proj`` as 2 d_in d + 2 d_in N (ROADMAP.md reference
    caveats), 0.670 B against the 0.935 B the tree holds."""
    for mine, theirs in ((get_config(ARCH), jconfigs.CONFIG),
                         (get_reduced(ARCH), jconfigs.reduced())):
        assert jax_fields(mine) == dataclasses.asdict(theirs)
        assert mine.param_counts() == theirs.param_counts()
        assert [dataclasses.asdict(s) for s in mine.stages()] == [
            dataclasses.asdict(s) for s in theirs.stages()]
    cfg = get_config(ARCH)
    tree = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                              jconfigs.CONFIG)[0])
    held = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))
    assert held == 934_641_664
    assert cfg.param_counts()["total"] == 670_117_888
