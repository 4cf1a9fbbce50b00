"""The port's sliding-window attention (gemma3-27b) against the JAX
package's, on CPU.

At gemma3-27b's ``reduced()`` size: 8 layers (two 2:1 local:global
groups and a 2-layer local tail), d 64, 4 q heads over 2 kv heads of
16, a 16-token window, GELU-gated MLP, RMSNorm, tied head. Weights come
from the JAX initializer with the norm gains jittered in numpy; both
packages get the same arrays. Prompts run shorter than, as long as and
longer than the window, and greedy streams cross it. Tolerances:
rtol = atol = 2e-4 (the JAX package's prefill/decode-vs-forward
tolerance: only the order of fp32 sums differs); ring layouts and
greedy streams exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import manual_greedy

from repro.configs import gemma3_27b
from repro.core import runtime as jruntime
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import runtime
from repro_torch.kernels import ops
from repro_torch.models import attention, lm

TOL = dict(rtol=2e-4, atol=2e-4)
WINDOW = 16


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


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


_MODEL = {}


def _model():
    """(jcfg, tcfg, jparams, tparams) of gemma3-smoke, the norm gains
    jittered by 0.1, built once per module."""
    if not _MODEL:
        jcfg, tcfg = gemma3_27b.reduced(), get_reduced("gemma3-27b")
        params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg,
                                dtype=jnp.float32)
        rng = np.random.default_rng(1)

        def jit(path, leaf):
            a = np.asarray(leaf)
            if path[-1].key == "g":
                a = a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a
        tree = jax.tree_util.tree_map_with_path(jit, params)
        _MODEL["m"] = (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                       from_jax_params(tree, tcfg, device="cpu"))
    return _MODEL["m"]


@pytest.fixture(scope="module", autouse=True)
def _drop_model():
    yield
    _MODEL.clear()


def test_config_has_local_and_global_stages():
    """Two 2:1 groups and a tail of 2 local layers, the window on the
    local blocks only; the full config's 10 groups of 5:1 and its tail."""
    for cfg, groups, window in ((get_reduced("gemma3-27b"), 2, WINDOW),
                                (get_config("gemma3-27b"), 10, 1024)):
        body, tail = cfg.stages()
        assert body.repeat == groups and tail.repeat == 2
        assert [b.window for b in body.body] == (
            [window] * cfg.pattern_local + [0] * cfg.pattern_global)
        assert [b.window for b in tail.body] == [window]


@pytest.mark.parametrize("s", [9, WINDOW, 40], ids=["short", "window",
                                                    "long"])
def test_ring_from_prefill_matches_jax(s):
    """Prefill states as a ring of ``window`` slots: zero-padded up to
    the window, else the last ``window`` positions at slots p % window."""
    k = np.random.default_rng(s).standard_normal(
        (3, 2, s, 2, 4)).astype(np.float32)
    got = lm._ring_from_prefill(_t(k), WINDOW)
    want = jlm._ring_from_prefill(jnp.asarray(k), WINDOW)
    assert tuple(got.shape) == want.shape == (3, 2, WINDOW, 2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if s > WINDOW:
        for p in range(s - WINDOW, s):
            np.testing.assert_array_equal(got[:, :, p % WINDOW].numpy(),
                                          k[:, :, p])


def test_ring_write_cache_in_place():
    """A token's k/v land at slot pos % slots of the ring, in place, for
    rows before and after the ring wraps."""
    k = torch.zeros(2, WINDOW, 1, 2)
    cache = attention.KVCache(k, k.clone())
    new = torch.arange(4, dtype=torch.float32).reshape(2, 1, 1, 2) + 1
    pos = torch.tensor([15, 37])
    out = attention.write_cache(cache, new, -new, pos)
    assert out.k is k
    want = jattn.write_cache(
        jattn.KVCache(jnp.zeros((2, WINDOW, 1, 2)),
                      jnp.zeros((2, WINDOW, 1, 2))),
        jnp.asarray(new.numpy()), jnp.asarray(-new.numpy()),
        jnp.array([15, 37]), window=WINDOW)
    np.testing.assert_array_equal(k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(want.v))
    assert k[0, 15].abs().sum() > 0 and k[1, 37 % WINDOW].abs().sum() > 0


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("slots", [WINDOW, 12], ids=["ring", "short-alloc"])
def test_decode_apply_window_matches_jax(slots, fuse):
    """One decode token of a local layer into a cache of ``slots``: the
    ring (slots = window: every written slot attends, kv_len = min(len +
    1, window), rows before and after the wrap) and a cache shorter than
    the window (init_cache's min(alloc, window): kv_len = len + 1)."""
    jcfg, tcfg, jparams, tparams = _model()
    ja = jax.tree_util.tree_map(lambda a: a[0], jparams["stages"][0][
        "stacked"]["0"]["attn"])
    ta = lm._tree_map(lambda a: a[0], tparams["stages"][0]["stacked"]["0"][
        "attn"])
    jn = jax.tree_util.tree_map(lambda a: a[0], jparams["stages"][0][
        "stacked"]["0"]["norm1"])
    tn = lm._tree_map(lambda a: a[0], tparams["stages"][0]["stacked"]["0"][
        "norm1"])
    rng = np.random.default_rng(slots)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, slots, 2, 16)).astype(np.float32)
              for _ in range(2))
    lengths = (np.array([5, 30], np.int32) if slots == WINDOW
               else np.array([3, 10], np.int32))
    kw_j = kw_t = {}
    if fuse:
        kw_j = dict(norm=jops.NormSpec("rms", jn["g"]),
                    residual=jnp.asarray(x))
        kw_t = dict(norm=ops.NormSpec("rms", tn["g"]), residual=_t(x))
    with jruntime.use_impl("ref"):
        jout, jc = jattn.decode_apply(
            ja, jnp.asarray(x), jattn.KVCache(jnp.asarray(ck),
                                              jnp.asarray(cv)),
            cfg=jcfg, lengths=jnp.asarray(lengths), window=WINDOW, **kw_j)
    cache = attention.KVCache(_t(ck), _t(cv))
    tout, tc = attention.decode_apply(
        ta, _t(x), cache, cfg=tcfg, lengths=torch.from_numpy(lengths),
        window=WINDOW, **kw_t)
    assert tc.k is cache.k and tc.v is cache.v
    for t, j in ((tout, jout), (tc.k, jc.k), (tc.v, jc.v)):
        _close(t, j)


@pytest.mark.parametrize("alloc", [10, WINDOW, 40])
def test_init_cache_matches_jax(alloc):
    """Local layers' rings of min(alloc, window) slots, global layers'
    caches of alloc: the JAX package's keys, shapes and dtypes."""
    jcfg, tcfg = gemma3_27b.reduced(), get_reduced("gemma3-27b")
    jc = jlm.init_cache(jcfg, 3, alloc, jnp.float32)
    tc = lm.init_cache(tcfg, 3, alloc, dtype=torch.float32, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jc), _leaves(tc)
    assert len(jl) == len(tl) == 2 * 4
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape and not t.any()
    assert tc[0]["0"]["kv"].k.shape[2] == min(alloc, WINDOW)
    assert tc[0]["2"]["kv"].k.shape[2] == alloc


def test_init_lm_tree_matches_jax():
    jcfg, tcfg = gemma3_27b.reduced(), get_reduced("gemma3-27b")
    jtree, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    ttree = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jleaves) == len(tleaves) and "lm_head" not in ttree
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("jimpl", ["ref", "interpret"])
@pytest.mark.parametrize("s", [11, 21])
def test_prefill_and_decode_match_jax(s, jimpl, fuse):
    """Prefill of ``s`` tokens (shorter and longer than the window) into
    a cache of alloc = s + 3, then three decode steps: logits and every
    cache leaf (the local layers' rings, the global layers' caches), held
    against JAX's plain path and, for the prefill, its Pallas kernels in
    interpret mode (the windowed flash kernel); fused or per op on both
    sides."""
    jcfg, tcfg, jparams, tparams = _model()
    toks = _tokens(s, (2, s + 3))
    with jruntime.use_impl(jimpl), jruntime.use_pipeline_fusion(fuse):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :s]), jcfg,
                                  alloc=s + 3)
    with runtime.use_pipeline_fusion(fuse):
        tlg, tcache = lm.prefill(tparams,
                                 torch.from_numpy(toks[:, :s]).long(), tcfg,
                                 alloc=s + 3)
    _close(tlg, jlg)
    jl, tl = jax.tree_util.tree_leaves(jcache), _leaves(tcache)
    assert len(jl) == len(tl) == 2 * 4
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    if jimpl == "interpret":
        return
    jlen = jnp.full((2,), s, jnp.int32)
    tlen = torch.full((2,), s, dtype=torch.int32)
    for t in range(s, s + 3):
        with jruntime.use_impl("ref"), jruntime.use_pipeline_fusion(fuse):
            jlg, jcache = jlm.decode_step(jparams, jcache,
                                          jnp.asarray(toks[:, t:t + 1]),
                                          jlen, jcfg)
        with runtime.use_pipeline_fusion(fuse):
            tlg, tcache = lm.decode_step(
                tparams, tcache, torch.from_numpy(toks[:, t:t + 1]).long(),
                tlen, tcfg)
        _close(tlg, jlg)
        for tleaf, jleaf in zip(_leaves(tcache),
                                jax.tree_util.tree_leaves(jcache)):
            _close(tleaf, jleaf)
        jlen, tlen = jlen + 1, tlen + 1


def test_decode_writes_the_ring_in_place():
    """A decode step writes its token into slot ``lengths % window`` of
    each local layer's ring and position ``lengths`` of each global
    layer's cache, in place, and nowhere else."""
    _jcfg, tcfg, _jparams, tparams = _model()
    toks = torch.from_numpy(_tokens(3, (2, 20))).long()
    _, cache = lm.prefill(tparams, toks, tcfg, alloc=24)
    ring, glob = cache[0]["0"]["kv"], cache[0]["2"]["kv"]
    before = ring.k.clone(), glob.k.clone()
    lengths = torch.tensor([20, 20], dtype=torch.int32)
    _, new = lm.decode_step(tparams, cache, toks[:, :1], lengths, tcfg)
    assert new[0]["0"]["kv"].k is ring.k and new[0]["2"]["kv"].k is glob.k
    for leaf, old, slot in ((ring.k, before[0], 20 % WINDOW),
                            (glob.k, before[1], 20)):
        changed = (leaf != old).flatten(3).any(-1)       # (R, B, slots)
        assert changed[:, :, slot].all()
        changed[:, :, slot] = False
        assert not changed.any()


@pytest.mark.parametrize("s", [8, WINDOW, 40])
def test_greedy_matches_manual_greedy(s):
    """24 new tokens after prompts shorter than, as long as and longer
    than the window: every stream crosses it."""
    jcfg, tcfg, jparams, tparams = _model()
    prompt = _tokens(100 + s, (s,))
    with jruntime.use_impl("ref"):
        want = manual_greedy(jparams, jcfg, jnp.asarray(prompt), 24, s + 24)
    got = lm.greedy(tparams, torch.from_numpy(prompt).long()[None], tcfg,
                    24)
    assert got[0].tolist() == want


def test_fused_matches_unfused():
    _jcfg, tcfg, _jparams, tparams = _model()
    toks = torch.from_numpy(_tokens(14, (2, 19))).long()
    fused, fcache = lm.prefill(tparams, toks, tcfg, alloc=21)
    with runtime.use_pipeline_fusion(False):
        unfused, ucache = lm.prefill(tparams, toks, tcfg, alloc=21)
    torch.testing.assert_close(unfused, fused, **TOL)
    lengths = torch.full((2,), 19, dtype=torch.int32)
    fused, _ = lm.decode_step(tparams, fcache, toks[:, :1], lengths, tcfg)
    with runtime.use_pipeline_fusion(False):
        unfused, _ = lm.decode_step(tparams, ucache, toks[:, :1], lengths,
                                    tcfg)
    torch.testing.assert_close(unfused, fused, **TOL)
    for f, u in zip(_leaves(fcache), _leaves(ucache)):
        torch.testing.assert_close(u, f, **TOL)
