"""The port's dense decoder LMs against the JAX package's, on CPU.

At the ``reduced()`` sizes of deepseek-7b (MHA, SwiGLU, RMSNorm, untied
head), internlm2-20b (GQA 8:2) and granite-20b (MQA, GELU MLP, LayerNorm
with beta, tied head): 2 layers, d 64. Weights come from the JAX
initializer with the norm gains and biases jittered in numpy (so the
gamma and beta paths are exercised); inputs from a numpy seed; both
packages get the same arrays. Tolerances, each with its reason:

* RoPE at positions up to 600: rtol 0, atol 2e-4. Each framework takes
  the frequencies ``theta ** (-i / half)`` from its own fp32 pow, which
  may differ in the last bit, so an angle p * f may differ by p ulps of
  f (f <= 1: at most 600 * 2^-24 = 3.6e-5 rad), times |x| <= 5;
* attention, the MLP, forward, prefill and decode logits and caches:
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

from repro.configs import (deepseek_7b, gemma3_27b, granite_20b,
                           internlm2_20b, whisper_base)
from repro.core import runtime as jruntime
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import runtime
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.models import attention, blocks, lm, mlp, rope

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = {"deepseek-7b": deepseek_7b, "internlm2-20b": internlm2_20b,
         "granite-20b": granite_20b}


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


def _counts():
    return (rowwise_matmul_p.launches, flash_attention_p.launches,
            layernorm_p.launches)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order (dict keys
    sorted, tuples in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def jitter(tree, seed):
    """The norm gains and biases (constant at init) spread by 0.1."""
    rng = np.random.default_rng(seed)

    def jit(path, leaf):
        a = np.asarray(leaf)
        if path[-1].key in ("g", "b"):
            return a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(jit, tree)


_MODELS = {}


def _model(arch):
    """(jcfg, tcfg, jparams, tparams, numpy tree) of one reduced arch,
    built once per module."""
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


def _layer(jparams, tparams, name, i=0):
    jp = jax.tree_util.tree_map(lambda a: a[i], jparams["stages"][0][
        "stacked"]["0"][name])
    tp = lm._tree_map(lambda a: a[i], tparams["stages"][0]["stacked"]["0"][
        name])
    return jp, tp


# ------------------------------- RoPE ----------------------------------


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_rope_matches_jax(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 601, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(601), rng.permutation(601)]).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    got = rope.apply_rope(_t(x), torch.from_numpy(pos))
    _close(got, want, dict(rtol=0, atol=2e-4))
    # bf16 in, bf16 out: the rotation in fp32, one rounding at the end
    got16 = rope.apply_rope(_t(x).to(torch.bfloat16), torch.from_numpy(pos))
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(
        got16, rope.apply_rope(_t(x).to(torch.bfloat16).float(),
                               torch.from_numpy(pos)).to(torch.bfloat16),
        rtol=0, atol=0)


# ---------------------------- attention --------------------------------


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("mode", ["kv_len", "causal-offset", "window"])
def test_chunked_attention_matches_jax(hq, hkv, mode):
    """The online-softmax scan over several chunks (chunk 16 over 40
    keys, the last one partial): a per-row ``kv_len`` (decode), causal
    with a query offset, a causal window; against JAX's scan and, where
    every key is valid, the dense plain version."""
    rng = np.random.default_rng(hq * 10 + hkv)
    sq = 1 if mode == "kv_len" else 24
    q = rng.standard_normal((2, hq, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, 40, 16)).astype(np.float32)
            for _ in range(2))
    kw = {"kv_len": dict(causal=False, kv_len=np.array([33, 7])),
          "causal-offset": dict(causal=True, q_offset=16),
          "window": dict(causal=True, q_offset=16, window=12)}[mode]
    jkw = {key: jnp.asarray(val) if key == "kv_len" else val
           for key, val in kw.items()}
    tkw = {key: torch.from_numpy(val) if key == "kv_len" else val
           for key, val in kw.items()}
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), chunk=16,
                                   **jkw)
    got = attention.chunked_attention(*map(_t, (q, k, v)), chunk=16, **tkw)
    _close(got, want)
    if mode != "kv_len":
        _close(ops.attention(*map(_t, (q, k, v)), **tkw), want)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_attention_apply_and_decode_match_jax(arch, fuse):
    """``attention.apply`` over a ragged prompt (its output and the k/v
    heads it hands prefill), then ``decode_apply`` of one more token
    into a padded cache at per-row lengths; fused (the norm in the qkv
    prologue, the residual in the epilogue) or per op."""
    jcfg, tcfg, jparams, tparams, _ = _model(arch)
    ja, ta = _layer(jparams, tparams, "attn")
    jn, tn = _layer(jparams, tparams, "norm1")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    jnorm = jops.NormSpec(jcfg.norm, jn["g"], jn.get("b")) if fuse else None
    tnorm = ops.NormSpec(tcfg.norm, tn["g"], tn.get("b")) if fuse else None
    res = x if fuse else None
    with jruntime.use_impl("ref"):
        jout, (jk, jv) = jattn.apply(
            ja, jnp.asarray(x), cfg=jcfg, positions=jnp.asarray(pos),
            norm=jnorm, residual=None if res is None else jnp.asarray(res))
    tout, (tk, tv) = attention.apply(
        ta, _t(x), cfg=tcfg, positions=torch.from_numpy(pos.copy()),
        norm=tnorm, residual=None if res is None else _t(res))
    for t, j in ((tout, jout), (tk, jk), (tv, jv)):
        _close(t, j)
    # decode: rows hold 13 and 9 tokens of a 16-position cache
    ck, cv = (rng.standard_normal(
        (2, 16, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32)
        for _ in range(2))
    lengths = np.array([13, 9], np.int32)
    xd = x[:, :1]
    with jruntime.use_impl("ref"):
        jout, jc = jattn.decode_apply(
            ja, jnp.asarray(xd), jattn.KVCache(jnp.asarray(ck),
                                               jnp.asarray(cv)),
            cfg=jcfg, lengths=jnp.asarray(lengths), norm=jnorm,
            residual=None if res is None else jnp.asarray(xd))
    cache = attention.KVCache(_t(ck), _t(cv))
    tout, tc = attention.decode_apply(
        ta, _t(xd), cache, cfg=tcfg, lengths=torch.from_numpy(lengths),
        norm=tnorm, residual=None if res is None else _t(xd))
    assert tc.k is cache.k and tc.v is cache.v     # written in place
    for t, j in ((tout, jout), (tc.k, jc.k), (tc.v, jc.v)):
        _close(t, j)


def test_write_cache_wraps_in_place():
    k = torch.zeros(2, 5, 1, 2)
    cache = attention.KVCache(k, k.clone())
    new = torch.arange(12, dtype=torch.float32).reshape(2, 3, 1, 2) + 1
    out = attention.write_cache(cache, new, -new, torch.tensor([1, 4]))
    assert out.k is k
    want = jattn.write_cache(jattn.KVCache(jnp.zeros((2, 5, 1, 2)),
                                           jnp.zeros((2, 5, 1, 2))),
                             jnp.asarray(new.numpy()),
                             jnp.asarray(-new.numpy()), jnp.array([1, 4]))
    np.testing.assert_array_equal(k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(want.v))


# ------------------------------- MLP -----------------------------------


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-20b"],
                         ids=["gated", "gelu"])
def test_mlp_matches_jax(arch, fuse):
    jcfg, tcfg, jparams, tparams, _ = _model(arch)
    jp, tp = _layer(jparams, tparams, "ffn", 1)
    jn, tn = _layer(jparams, tparams, "norm2", 1)
    x = np.random.default_rng(4).standard_normal((2, 11, 64)).astype(
        np.float32)
    kw_j = kw_t = {}
    if fuse:
        kw_j = dict(norm=jops.NormSpec(jcfg.norm, jn["g"], jn.get("b")),
                    residual=jnp.asarray(x))
        kw_t = dict(norm=ops.NormSpec(tcfg.norm, tn["g"], tn.get("b")),
                    residual=_t(x))
    with jruntime.use_impl("ref"):
        want = jmlp.apply(jp, jnp.asarray(x), cfg=jcfg, **kw_j)
    _close(mlp.apply(tp, _t(x), cfg=tcfg, **kw_t), want)


# ------------------------------ the LM ---------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch):
    jcfg, tcfg, jparams, tparams, _ = _model(arch)
    toks = _tokens(9, (2, 21))
    with jruntime.use_impl("ref"):
        want, _ = jlm.forward(jparams, jnp.asarray(toks), jcfg, remat=False)
    got, aux = lm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert got.shape == (2, 21, 256) and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("jimpl", ["ref", "interpret"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax(arch, jimpl):
    """Prefill of 21 tokens into a cache of alloc=24, then three decode
    steps: logits and every cache leaf (k and v, padding included),
    held against JAX's plain path and, for the prefill, its Pallas
    kernels in interpret mode (decode runs JAX's chunked scan either
    way)."""
    jcfg, tcfg, jparams, tparams, _ = _model(arch)
    toks = _tokens(10, (2, 24))
    before = _counts()
    with jruntime.use_impl(jimpl):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :21]), jcfg,
                                  alloc=24)
    tlg, tcache = lm.prefill(tparams, torch.from_numpy(toks[:, :21]).long(),
                             tcfg, alloc=24)
    _close(tlg, jlg)
    jl, tl = jax.tree_util.tree_leaves(jcache), _leaves(tcache)
    assert len(jl) == len(tl) == 2
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape == (2, 2, 24, tcfg.n_kv_heads,
                                             tcfg.head_dim)
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
        tlg, tcache = lm.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, t:t + 1]).long(),
            tlen, tcfg)
        _close(tlg, jlg)
        for tleaf, jleaf in zip(_leaves(tcache),
                                jax.tree_util.tree_leaves(jcache)):
            _close(tleaf, jleaf)
        jlen, tlen = jlen + 1, tlen + 1
    assert _counts() == before          # CPU tensors launch no kernel


@pytest.mark.parametrize("arch", list(ARCHS))
def test_fused_matches_unfused(arch):
    """The per-op path (separate norms, the stored panels sliced into
    one launch per projection) computes the fused path's function."""
    _jcfg, tcfg, _jparams, tparams, _ = _model(arch)
    toks = torch.from_numpy(_tokens(14, (2, 9))).long()
    fused, fcache = lm.prefill(tparams, toks, tcfg, alloc=10)
    with runtime.use_pipeline_fusion(False):
        unfused, ucache = lm.prefill(tparams, toks, tcfg, alloc=10)
    torch.testing.assert_close(unfused, fused, **TOL)
    lengths = torch.full((2,), 9, dtype=torch.int32)
    fused, _ = lm.decode_step(tparams, fcache, toks[:, :1], lengths, tcfg)
    with runtime.use_pipeline_fusion(False):
        unfused, _ = lm.decode_step(tparams, ucache, toks[:, :1], lengths,
                                    tcfg)
    torch.testing.assert_close(unfused, fused, **TOL)
    for f, u in zip(_leaves(fcache), _leaves(ucache)):
        torch.testing.assert_close(u, f, **TOL)


@pytest.mark.parametrize("arch,s", [("deepseek-7b", 9),
                                    ("internlm2-20b", 17),
                                    ("granite-20b", 12)])
def test_greedy_matches_manual_greedy(arch, s):
    jcfg, tcfg, jparams, tparams, _ = _model(arch)
    prompt = _tokens(s, (s,))
    with jruntime.use_impl("ref"):
        want = manual_greedy(jparams, jcfg, jnp.asarray(prompt), 6, s + 6)
    got = lm.greedy(tparams, torch.from_numpy(prompt).long()[None], tcfg, 6)
    assert got[0].tolist() == want


def test_decode_step_writes_the_kv_cache_in_place():
    """A decode step writes its token's k/v into the cache it was given
    (the returned cache shares those leaves) at position ``lengths``, and
    only there."""
    _jcfg, tcfg, _jparams, tparams, _ = _model("internlm2-20b")
    toks = torch.from_numpy(_tokens(15, (2, 6))).long()
    _, cache = lm.prefill(tparams, toks, tcfg, alloc=8)
    kv = cache[0]["0"]["kv"]
    before = kv.k.clone()
    lengths = torch.tensor([6, 6], dtype=torch.int32)
    _, new = lm.decode_step(tparams, cache, toks[:, :1], lengths, tcfg)
    assert new[0]["0"]["kv"].k is kv.k and new[0]["0"]["kv"].v is kv.v
    changed = (kv.k != before).flatten(3).any(-1)       # (R, B, alloc)
    assert changed[:, :, 6].all() and not changed[:, :, :6].any()
    assert not changed[:, :, 7].any()


def test_module_matches_functional():
    _jcfg, tcfg, _jparams, tparams, _ = _model("deepseek-7b")
    m = lm.LanguageModel(tcfg, tparams, device="cpu")
    toks = torch.from_numpy(_tokens(13, (2, 7))).long()
    with torch.no_grad():
        a, cache = m.prefill(toks, alloc=9)
        b, want_cache = lm.prefill(tparams, toks, tcfg, alloc=9)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        lengths = torch.full((2,), 7, dtype=torch.int32)
        a, _ = m.decode_step(cache, toks[:, :1], lengths)
        b, _ = lm.decode_step(tparams, want_cache, toks[:, :1], lengths,
                              tcfg)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert m.greedy(toks, 3).tolist() == lm.greedy(tparams, toks, tcfg,
                                                       3).tolist()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_cache_and_tree_match_jax(arch):
    """init_cache's KV leaves and init_lm's tree: the JAX package's keys,
    shapes and dtypes; init_cache needs ``alloc`` for attention."""
    jcfg, tcfg = ARCHS[arch].reduced(), get_reduced(arch)
    jc = jlm.init_cache(jcfg, 3, 16, jnp.bfloat16)
    tc = lm.init_cache(tcfg, 3, 16, device="cpu")
    for t, j in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()
    with pytest.raises(ValueError, match="alloc"):
        lm.init_cache(tcfg, 3, device="cpu")
    jtree, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    ttree = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_from_jax_params_dense_tree(arch):
    """The dense tree crosses leaf for leaf (bf16 kept bf16); a tree of
    another width, depth, vocab or head layout is refused."""
    jcfg, cfg = ARCHS[arch].reduced(), get_reduced(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg)[0])
    out = from_jax_params(tree, cfg, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(out)[0]}
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    for bad, match in (({"n_layers": 3}, "wants"), ({"d_model": 32}, "embed"),
                       ({"vocab": 300}, "embed"),
                       ({"n_kv_heads": 2 if cfg.n_kv_heads == 1 else 1},
                        "wqkv")):
        with pytest.raises(ValueError, match=match):
            from_jax_params(tree, dataclasses.replace(cfg, **bad),
                            device="cpu")


def test_configs_match_jax():
    for arch, mod in {**ARCHS, "gemma3-27b": gemma3_27b,
                      "whisper-base": whisper_base}.items():
        for mine, theirs in ((get_config(arch), mod.CONFIG),
                             (get_reduced(arch), mod.reduced())):
            assert mine == type(mine)(**dataclasses.asdict(theirs))
            assert mine.param_counts() == theirs.param_counts()
            assert [dataclasses.asdict(s) for s in mine.stages()] == [
                dataclasses.asdict(s) for s in theirs.stages()]
            if mine.encdec:
                assert [dataclasses.asdict(s) for s in mine.enc_stages()] == [
                    dataclasses.asdict(s) for s in theirs.enc_stages()]
    assert lm.padded_vocab(get_config("internlm2-20b")) == 92672


def test_unported_attention_paths_raise():
    """What the port does not run yet raises, naming its ROADMAP.md item:
    paged pools, the chunked-prefill and speculative-verify modes,
    M-RoPE, and the MoE and mamba2 architectures of the registry."""
    cfg = get_reduced("deepseek-7b")
    x = torch.zeros(1, 4, 1, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention.chunked_attention(x, x, x, pages=torch.zeros(1, 1))
    for mode in ("chunk", "verify"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            blocks.apply_block(cfg.stages()[0].body[0], {}, x, cfg=cfg,
                               mode=mode)
    mrope = dataclasses.replace(cfg, rope="mrope")
    q = torch.zeros(1, 3, 4, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention._apply_rope(q, q, mrope, torch.zeros(1, 3))
    for arch in ("qwen2-vl-2b", "phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b",
                 "zamba2-1.2b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_config(arch)
    for kind in ("moe", "mamba2"):
        blk = dataclasses.replace(cfg.stages()[0].body[0],
                                  **({"ffn": kind} if kind == "moe"
                                     else {"mixer": kind}))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            blocks.init_block(torch.Generator(), blk, cfg, None,
                              torch.float32, "cpu")
