"""The port's encoder-decoder path (whisper-base) against the JAX
package's on CPU, and the norm-prologue dispatch of ``ops``.

At whisper-base's ``reduced()`` size: 2 encoder and 2 decoder layers,
d 64, 4 heads of 16, GELU MLP, LayerNorm with beta, tied head, frames
of 30 (``cross_len``), sinusoidal positions. Weights come from the JAX
initializer with the norm gains and biases jittered in numpy; frames
and tokens from numpy seeds; both packages get the same arrays.
Tolerances: rtol = atol = 2e-4 (the JAX package's prefill/decode
tolerance: only the order of fp32 sums differs); greedy streams and the
split and fused plain routes exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_base
from repro.core import runtime as jruntime
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import runtime
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rowwise_matmul as rm
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.models import attention, lm

TOL = dict(rtol=2e-4, atol=2e-4)


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


def _frames(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, 30, 64)).astype(np.float32)


def _leaves(tree):
    """Tensor leaves in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


_MODEL = {}


def _model():
    """(jcfg, tcfg, jparams, tparams, numpy tree) of whisper-smoke, the
    norm gains and biases jittered by 0.1, built once per module."""
    if not _MODEL:
        jcfg, tcfg = whisper_base.reduced(), get_reduced("whisper-base")
        params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg,
                                dtype=jnp.float32)
        rng = np.random.default_rng(1)

        def jit(path, leaf):
            a = np.asarray(leaf)
            if path[-1].key in ("g", "b"):
                a = a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
            return a
        tree = jax.tree_util.tree_map_with_path(jit, params)
        _MODEL["m"] = (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                       from_jax_params(tree, tcfg, device="cpu"), tree)
    return _MODEL["m"]


@pytest.fixture(scope="module", autouse=True)
def _drop_model():
    yield
    _MODEL.clear()


def _both(frames):
    return ({"frames": jnp.asarray(frames)}, {"frames": _t(frames)})


# ------------------------------ the layers -----------------------------


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_cross_attention_apply_matches_jax(fuse):
    """``attention.apply(kv=(enc, enc))``: q from ``wq``, k and v from the
    fused ``wkv`` panel (one launch fused, its halves apart when not),
    non-causal over 30 frames from 13 queries; its output and the cross
    k/v heads prefill caches."""
    jcfg, tcfg, jparams, tparams, _ = _model()
    jc = jax.tree_util.tree_map(lambda a: a[1], jparams["stages"][0][
        "stacked"]["0"]["cross"])
    tc = lm._tree_map(lambda a: a[1], tparams["stages"][0]["stacked"]["0"][
        "cross"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 13, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 30, 64)).astype(np.float32)
    je, te = jnp.asarray(enc), _t(enc)
    with jruntime.use_impl("ref"), jruntime.use_pipeline_fusion(fuse):
        jout, (jk, jv) = jattn.apply(jc, jnp.asarray(x), cfg=jcfg,
                                     positions=None, causal=False,
                                     kv=(je, je))
    with runtime.use_pipeline_fusion(fuse):
        tout, (tk, tv) = attention.apply(tc, _t(x), cfg=tcfg, positions=None,
                                         causal=False, kv=(te, te))
    assert tuple(tk.shape) == (2, 30, 4, 16)
    for t, j in ((tout, jout), (tk, jk), (tv, jv)):
        _close(t, j)
    with pytest.raises(ValueError, match="one"):
        attention.apply(tc, _t(x), cfg=tcfg, positions=None, causal=False,
                        kv=(te, te.clone()))


@pytest.mark.parametrize("jimpl", ["ref", "interpret"])
def test_encode_matches_jax(jimpl):
    """The encoder: sinusoidal positions, its stages (windowless; causal
    self-attention, as the JAX block runs it), the final LayerNorm;
    against JAX's plain path and its Pallas kernels in interpret mode."""
    jcfg, tcfg, jparams, tparams, _ = _model()
    frames = _frames(3, 2)
    with jruntime.use_impl(jimpl):
        want = jlm.encode(jparams, jnp.asarray(frames), jcfg)
    got = lm.encode(tparams, _t(frames), tcfg)
    assert tuple(got.shape) == (2, 30, 64)
    _close(got, want)


# ------------------------------ the LM ---------------------------------


def test_forward_matches_jax():
    jcfg, tcfg, jparams, tparams, _ = _model()
    toks, frames = _tokens(4, (2, 11)), _frames(4, 2)
    jx, tx = _both(frames)
    with jruntime.use_impl("ref"):
        want, _ = jlm.forward(jparams, jnp.asarray(toks), jcfg, extra=jx,
                              remat=False)
    got, _ = lm.forward(tparams, torch.from_numpy(toks).long(), tcfg,
                        extra=tx)
    _close(got, want)
    with pytest.raises(ValueError, match="frames"):
        lm.forward(tparams, torch.from_numpy(toks).long(), tcfg)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("jimpl", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(jimpl, fuse):
    """Prefill of 13 tokens with frames into a cache of alloc = 16, then
    three decode steps: logits and every cache leaf (the self KV and the
    ``cross_kv`` heads), against JAX's plain path and, for the prefill,
    its Pallas kernels in interpret mode; fused or per op on both
    sides."""
    jcfg, tcfg, jparams, tparams, _ = _model()
    toks, frames = _tokens(5, (2, 16)), _frames(5, 2)
    jx, tx = _both(frames)
    with jruntime.use_impl(jimpl), jruntime.use_pipeline_fusion(fuse):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :13]), jcfg,
                                  extra=jx, alloc=16)
    with runtime.use_pipeline_fusion(fuse):
        tlg, tcache = lm.prefill(tparams,
                                 torch.from_numpy(toks[:, :13]).long(), tcfg,
                                 extra=tx, alloc=16)
    _close(tlg, jlg)
    assert sorted(tcache[0]["0"]) == sorted(jcache[0]["0"]) == [
        "cross_kv", "kv"]
    jl, tl = jax.tree_util.tree_leaves(jcache), _leaves(tcache)
    assert len(jl) == len(tl) == 4
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    assert tuple(tcache[0]["0"]["cross_kv"][0].shape) == (2, 2, 30, 4, 16)
    if jimpl == "interpret":
        return
    jlen = jnp.full((2,), 13, jnp.int32)
    tlen = torch.full((2,), 13, dtype=torch.int32)
    for t in range(13, 16):
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


def test_fused_matches_unfused():
    _jcfg, tcfg, _jparams, tparams, _ = _model()
    toks = torch.from_numpy(_tokens(6, (2, 9))).long()
    extra = {"frames": _t(_frames(6, 2))}
    fused, fcache = lm.prefill(tparams, toks, tcfg, extra=extra, alloc=10)
    with runtime.use_pipeline_fusion(False):
        unfused, ucache = lm.prefill(tparams, toks, tcfg, extra=extra,
                                     alloc=10)
    torch.testing.assert_close(unfused, fused, **TOL)
    lengths = torch.full((2,), 9, dtype=torch.int32)
    fused, _ = lm.decode_step(tparams, fcache, toks[:, :1], lengths, tcfg)
    with runtime.use_pipeline_fusion(False):
        unfused, _ = lm.decode_step(tparams, ucache, toks[:, :1], lengths,
                                    tcfg)
    torch.testing.assert_close(unfused, fused, **TOL)
    for f, u in zip(_leaves(fcache), _leaves(ucache)):
        torch.testing.assert_close(u, f, **TOL)


def _jax_greedy(jparams, jcfg, prompt, frames, n_new):
    """The JAX package's dense-cache greedy loop with frames: prefill
    into a cache of S + n_new, then n_new - 1 decode steps."""
    logits, cache = jlm.prefill(jparams, jnp.asarray(prompt[None]), jcfg,
                                extra={"frames": jnp.asarray(frames)},
                                alloc=prompt.shape[0] + n_new)
    toks = [int(jnp.argmax(logits[0]))]
    lengths = jnp.asarray([prompt.shape[0]], jnp.int32)
    for _ in range(n_new - 1):
        lg, cache = jlm.decode_step(jparams, cache,
                                    jnp.asarray([[toks[-1]]], jnp.int32),
                                    lengths, jcfg)
        toks.append(int(jnp.argmax(lg[0])))
        lengths = lengths + 1
    return toks


@pytest.mark.parametrize("s", [5, 16])
def test_greedy_matches_jax_loop(s):
    jcfg, tcfg, jparams, tparams, _ = _model()
    prompt, frames = _tokens(200 + s, (s,)), _frames(200 + s, 1)
    with jruntime.use_impl("ref"):
        want = _jax_greedy(jparams, jcfg, prompt, frames, 12)
    module = lm.LanguageModel(tcfg, tparams, device="cpu")
    got = module.greedy(torch.from_numpy(prompt).long()[None], 12,
                        extra={"frames": _t(frames)})
    assert got[0].tolist() == want


def test_init_cache_and_tree_match_jax():
    """init_cache's self and cross KV leaves and init_lm's tree (the
    ``enc`` stages and final norm, ``norm_x`` and ``cross`` {wq, wkv,
    wo}): the JAX package's keys, shapes and dtypes."""
    jcfg, tcfg = whisper_base.reduced(), get_reduced("whisper-base")
    jc = jlm.init_cache(jcfg, 3, 16, jnp.float32)
    tc = lm.init_cache(tcfg, 3, 16, dtype=torch.float32, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jc), _leaves(tc)
    assert len(jl) == len(tl) == 4
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape and not t.any()
    jtree, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    ttree = lm.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(ttree)[0]}
    assert len(jleaves) == len(tleaves) and "enc" in ttree
    for path, leaf in jleaves:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


def test_from_jax_params_checks_the_encoder_and_cross_leaves():
    """The encoder-decoder tree crosses leaf for leaf; a tree with
    another encoder depth, cross-attention head layout or width, or with
    no encoder, is refused."""
    _jcfg, cfg, _jparams, _tparams, tree = _model()
    out = from_jax_params(tree, cfg, device="cpu")
    assert len(_leaves(out)) == len(jax.tree_util.tree_leaves(tree))
    for bad, match in (({"n_enc_layers": 3}, "encoder stage 0"),
                       ({"n_heads": 2}, "wqkv"),
                       ({"n_kv_heads": 2}, "wqkv"),
                       ({"d_model": 32}, "embed")):
        with pytest.raises(ValueError, match=match):
            from_jax_params(tree, dataclasses.replace(cfg, **bad),
                            device="cpu")
    # the decoder's cross leaves alone narrowed: their widths are checked
    narrow = jax.tree_util.tree_map(lambda a: a, tree)
    cross = narrow["stages"][0]["stacked"]["0"]["cross"]
    for name in ("wq", "wkv"):
        saved = cross[name]
        cross[name] = saved[..., :-16]
        with pytest.raises(ValueError, match=name):
            from_jax_params(narrow, cfg, device="cpu")
        cross[name] = saved
    no_enc = {k: v for k, v in tree.items() if k != "enc"}
    with pytest.raises(ValueError, match="no encoder"):
        from_jax_params(no_enc, cfg, device="cpu")


# -------------------- the norm-prologue dispatch -----------------------


# (design, dtype, rows that pick it) of every matmul design of a float
# dtype
DESIGNS = [("skinny", torch.float32, 2), ("skinny", torch.bfloat16, 2),
           ("ffma", torch.float32, 64), ("wgmma", torch.bfloat16, 64)]


def test_norm_prologue_thresholds():
    """The skinny design keeps the prologue up to SKINNY_NORM_MAX_K; the
    designs of many rows, whose prologue lost to the split at every K
    measured (PERF.md), never keep it."""
    for design, dtype, rows in DESIGNS:
        assert rm.pick_design(rows, dtype, 24, 96, prologue=True) == design
        for k in (1, rm.SKINNY_NORM_MAX_K):
            assert rm.norm_prologue_fits(rows, k, dtype) == (
                design == "skinny")
        assert not rm.norm_prologue_fits(rows, rm.SKINNY_NORM_MAX_K + 1,
                                         dtype)


@pytest.mark.parametrize("side", ["at", "past"])
@pytest.mark.parametrize("design,dtype,rows", DESIGNS,
                         ids=lambda v: str(v).split(".")[-1])
def test_norm_prologue_routes(monkeypatch, design, dtype, rows, side):
    """On the kernel path (here a tensor on the meta device, the kernels
    recorded, not run) ``ops.matmul``, ``qkv_proj`` and ``gate_up_proj``
    keep the norm in the prologue on the skinny design at its threshold,
    and run ``layernorm_p`` then a prologue-free matmul past it and on
    the other designs at any K; a CPU tensor and ``impl="ref"`` never
    split."""
    monkeypatch.setattr(rm, "SKINNY_NORM_MAX_K", 96)
    k = 96 if side == "at" else 97
    calls = []

    def fake_norm(x, gamma, beta, *, eps, kind):
        calls.append(("layernorm_p", kind, tuple(x.shape)))
        return torch.empty_like(x)

    def fake_matmul(x, w, *, prologue, **kw):
        calls.append(("rowwise_matmul_p", prologue, tuple(x.shape)))
        return x.new_empty((x.shape[0], w.shape[1]))
    monkeypatch.setattr(ops, "layernorm_p", fake_norm)
    monkeypatch.setattr(ops, "rowwise_matmul_p", fake_matmul)
    x = torch.empty(1, rows, k, dtype=dtype, device="meta")
    w = torch.empty(k, 24, dtype=dtype, device="meta")
    norm = ops.NormSpec("layer", torch.empty(k, dtype=dtype, device="meta"),
                        torch.empty(k, dtype=dtype, device="meta"))
    want = ([("rowwise_matmul_p", "layer", (rows, k))]
            if side == "at" and design == "skinny" else
            [("layernorm_p", "layer", (rows, k)),
             ("rowwise_matmul_p", None, (rows, k))])
    for fn in (lambda t, wt: ops.matmul(t, wt, norm=norm),
               lambda t, wt: ops.qkv_proj(t, wt, (8, 8, 8), norm=norm),
               lambda t, wt: ops.gate_up_proj(t, wt, activation="gelu",
                                              norm=norm)):
        calls.clear()
        fn(x, w)
        assert calls == want
    # a CPU tensor takes the kernel wrapper (its plain version) whole
    calls.clear()
    ops.matmul(torch.zeros(rows, k, dtype=dtype), torch.zeros(k, 24,
                                                               dtype=dtype),
               norm=ops.NormSpec("rms", torch.ones(k, dtype=dtype)))
    assert calls == [("rowwise_matmul_p", "rms", (rows, k))]
    calls.clear()
    ops.matmul(torch.zeros(rows, k, dtype=dtype),
               torch.zeros(k, 24, dtype=dtype),
               norm=ops.NormSpec("rms", torch.ones(k, dtype=dtype)),
               impl="ref")
    assert calls == []


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_split_plain_route_equals_fused(dtype, kind, gated):
    """The split route (the norm's plain version, cast to the streaming
    dtype, then the pipeline without a prologue) gives the fused plain
    pipeline's bits: the normed panel is cast before the dot in both."""
    g = torch.Generator().manual_seed(13)
    k, n = 700, 96

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dtype)
    x, w = r(33, k), r(k, n, scale=k ** -0.5)
    gamma, beta = 1 + r(k, scale=0.1), r(k, scale=0.1)
    beta = beta if kind == "layer" else None
    kw = dict(bias=r(n, scale=0.1), activation="gelu",
              w_gate=r(k, n, scale=k ** -0.5) if gated else None)
    fused = ref.pipeline_ref(x, w, norm_kind=kind, gamma=gamma, beta=beta,
                             **kw)
    split = ref.pipeline_ref(
        ref.layernorm_ref(x, gamma, beta, kind=kind), w, **kw)
    assert torch.equal(fused, split)
    # the wrappers on CPU tensors: their plain versions, the same bits
    wrapped = rowwise_matmul_p(layernorm_p(x, gamma, beta, kind=kind), w,
                               **kw)
    assert torch.equal(wrapped, fused)
