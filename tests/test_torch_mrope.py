"""The port's qwen2-vl (M-RoPE and the vision-embeds splice) against the
JAX package's, on CPU.

At ``reduced()`` size (qwen2-vl-smoke: 2 layers, d 64, GQA 4 over 2,
head dim 16, sections 2/3/3). Weights come from the JAX initializer
with the norm gains jittered in numpy; patch embeddings, tokens and the
(t, h, w) grid from numpy seeds; both packages get the same arrays.
Tolerances, each with its reason:

* M-RoPE at positions up to 600: rtol 0, atol 2e-4, as RoPE's (each
  framework's fp32 pow may differ in the last bit of a frequency, so an
  angle p * f may differ by p ulps of f);
* text positions through M-RoPE against RoPE: bitwise (the same angles);
* forward, prefill and decode logits and caches: rtol = atol = 2e-4,
  the JAX package's prefill/decode-vs-forward tolerance;
* greedy streams: exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import manual_greedy

from repro.configs import qwen2_vl as jconfigs
from repro.core import runtime as jruntime
from repro.models import lm as jlm
from repro.models import rope as jrope
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import attention, lm, rope

ARCH = "qwen2-vl-2b"
TOL = dict(rtol=2e-4, atol=2e-4)
ROPE_TOL = dict(rtol=0, atol=2e-4)
N_PATCHES = 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(port, want, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _vision(seed, b, s, d=64):
    """``N_PATCHES`` patch embeddings on a (t=0, h, w) 2 x 3 grid, then
    text rows at t = h = w = their index."""
    rng = np.random.default_rng(seed)
    ve = rng.standard_normal((b, N_PATCHES, d)).astype(np.float32)
    p3 = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                         (3, b, s)).copy()
    p3[0, :, :N_PATCHES] = 0
    p3[1, :, :N_PATCHES] = np.arange(N_PATCHES) // 3
    p3[2, :, :N_PATCHES] = np.arange(N_PATCHES) % 3
    return {"vis_embeds": ve, "positions3": p3}


def _both(extra):
    return ({k: jnp.asarray(v) for k, v in extra.items()},
            {k: torch.from_numpy(v) for k, v in extra.items()})


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.reduced()
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(1)

    def jit(path, leaf):
        a = np.asarray(leaf)
        if path[-1].key == "g":
            return a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    tree = jax.tree_util.tree_map_with_path(
        jit, jax.tree_util.tree_map(np.asarray, params))
    return (jcfg, get_reduced(ARCH),
            jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, get_reduced(ARCH), device="cpu"))


@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_jax(hd):
    """``apply_mrope`` on (t, h, w) streams up to 600, in fp32 and bf16,
    and the sections (16/24/24 at hd 128)."""
    assert rope.mrope_sections(hd) == jrope.mrope_sections(hd)
    assert rope.mrope_sections(128) == (16, 24, 24)
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    p3 = rng.integers(0, 600, (3, 2, 7)).astype(np.int32)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(p3))
    got = rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3))
    _close(got, want, ROPE_TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got16 = rope.apply_mrope(xb, torch.from_numpy(p3))
    assert got16.dtype == torch.bfloat16
    want16 = jrope.apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p3))
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16, np.float32), rtol=0,
                               atol=3e-2)


def test_text_positions_reduce_to_rope():
    """Text positions (t = h = w) rotate exactly as 1-D RoPE; and the
    attention layer turns (B, S) positions into them."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 16)).astype(
        np.float32))
    pos = torch.from_numpy(rng.integers(0, 600, (2, 9)))
    p3 = rope.text_positions3(pos)
    assert tuple(p3.shape) == (3, 2, 9)
    np.testing.assert_array_equal(
        p3.numpy(), np.asarray(jrope.text_positions3(jnp.asarray(
            pos.numpy()))))
    torch.testing.assert_close(rope.apply_mrope(x, p3),
                               rope.apply_rope(x, pos), rtol=0, atol=0)
    cfg = get_reduced(ARCH)
    q, k = attention._apply_rope(x, x[:, :, :2], cfg, pos)
    torch.testing.assert_close(q, rope.apply_rope(x, pos), rtol=0, atol=0)
    q3, _ = attention._apply_rope(x, x[:, :, :2], cfg, p3)
    torch.testing.assert_close(q3, q, rtol=0, atol=0)


def test_forward_with_vision_matches_jax(model):
    """The forward with patch embeddings spliced over the first rows and
    their (t, h, w) positions, against JAX's plain path; without them,
    against JAX's text-only forward."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(7, (2, 20))
    jextra, textra = _both(_vision(8, 2, 20))
    with jruntime.use_impl("ref"):
        want, _ = jlm.forward(jparams, jnp.asarray(toks), jcfg,
                              extra=jextra, remat=False)
        text, _ = jlm.forward(jparams, jnp.asarray(toks), jcfg, remat=False)
    got, aux = lm.forward(tparams, torch.from_numpy(toks).long(), tcfg,
                          extra=textra)
    assert got.shape == (2, 20, 256) and float(aux) == 0.0
    _close(got, want)
    _close(lm.forward(tparams, torch.from_numpy(toks).long(), tcfg)[0], text)
    # the splice: the patch rows replace the token rows
    x = lm.embed(tparams, torch.from_numpy(toks).long(), tcfg, textra)
    torch.testing.assert_close(x[:, :N_PATCHES], textra["vis_embeds"],
                               rtol=0, atol=0)
    torch.testing.assert_close(x[:, N_PATCHES:], tparams["embed"][
        torch.from_numpy(toks).long()][:, N_PATCHES:], rtol=0, atol=0)


@pytest.mark.parametrize("jimpl", ["ref", "interpret"])
def test_prefill_and_decode_match_jax(model, jimpl):
    """Prefill with patch embeddings and ``positions3`` at S = 17 into a
    cache of 20, then three decode steps (which rotate by the sequence
    index, as JAX's do): logits and every KV leaf, against JAX's plain
    path and, for the prefill, its Pallas kernels in interpret mode."""
    jcfg, tcfg, jparams, tparams = model
    toks = _tokens(10, (2, 20))
    jextra, textra = _both(_vision(11, 2, 17))
    with jruntime.use_impl(jimpl):
        jlg, jcache = jlm.prefill(jparams, jnp.asarray(toks[:, :17]), jcfg,
                                  extra=jextra, alloc=20)
    tlg, tcache = lm.prefill(tparams, torch.from_numpy(toks[:, :17]).long(),
                             tcfg, extra=textra, alloc=20)
    _close(tlg, jlg)
    jl, tl = jax.tree_util.tree_leaves(jcache), _leaves(tcache)
    assert len(jl) == len(tl) == 2
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        _close(t, j)
    if jimpl == "interpret":
        return
    jlen = jnp.full((2,), 17, jnp.int32)
    tlen = torch.full((2,), 17, dtype=torch.int32)
    for t in range(17, 20):
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
        _close(t, j)


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


def test_configs_match_jax():
    """qwen2-vl-2b and its reduced config equal JAX's: fields, stages and
    ``param_counts`` (1,543,699,968 at full size); the vocab pads
    151936 to 152064."""
    for mine, theirs in ((get_config(ARCH), jconfigs.CONFIG),
                         (get_reduced(ARCH), jconfigs.reduced())):
        assert mine == type(mine)(**dataclasses.asdict(theirs))
        assert mine.param_counts() == theirs.param_counts()
        assert [dataclasses.asdict(s) for s in mine.stages()] == [
            dataclasses.asdict(s) for s in theirs.stages()]
    assert get_config(ARCH).param_counts()["total"] == 1_543_699_968
    assert lm.padded_vocab(get_config(ARCH)) == 152064
