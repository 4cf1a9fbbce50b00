"""The port's training path against the JAX package's, on CPU.

``lm.loss_fn`` (value, metrics and the gradient of every parameter) at
the ``reduced()`` sizes of eight archs; the chunked attention's flash
backward past ``DENSE_MAX_SEQ``; the one ``autograd.Function`` that
makes the kernel path differentiable (``ops.KernelOp``), with the
kernels replaced by their plain versions; AdamW and its schedule; the
train step (microbatches, remat, the NaN guard) on the JAX package's
``tests/test_system.py`` model. Weights come from the JAX initializer
(norm gains and biases jittered in numpy), inputs from numpy seeds; both
packages get the same arrays. Tolerances, each with its reason:

* the loss and the metrics: rtol = atol = 2e-6 (fp32; only the order of
  the sums differs);
* each gradient leaf: max|port - JAX| <= 1e-4 x max|JAX| over the leaf
  (fp32 sums in another order, through up to 5 layers and their
  backward; every leaf measured within 6e-6 of its scale);
* the flash backward: rtol = atol = 2e-5 (one attention, fp32);
* the Function's gradients against the plain path's: bitwise where the
  backward is the plain version's own gradient, 2e-5 where attention
  takes the flash backward (the same function, summed in chunks);
* AdamW, the schedule, three train steps: rtol = atol = 2e-5 (each
  framework's fp32 ``pow``, ``sqrt`` and ``cos``; three steps of lr
  1e-3 keep the differences at that level);
* the NaN guard: bitwise.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core import runtime as jruntime
from repro.core.types import ModelConfig as JModelConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.configs import get_reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import runtime, trace
from repro_torch.core import tree as tree_lib
from repro_torch.core.types import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.kernels.wkv import wkv_p
from repro_torch.models import attention, lm, rwkv6
from repro_torch.optim import adamw
from repro_torch.train import step as tsl

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=2e-6, atol=2e-6)
GRAD_TOL = 1e-4
TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["deepseek-7b", "gemma3-27b", "granite-20b", "qwen2-vl-2b",
         "rwkv6-3b", "zamba2-1.2b", "qwen2-moe-a2.7b", "whisper-base"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jitter(tree, seed):
    """The norm gains and biases (constant at init) spread by 0.1."""
    rng = np.random.default_rng(seed)

    def jit(path, leaf):
        a = np.asarray(leaf)
        if getattr(path[-1], "key", None) in ("g", "b"):
            return a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(jit, tree)


def _numpy_tree(jcfg, seed=0):
    params, _ = jlm.init_lm(jax.random.PRNGKey(seed), jcfg,
                            dtype=jnp.float32)
    return jitter(jax.tree_util.tree_map(np.asarray, params), 1)


def _batch(jcfg, seed, b=2, s=24):
    """Tokens and labels (the first three of row 0 masked); a vision
    arch's 6 patch rows (labels -1) on a (t=0, h, w) 2 x 3 grid, text
    rows t = h = w = their index; an encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32),
             "labels": labels}
    if jcfg.frontend == "vision":
        n = 6
        batch["vis_embeds"] = rng.standard_normal(
            (b, n, jcfg.d_model)).astype(np.float32)
        p3 = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                             (3, b, s)).copy()
        p3[0, :, :n] = 0
        p3[1, :, :n] = np.arange(n) // 3
        p3[2, :, :n] = np.arange(n) % 3
        batch["positions3"] = p3
        labels[:, :n] = -1
    if jcfg.encdec:
        batch["frames"] = rng.standard_normal(
            (b, jcfg.cross_len, jcfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        out[k] = out[k].long()
    return out


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_grads(port_leaves, jax_leaves_with_paths):
    assert len(port_leaves) == len(jax_leaves_with_paths)
    for g, (path, want) in zip(port_leaves, jax_leaves_with_paths):
        want = np.asarray(want)
        got = np.zeros_like(want) if g is None else g.detach().numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err,
                                         scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``lm.loss_fn``'s value, metrics and the gradient of every leaf
    (remat on) against ``jax.value_and_grad(lm.loss_fn)`` on the same
    weights and batch: masked labels; qwen2-vl's patch embeddings and
    (t, h, w) positions (the gradient reaches ``vis_embeds``); the MoE
    aux loss with capacity drops; whisper's frames."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    tree = _numpy_tree(jcfg)
    batch = _batch(jcfg, 3)
    with jruntime.use_impl("ref"):
        (jloss, jmetrics), (jg, jgb) = jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, b, jcfg), argnums=(0, 1),
            has_aux=True, allow_int=True)(_jax_tree(tree), _jax_tree(batch))
    params = from_jax_params(tree, cfg, device="cpu")
    flat = [t.requires_grad_(True) for t in tree_lib.leaves(params)]
    tb = _torch_batch(batch)
    wrt = list(flat)
    if "vis_embeds" in tb:
        wrt.append(tb["vis_embeds"].requires_grad_(True))
    loss, metrics = lm.loss_fn(params, tb, cfg)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]),
                                   **LOSS_TOL)
    _assert_grads(grads[:len(flat)], jax.tree_util.tree_leaves_with_path(jg))
    if "vis_embeds" in tb:
        assert float(grads[-1].abs().max()) > 0
        _assert_grads([grads[-1]], [(("vis_embeds",),
                                     jgb["vis_embeds"])])


def test_pad_columns_get_no_gradient():
    """The tied head's pad columns (vocab 250 padded to 256) are filled
    in place with -1e30 after the matmul: they get a zero gradient, as
    JAX's ``jnp.where`` gives, and the real rows' gradient is JAX's."""
    jcfg = dataclasses.replace(jget_reduced("granite-20b"), vocab=250)
    cfg = dataclasses.replace(get_reduced("granite-20b"), vocab=250)
    tree = _numpy_tree(jcfg)
    batch = _batch(jcfg, 4)
    with jruntime.use_impl("ref"):
        jg = jax.grad(lambda p: jlm.loss_fn(p, _jax_tree(batch), jcfg)[0])(
            _jax_tree(tree))
    params = from_jax_params(tree, cfg, device="cpu")
    emb = params["embed"].requires_grad_(True)
    loss, _ = lm.loss_fn(params, _torch_batch(batch), cfg)
    (g,) = torch.autograd.grad(loss, [emb])
    assert g.shape[0] == 256 and torch.equal(g[250:], torch.zeros_like(
        g[250:]))
    _assert_grads([g], [(("embed",), jg["embed"])])


@pytest.mark.parametrize("hq,hkv,window", [(4, 2, 0), (6, 1, 700),
                                           (4, 4, 0)])
def test_chunked_attention_grads_match_jax(hq, hkv, window):
    """Past ``DENSE_MAX_SEQ`` (S = 2100: three chunks of 1024, the last
    ragged) the train path's chunked scan differentiates through the
    flash backward, against JAX's custom VJP: causal, GQA groups 2 and
    6 and MHA, with and without a window."""
    rng = np.random.default_rng(hq * 10 + window)
    s, hd = 2100, 16
    q = rng.standard_normal((1, hq, s, hd)).astype(np.float32)
    k = rng.standard_normal((1, hkv, s, hd)).astype(np.float32)
    v = rng.standard_normal((1, hkv, s, hd)).astype(np.float32)
    do = rng.standard_normal((1, hq, s, hd)).astype(np.float32)

    def jloss(q, k, v):
        out = jattn.chunked_attention(q, k, v, causal=True, window=window)
        return jnp.sum(out * do)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = attention.chunked_attention(tq, tk, tv, causal=True,
                                      window=window)
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(),
                                [tq, tk, tv])
    for g, want in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)
    # the kernel path's attention backward is the same flash backward
    dq, dk, dv = attention.flash_backward(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(do),
        causal=True, window=window, q_offset=0)
    for g, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


# ----------------------- the Function's wiring --------------------------


@pytest.fixture
def kernel_branch(monkeypatch):
    """The kernel branch forced on CPU tensors: ``ops.kernel_path`` true,
    each launcher replaced by a fake that refuses a tensor wanting a
    gradient (as the real one does), runs its plain version and notes a
    launch of its kernel in the port's trace, which records throughout."""
    monkeypatch.setattr(ops, "kernel_path", lambda x: True)
    monkeypatch.setattr(ops, "norm_prologue_fits",
                        lambda m, k, dt: k <= 32)

    def fake(kernel, plain):
        def run(*args, **kw):
            tensors = [a for a in (*args, *kw.values())
                       if isinstance(a, torch.Tensor)]
            if torch.is_grad_enabled() and any(t.requires_grad
                                               for t in tensors):
                raise NotImplementedError("the kernel has no backward")
            trace.note(kernel, "fake", {}, torch.device("cuda"))
            return plain(*args, **kw)
        return run

    def plain_matmul(x, w, *, prologue=None, pbeta=None, **kw):
        return ref.pipeline_ref(x, w, norm_kind=prologue, beta=pbeta, **kw)

    def plain_wkv(r, k, v, lw, u, *, s0=None, chunk=16):
        y, s_fin = rwkv6.wkv_chunked(r, k, v, lw, u, chunk=chunk, s0=s0)
        return y.to(r.dtype), s_fin
    monkeypatch.setattr(ops, "rowwise_matmul_p",
                        fake("rowwise_matmul", plain_matmul))
    monkeypatch.setattr(ops, "layernorm_p",
                        fake("layernorm", ref.layernorm_ref))
    monkeypatch.setattr(ops, "flash_attention_p",
                        fake("flash_attention", ref.attention_ref))
    monkeypatch.setattr(ops, "wkv_p", fake("wkv", plain_wkv))
    with trace.recording():
        yield


def _counts():
    return trace.launches("rowwise_matmul"), trace.launches("layernorm")


def _leaves_grad(seed, *shapes, scale=0.3):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(*s, generator=g) * scale).requires_grad_(True)
            for s in shapes]


def _grads_both_ways(call, inputs):
    """The gradients of sum(call() * r) with respect to ``inputs`` on the
    kernel branch and under ``use_impl("ref")``."""
    out = call()
    outs = out if isinstance(out, tuple) else (out,)
    g = torch.Generator().manual_seed(99)
    rs = [torch.randn(o.shape, generator=g) for o in outs]

    def loss(outs):
        return sum((o.float() * r).sum() for o, r in zip(outs, rs))
    got = torch.autograd.grad(loss(outs), inputs)
    with runtime.use_impl("ref"):
        out = call()
        want = torch.autograd.grad(
            loss(out if isinstance(out, tuple) else (out,)), inputs)
    return got, want


@pytest.mark.parametrize("k", [32, 48], ids=["prologue", "split"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_function_matmul_grads(kernel_branch, kind, k):
    """``ops.matmul`` with bias, residual and a pre-norm (in the
    prologue at K = 32, split into ``layernorm_p`` + matmul at K = 48),
    and ``ops.gate_up_proj`` over one ``wgi`` leaf (its halves are views:
    their gradients sum into it), silu and gelu: every input's gradient
    on the kernel branch equals the plain path's, bitwise."""
    x, w, bias, res, gamma, beta, wgi, bgi = _leaves_grad(
        0, (3, 5, k), (k, 24), (24,), (3, 5, 24), (k,), (k,), (k, 48), (48,))
    beta = beta if kind == "layer" else None
    norm = ops.NormSpec(kind, gamma, beta)
    ins = [t for t in (x, w, bias, res, gamma, beta) if t is not None]
    before = _counts()
    got, want = _grads_both_ways(
        lambda: ops.matmul(x, w, bias=bias, residual=res, norm=norm), ins)
    assert _counts() == (before[0] + 1, before[1] + (k > 32))
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)
    assert all(float(g.abs().max()) > 0 for g in got)
    for act in ("silu", "gelu"):
        ins = [t for t in (x, wgi, bgi, gamma, beta) if t is not None]
        got, want = _grads_both_ways(lambda: ops.gate_up_proj(
            x, wgi, activation=act, bias=bgi, norm=norm), ins)
        for g, wnt in zip(got, want):
            torch.testing.assert_close(g, wnt, rtol=0, atol=0)
        # both halves of the panel and of its bias got a gradient
        for t in got[1:3]:
            assert float(t[..., :24].abs().max()) > 0
            assert float(t[..., 24:].abs().max()) > 0


def test_function_counts_launches(kernel_branch):
    """Each op through the Function launches its kernel once in the
    forward (the norm too where it splits) and none in the backward."""
    x, w, gamma = _leaves_grad(1, (4, 48), (48, 8), (48,))
    before = _counts()
    out = ops.matmul(x, w, norm=ops.NormSpec("rms", gamma))
    mid = _counts()
    out.sum().backward()
    after = _counts()
    assert mid == (before[0] + 1, before[1] + 1)
    assert after == mid
    assert all(t.grad is not None for t in (x, w, gamma))
    # without a gradient the launch path is the plain call's
    with torch.no_grad():
        ops.matmul(x, w, norm=ops.NormSpec("rms", gamma))
    assert _counts() == (mid[0] + 1, mid[1] + 1)


@pytest.mark.parametrize("bias", [False, True], ids=["flash", "bias"])
def test_function_attention_grads(kernel_branch, bias):
    """Attention at a group of 6, causal with a window: without a bias
    the backward is the flash backward (2e-5 of the plain gradient),
    with one the plain version's own (bitwise); the bias gets its
    gradient."""
    q, k, v, b = _leaves_grad(2, (2, 6, 40, 16), (2, 1, 40, 16),
                              (2, 1, 40, 16), (1, 6, 40, 40))
    ins = [q, k, v] + ([b] if bias else [])
    before = trace.launches("flash_attention")
    got, want = _grads_both_ways(lambda: ops.attention(
        q, k, v, causal=True, window=9, bias=b if bias else None), ins)
    assert trace.launches("flash_attention") == before + 1
    for g, wnt in zip(got, want):
        if bias:
            torch.testing.assert_close(g, wnt, rtol=0, atol=0)
        else:
            torch.testing.assert_close(g, wnt, **TOL)


def test_function_layernorm_and_wkv_grads(kernel_branch):
    """``ops.layernorm`` (LayerNorm with beta) and ``ops.wkv`` (r, k, v,
    the log decays ``lw`` and the bonus ``u``, and a starting state):
    every input's gradient equals the plain path's, bitwise."""
    x, gamma, beta = _leaves_grad(3, (3, 7, 32), (32,), (32,))
    got, want = _grads_both_ways(lambda: ops.layernorm(
        x, gamma, beta, kind="layer"), [x, gamma, beta])
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)
    r, k, v, u, s0 = _leaves_grad(4, (2, 20, 2, 16), (2, 20, 2, 16),
                                  (2, 20, 2, 16), (2, 16), (2, 2, 16, 16))
    lw = (-torch.rand(2, 20, 2, 16, generator=torch.Generator()
                      .manual_seed(5)) - 0.1).requires_grad_(True)
    before = trace.launches("wkv")
    ins = [r, k, v, lw, u, s0]
    got, want = _grads_both_ways(lambda: ops.wkv(r, k, v, lw, u, s0=s0),
                                 ins)
    assert trace.launches("wkv") == before + 1
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=0, atol=0)
        assert float(g.abs().max()) > 0


def test_raw_launchers_still_refuse_gradients():
    """The raw launchers refuse a tensor that wants a gradient; only the
    ops layer makes the kernel path differentiable."""
    m = torch.ones(4, 8, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        rowwise_matmul_p(m, torch.ones(8, 8, device="meta"))
    q = torch.ones(1, 2, 4, 16, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention_p(q, q, q)
    with pytest.raises(NotImplementedError, match="backward"):
        layernorm_p(m, torch.ones(8, device="meta"))
    r = torch.ones(1, 5, 2, 16, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        wkv_p(r, r, r, r, torch.ones(2, 16, device="meta"))


# ------------------------------ AdamW -----------------------------------


def _np_params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": [rng.standard_normal(7).astype(np.float32),
                  {"c": rng.standard_normal((2, 2)).astype(np.float32)}]}


def test_adamw_and_schedule_match_jax():
    """Three ``adamw.apply`` steps (the clip active on the second: its
    gradients are scaled past ``grad_clip``) and ``cosine_schedule``
    over warmup, decay and past the end, against JAX."""
    cfg = adamw.AdamWConfig(lr=1e-2)
    jcfg = jadamw.AdamWConfig(lr=1e-2)
    p = _np_params(0)
    jp, tp = _jax_tree(p), tree_lib.tree_map(torch.from_numpy,
                                             jax.tree_util.tree_map(
                                                 np.array, p))
    jst, tst = jadamw.init(jp), adamw.init(tp)
    for i in range(3):
        g = jax.tree_util.tree_map(
            lambda a: a * (30.0 if i == 1 else 0.5), _np_params(10 + i))
        sched = float(jadamw.cosine_schedule(jnp.int32(i), warmup=1,
                                             total=3))
        jp, jst, jn = jadamw.apply(jcfg, jst, jp, _jax_tree(g), sched)
        tp, tst, tn = adamw.apply(cfg, tst, tp, tree_lib.tree_map(
            torch.from_numpy, jax.tree_util.tree_map(np.array, g)), sched)
        np.testing.assert_allclose(float(tn), float(jn), **TOL)
        for a, b in zip(tree_lib.leaves((tp, tst.mu, tst.nu)),
                        jax.tree_util.tree_leaves((jp, jst.mu, jst.nu))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert int(tst.step) == int(jst.step) and tst.step.dtype == \
            torch.int32
    for step in (0, 1, 5, 50, 99, 100, 250):
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                        warmup=10, total=100)),
            float(jadamw.cosine_schedule(jnp.int32(step), warmup=10,
                                         total=100)), **TOL)


# ----------------------------- train step -------------------------------


def _tiny(jax_side):
    kw = dict(name="tiny", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab=64, act="silu",
              norm="rms")
    return JModelConfig(**kw) if jax_side else ModelConfig(**kw)


def _tiny_start():
    jcfg = _tiny(True)
    params, _ = jlm.init_lm(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tree, from_jax_params(tree, _tiny(False), device="cpu")


def _tiny_data(b=8, s=32):
    return JSyntheticLM(JDataConfig(vocab=64, seq_len=s, global_batch=b,
                                    seed=7))


@pytest.mark.parametrize("micro,remat", [(1, True), (2, False), (2, True)])
def test_train_steps_match_jax(micro, remat):
    """Three ``make_train_step`` steps on test_system.py's tiny model
    (warmup 2 of 20, lr 1e-3): the loss, ``grad_norm``, ``lr_scale``,
    ``skipped`` and every parameter and moment after each step against
    JAX's jitted step."""
    tree, params = _tiny_start()
    kw = dict(opt=jadamw.AdamWConfig(lr=1e-3), warmup_steps=2,
              total_steps=20, microbatches=micro, remat=remat)
    jt = jstep.TrainConfig(**kw)
    tt = tsl.TrainConfig(**{**kw, "opt": adamw.AdamWConfig(lr=1e-3)})
    jfn = jax.jit(jstep.make_train_step(_tiny(True), jt))
    tfn = tsl.make_train_step(_tiny(False), tt)
    jst = jstep.init_state(_jax_tree(tree), jt)
    tst = tsl.init_state(params, tt)
    ds = _tiny_data()
    with jruntime.use_impl("ref"):
        for i in range(3):
            batch = ds.batch(i)
            jst, jm = jfn(jst, _jax_tree(batch))
            tst, tm = tfn(tst, _torch_batch(batch))
            for k in ("loss", "grad_norm", "lr_scale", "skipped",
                      "accuracy", "ntokens"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           **TOL)
            for a, b in zip(tree_lib.leaves((tst.params, tst.opt.mu,
                                             tst.opt.nu)),
                            jax.tree_util.tree_leaves(
                                (jst.params, jst.opt.mu, jst.opt.nu))):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **TOL)
            assert int(tst.opt.step) == int(jst.opt.step) == i + 1
    assert not any(t.requires_grad for t in tree_lib.leaves(tst))


def test_nan_guard_skips_bad_step():
    """test_system.py's case: inf embeddings make the loss non-finite;
    the step is skipped and every parameter and moment is kept bit for
    bit (the step counter advances, as in JAX)."""
    _, params = _tiny_start()
    tcfg = tsl.TrainConfig(remat=False, skip_nonfinite=True)
    state = tsl.init_state(params, tcfg)
    step = tsl.make_train_step(_tiny(False), tcfg)
    good = _torch_batch(_tiny_data().batch(0))
    state1, m1 = step(state, good)
    assert float(m1["skipped"]) == 0.0
    bad_state = state1._replace(params={
        **state1.params, "embed": state1.params["embed"] * torch.inf})
    state2, m2 = step(bad_state, good)
    assert float(m2["skipped"]) == 1.0
    for a, b in zip(tree_lib.leaves((bad_state.params, bad_state.opt.mu,
                                     bad_state.opt.nu)),
                    tree_lib.leaves((state2.params, state2.opt.mu,
                                     state2.opt.nu))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(state2.opt.step) == 2


def test_loss_decreases():
    """test_system.py's case: 60 steps on the synthetic Markov stream
    (lr 3e-3, warmup 5, remat off) drop the mean loss of the last five
    steps at least 0.5 below the first five's."""
    _, params = _tiny_start()
    tcfg = tsl.TrainConfig(opt=adamw.AdamWConfig(lr=3e-3), warmup_steps=5,
                           total_steps=60, remat=False)
    state = tsl.init_state(params, tcfg)
    step = tsl.make_train_step(_tiny(False), tcfg)
    ds = _tiny_data()
    losses = []
    for i in range(60):
        state, metrics = step(state, _torch_batch(ds.batch(i)))
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.5, (first, last)


def test_compress_pods_raises():
    """Cross-pod compression reduces over a mesh's ``pod`` axis: without
    a mesh the step refuses it (no quiet single-device run); the state
    carries the fp32 error-feedback residual, zero, as JAX's does."""
    _, params = _tiny_start()
    tcfg = tsl.TrainConfig(compress_pods=True)
    with pytest.raises(ValueError, match="'pod' axis"):
        tsl.make_train_step(_tiny(False), tcfg)
    state = tsl.init_state(params, tcfg)
    assert [p for p, _ in tree_lib.leaves_with_paths(state.residual)] == [
        p for p, _ in tree_lib.leaves_with_paths(params)]
    assert all(r.dtype == torch.float32 and not r.any()
               for r in tree_lib.leaves(state.residual))


def test_training_modules_import_no_jax():
    """The training modules (optim, train, data, checkpoint, the train
    CLI) pull in nothing of JAX or of the JAX package."""
    code = ("import sys\n"
            "import repro_torch.optim.adamw, repro_torch.train.step, "
            "repro_torch.data.pipeline, "
            "repro_torch.checkpoint.checkpointer, "
            "repro_torch.launch.train, repro_torch.core.tree, "
            "repro_torch.configs.qwen2_vl\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
