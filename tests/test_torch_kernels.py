"""The port's kernel modules against the JAX package's kernels, on CPU.

On a CPU tensor each wrapper of ``repro_torch.kernels`` runs its plain
PyTorch version; here it is held against the JAX Pallas kernel in
interpret mode and against the JAX oracle, on the same numpy inputs, in
fp32 at rtol = atol = 2e-5 (only the order of fp32 sums differs).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import runtime as jruntime
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_p as jflash
from repro.kernels.layernorm import layernorm_p as jlayernorm
from repro.kernels.rowwise_matmul import rowwise_matmul_p as jmatmul
from repro_torch.core import runtime
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(rng, shape, scale=1.0, dtype=np.float32):
    return (rng.standard_normal(shape) * scale).astype(dtype)


def _close(port, want):
    np.testing.assert_allclose(np.asarray(port.float()),
                               np.asarray(want, np.float32), **TOL)


def _matmul_inputs(rng, m, k, n, *, bias=True, gated=False, residual=False,
                   norm=None, beta=True):
    d = {"x": _np(rng, (m, k)), "w": _np(rng, (k, n), k ** -0.5)}
    if bias:
        d["bias"] = _np(rng, (n,), 0.1)
    if gated:
        d["w_gate"] = _np(rng, (k, n), k ** -0.5)
        if bias:
            d["bias_gate"] = _np(rng, (n,), 0.1)
    if residual:
        d["residual"] = _np(rng, (m, n))
    if norm:
        d["gamma"] = 1 + _np(rng, (k,), 0.1)
        if beta:
            d["pbeta"] = _np(rng, (k,), 0.1)
    return d


MATMUL_CASES = {
    "plain": dict(m=32, k=64, n=48),
    "layer+beta": dict(m=24, k=96, n=64, norm="layer"),
    "layer": dict(m=24, k=96, n=64, norm="layer", beta=False),
    "rms+beta": dict(m=24, k=96, n=64, norm="rms"),
    "rms": dict(m=24, k=96, n=64, norm="rms", beta=False),
    "gelu": dict(m=16, k=64, n=80, act="gelu"),
    "silu": dict(m=16, k=64, n=80, act="silu"),
    "relu": dict(m=16, k=64, n=80, act="relu"),
    "relu2": dict(m=16, k=64, n=80, act="relu2"),
    "gated-silu": dict(m=16, k=64, n=80, act="silu", gated=True),
    "gated-gelu+rms": dict(m=16, k=64, n=80, act="gelu", gated=True,
                           norm="rms", beta=False),
    "residual": dict(m=49, k=64, n=64, residual=True),
    "ln+gelu+residual": dict(m=49, k=64, n=128, norm="layer", act="gelu",
                             residual=True),
    "ragged-k48": dict(m=49, k=48, n=32),
    "ragged-n1000": dict(m=8, k=64, n=1000),
    "nobias": dict(m=20, k=128, n=64, bias=False),
}


@pytest.mark.parametrize("case", list(MATMUL_CASES))
def test_matmul_matches_jax(case):
    kw = dict(MATMUL_CASES[case])
    m, k, n = kw.pop("m"), kw.pop("k"), kw.pop("n")
    act, norm = kw.pop("act", None), kw.get("norm")
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    d = _matmul_inputs(rng, m, k, n, **kw)
    opts = dict(activation=act, prologue=norm)
    port = rowwise_matmul_p(**{key: torch.from_numpy(v)
                               for key, v in d.items()}, **opts)
    jd = {key: jnp.asarray(v) for key, v in d.items()}
    want = jmatmul(**jd, **opts, interpret=True)
    oracle = jref.pipeline_ref(
        jd["x"], jd["w"], bias=jd.get("bias"), activation=act,
        w_gate=jd.get("w_gate"), bias_gate=jd.get("bias_gate"),
        residual=jd.get("residual"), norm_kind=norm, gamma=jd.get("gamma"),
        beta=jd.get("pbeta"))
    assert port.shape == (m, n) and port.dtype == torch.float32
    _close(port, want)
    _close(port, oracle)


def test_matmul_out_dtype_matches_jax():
    """bf16 operands, fp32 output (the classifier head of a bf16 model):
    exact bf16 products accumulated in fp32 on both sides."""
    rng = np.random.default_rng(3)
    x, w = _np(rng, (8, 96)), _np(rng, (96, 100), 96 ** -0.5)
    b = _np(rng, (100,), 0.1)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    port = rowwise_matmul_p(tx, tw, bias=torch.from_numpy(b),
                            out_dtype=torch.float32)
    jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    want = jmatmul(jx, jw, bias=jnp.asarray(b), out_dtype=jnp.float32,
                   interpret=True)
    assert port.dtype == torch.float32
    _close(port, want)
    _close(port, jref.matmul_ref(jx, jw, bias=jnp.asarray(b),
                                 out_dtype=jnp.float32))


ATTN_CASES = {
    "bias-nb1": dict(b=2, hq=3, hkv=3, sq=49, skv=49, nb=1, causal=False),
    "bias-nb4": dict(b=8, hq=2, hkv=2, sq=49, skv=49, nb=4, causal=False),
    "causal": dict(b=2, hq=2, hkv=2, sq=40, skv=40, causal=True),
    "window": dict(b=1, hq=2, hkv=2, sq=48, skv=48, causal=True, window=9),
    "gqa": dict(b=2, hq=4, hkv=1, sq=24, skv=24, causal=True),
    "q-offset": dict(b=1, hq=2, hkv=2, sq=16, skv=48, causal=True,
                     q_offset=32),
    "all-lm": dict(b=1, hq=4, hkv=2, sq=16, skv=64, causal=True, window=20,
                   q_offset=48),
    "noncausal-sq49": dict(b=2, hq=2, hkv=2, sq=49, skv=49, causal=False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(case):
    kw = dict(ATTN_CASES[case])
    b, hq, hkv = kw.pop("b"), kw.pop("hq"), kw.pop("hkv")
    sq, skv, nb = kw.pop("sq"), kw.pop("skv"), kw.pop("nb", 0)
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    hd = 16
    q = _np(rng, (b, hq, sq, hd))
    k, v = _np(rng, (b, hkv, skv, hd)), _np(rng, (b, hkv, skv, hd))
    bias = _np(rng, (nb, hq, sq, skv)) if nb else None
    t = {name: None if a is None else torch.from_numpy(a)
         for name, a in (("q", q), ("k", k), ("v", v), ("bias", bias))}
    j = {name: None if a is None else jnp.asarray(a)
         for name, a in (("q", q), ("k", k), ("v", v), ("bias", bias))}
    port = flash_attention_p(**t, **kw)
    _close(port, jflash(**j, **kw, block_q=16, block_k=16, interpret=True))
    _close(port, jref.attention_ref(**j, **kw))


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("with_beta", [True, False])
@pytest.mark.parametrize("shape", [(40, 96), (4, 2560), (7, 333)], ids=str)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_matches_jax(kind, with_beta, shape, dtype):
    """The port's layernorm against JAX's interpret-mode kernel and its
    reference: the Swin-T width, a decode step's M=4 x D=2560 and a
    ragged D, x in fp32 and in bf16 (rounded to bf16 on both sides, the
    same bits; gamma and beta fp32). fp32 within TOL; bf16 within
    1e-2 (rtol and atol): both round one fp32 result to bf16, and sums
    taken in another order may move it by one bf16 step, 2^-7 relative
    to |y|."""
    m, d = shape
    rng = np.random.default_rng(7)
    x = _np(rng, (m, d), 2.0) + 0.5
    g = 1 + _np(rng, (d,), 0.1)
    b = _np(rng, (d,), 0.1) if with_beta else None
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    port = layernorm_p(tx, torch.from_numpy(g),
                       None if b is None else torch.from_numpy(b), kind=kind)
    assert port.dtype == tx.dtype
    jb = None if b is None else jnp.asarray(b)
    tol = TOL if dtype == "fp32" else dict(rtol=1e-2, atol=1e-2)
    for want in (jlayernorm(jx, jnp.asarray(g), jb, kind=kind,
                            interpret=True),
                 jref.layernorm_ref(jx, jnp.asarray(g), jb, kind=kind)):
        np.testing.assert_allclose(np.asarray(port.float()),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)


def test_layernorm_pick_design():
    """Every (M, D, dtype) gets a design; a decode step's rows go to cta,
    RWKV6-3B prefill, ViT-B/16's final norm and Swin-T's stage norms
    (B=8) to rows, Swin-T's final norm (392 x 768) to the design measured
    faster for its dtype (rows in fp32, cta in bf16), rows wider than the
    rows design holds to cta."""
    from repro_torch.kernels import layernorm as ln
    for dt in (torch.float32, torch.bfloat16):
        for m in (0, 1, 4, ln.CTA_PICK_M[dt], ln.CTA_PICK_M[dt] + 1, 2048,
                  25088):
            for d in (1, 96, 333, 2560, ln.ROWS_MAX_D[dt],
                      ln.ROWS_MAX_D[dt] + 1, 60000):
                assert ln.pick_design(m, d, dt) in ("cta", "rows")
        for m in (1, 4):
            assert ln.pick_design(m, 2560, dt) == "cta"
        for m, d in ((2048, 2560), (25088, 96), (6272, 192), (1568, 384),
                     (1576, 768)):
            assert ln.pick_design(m, d, dt) == "rows"
        assert ln.pick_design(2048, 20000, dt) == "cta"
    assert ln.pick_design(392, 768, torch.float32) == "rows"
    assert ln.pick_design(392, 768, torch.bfloat16) == "cta"


def test_ops_match_jax_ops():
    """The ops layer (leading dims, the stored fused panels, the
    space-to-depth patch-embed) against the JAX ops in ref mode."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(11)
    x = _np(rng, (2, 5, 32))
    w3 = _np(rng, (32, 96), 32 ** -0.5)
    b3 = _np(rng, (96,), 0.1)
    g, be = 1 + _np(rng, (32,), 0.1), _np(rng, (32,), 0.1)
    wgi = _np(rng, (32, 128), 32 ** -0.5)
    img = _np(rng, (2, 16, 16, 3))
    pw, pb = _np(rng, (48, 24), 48 ** -0.5), _np(rng, (24,), 0.1)
    T, J = torch.from_numpy, jnp.asarray
    with jruntime.use_impl("ref"):
        jq = jops.qkv_proj(J(x), J(w3), (32, 32, 32), bias=J(b3),
                           norm=jops.NormSpec("layer", J(g), J(be)))
        jgu = jops.gate_up_proj(J(x), J(wgi), activation="silu",
                                norm=jops.NormSpec("rms", J(g)))
        jpe = jops.patch_embed(J(img), J(pw), J(pb), patch=4)
        jpe_conv = jref.patch_embed_ref(J(img), J(pw), J(pb), patch=4)
    for impl in ("auto", "ref"):
        with runtime.use_impl(impl):
            tq = ops.qkv_proj(T(x), T(w3), (32, 32, 32), bias=T(b3),
                              norm=ops.NormSpec("layer", T(g), T(be)))
            tgu = ops.gate_up_proj(T(x), T(wgi), activation="silu",
                                   norm=ops.NormSpec("rms", T(g)))
            tpe = ops.patch_embed(T(img), T(pw), T(pb), patch=4)
        for a, b in zip(tq, jq):
            _close(a, b)
        _close(tgu, jgu)
        _close(tpe, jpe)
        _close(tpe, jpe_conv)
    _close(ref.patch_embed_ref(T(img), T(pw), T(pb), patch=4), jpe_conv)


def test_weight_only_int8_leaf_dequantizes():
    from repro.core import quant as jquant
    rng = np.random.default_rng(5)
    x, w = _np(rng, (6, 32)), _np(rng, (32, 16))
    jq = jquant.quantize_tree({"w": jnp.asarray(w)})["w"]
    leaf = {"q": torch.from_numpy(np.array(jq["q"])),
            "s": torch.from_numpy(np.array(jq["s"]))}
    from repro.kernels import ops as jops
    with jruntime.use_impl("ref"):
        want = jops.matmul(jnp.asarray(x), jq)
    _close(ops.matmul(torch.from_numpy(x), leaf), want)


# --------------------------------------------------------------------------
# The designs each wrapper picks, in pure Python (the kernels run only on
# the card; tests/test_torch_cuda.py runs each design there).

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rowwise_matmul as rm  # noqa: E402
from repro_torch.kernels import wkv as wk  # noqa: E402


@pytest.mark.parametrize("s", [0, 1, 2, "pick", "pick+1", 15, 16, 17, 333,
                               512])
def test_wkv_pick_design(s):
    """Sequences up to STEP_PICK_S tokens take the step design (decode),
    longer ones the chunk design (prefill)."""
    if s == "pick":
        s = wk.STEP_PICK_S
    elif s == "pick+1":
        s = wk.STEP_PICK_S + 1
    want = "step" if s <= wk.STEP_PICK_S else "chunk"
    assert wk.pick_design(s) == want
    assert want in wk.DESIGNS


def test_wkv_pick_design_follows_its_threshold(monkeypatch):
    for upto in (0, 1, 16, 1 << 20):
        monkeypatch.setattr(wk, "STEP_PICK_S", upto)
        assert [wk.pick_design(s) for s in (1, 16, 17)] == [
            "step" if s <= upto else "chunk" for s in (1, 16, 17)]


@pytest.mark.parametrize("dtype,want", [(torch.float32, "ffma"),
                                        (torch.bfloat16, "mma")],
                         ids=["fp32", "bf16"])
def test_attention_pick_design(dtype, want):
    assert fa.pick_design(dtype) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8,
                                   torch.float64])
def test_attention_pick_design_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="no kernel"):
        fa.pick_design(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=str)
@pytest.mark.parametrize("m", [1, 4, 5, 16, 17, 2048])
def test_matmul_pick_design(m, dtype):
    """Up to SKINNY_PICK_M rows the skinny design; above, wgmma for bf16
    and int8, ffma for fp32."""
    if m <= rm.SKINNY_PICK_M[dtype]:
        want = "skinny"
    else:
        want = "ffma" if dtype == torch.float32 else "wgmma"
    assert rm.pick_design(m, dtype) == want
