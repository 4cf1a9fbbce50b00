"""The port's int8 W8A8 leg against the JAX package's, on CPU.

The same numpy inputs go through the JAX quantizers and int8 kernel
(Pallas in interpret mode) and through the port's copies: the
quantizers must agree bitwise; ``ops.matmul_int8`` and the gated int8
``rowwise_matmul_p`` (each running its plain version for a CPU tensor)
within 1e-5 × max(1, max|ref|). The int32 sums are exact on both sides,
so only the fp32 dequant and the activations differ.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rowwise_matmul import rowwise_matmul_p as jmatmul
from repro_torch.core import quant
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(port.float()) - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


def _bitwise(port, want):
    want = np.asarray(want)
    got = port.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("shape,axis", [((96, 40), 0), ((3, 64, 48), 1),
                                        ((1, 300), 0)], ids=str)
def test_quantize_per_channel_bitwise(shape, axis):
    w = _np(_rng(f"pc{shape}"), shape, 0.3)
    w[..., 0] = 0.0                    # an all-zero channel: the 1e-8 floor
    q, s = quant.quantize_per_channel(torch.from_numpy(w), axis=axis)
    jq, js = jquant.quantize_per_channel(jnp.asarray(w), axis=axis)
    _bitwise(q, jq)
    _bitwise(s, js)


@pytest.mark.parametrize("shape", [(33, 96), (2, 5, 70), (4, 1)], ids=str)
def test_quantize_per_row_bitwise(shape):
    x = _np(_rng(f"pr{shape}"), shape, 2.0)
    x[0] = 0.0
    # values at exactly half a step: round half to even on both sides
    x.flat[1] = 0.5
    q, s = quant.quantize_per_row(torch.from_numpy(x))
    jq, js = jquant.quantize_per_row(jnp.asarray(x))
    _bitwise(q, jq)
    _bitwise(s, js)


def test_dequantize_bitwise():
    rng = _rng("dq")
    acc = rng.integers(-2 ** 24, 2 ** 24, (8, 16)).astype(np.int32)
    xs, ws = _np(rng, (8, 1)), _np(rng, (1, 16))
    got = quant.dequantize(*(torch.from_numpy(a) for a in (acc, xs, ws)))
    _bitwise(got, jquant.dequantize(*(jnp.asarray(a)
                                      for a in (acc, xs, ws))))


def test_quantize_tree_matches_jax():
    """Weight-only quantization of an LM-like tree with the LM
    predicate: the same leaves quantized, to the same bits; norm gains
    and vectors pass through."""
    rng = _rng("tree")
    tree = {"embed": _np(rng, (50, 16)),
            "stages": [{"wqkv": _np(rng, (2, 16, 48)),
                        "norm": {"g": _np(rng, (2, 16))},
                        "wo": _np(rng, (2, 16, 16)), "b": _np(rng, (16,))}]}
    got = quant.quantize_tree(
        jax.tree_util.tree_map(torch.from_numpy, tree),
        quant.lm_weight_predicate)
    want = jquant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                                jquant.lm_weight_predicate)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert ([jax.tree_util.keystr(p) for p, _ in flat_got]
            == [jax.tree_util.keystr(p) for p, _ in flat_want])
    for (_, g), (_, w) in zip(flat_got, flat_want):
        _bitwise(g, w)
    assert quant.is_quantized(got["stages"][0]["wqkv"])
    assert not quant.is_quantized(got["stages"][0]["norm"]["g"])


def _int8_inputs(name, m, k, n):
    rng = _rng(name)
    x, w = _np(rng, (m, k)), _np(rng, (k, n), k ** -0.5)
    jxq, jxs = jquant.quantize_per_row(jnp.asarray(x))
    jwq, jws = jquant.quantize_per_channel(jnp.asarray(w))
    arrays = {"xq": jxq, "wq": jwq, "xs": jxs, "ws": jws,
              "bias": jnp.asarray(_np(rng, (n,), 0.1)),
              "res": jnp.asarray(_np(rng, (m, n)))}
    port = {key: torch.from_numpy(np.array(v)) for key, v in arrays.items()}
    return arrays, port


INT8_CASES = {
    "plain": dict(m=33, k=96, n=64),
    "bias": dict(m=33, k=96, n=64, bias=True),
    "gelu": dict(m=16, k=64, n=80, bias=True, act="gelu"),
    "silu": dict(m=16, k=64, n=80, act="silu"),
    "relu": dict(m=16, k=64, n=80, bias=True, act="relu"),
    "relu2": dict(m=16, k=64, n=80, act="relu2"),
    "residual": dict(m=49, k=48, n=96, bias=True, residual=True),
    "gelu+residual": dict(m=24, k=128, n=96, act="gelu", residual=True),
    "ragged-n1000": dict(m=8, k=64, n=1000, bias=True),
    # K above one VMEM panel: the JAX kernel takes k_splits > 1
    "k8448-ksplit": dict(m=16, k=8448, n=128, bias=True),
}


@pytest.mark.parametrize("case", list(INT8_CASES))
def test_matmul_int8_matches_jax(case):
    kw = dict(INT8_CASES[case])
    m, k, n = kw.pop("m"), kw.pop("k"), kw.pop("n")
    act = kw.pop("act", None)
    j, p = _int8_inputs(case, m, k, n)
    jb = j["bias"] if kw.get("bias") else None
    pb = p["bias"] if kw.get("bias") else None
    jr = j["res"] if kw.get("residual") else None
    pr = p["res"] if kw.get("residual") else None
    port = ops.matmul_int8(p["xq"], p["wq"], p["xs"], p["ws"], bias=pb,
                           activation=act, residual=pr)
    assert port.shape == (m, n) and port.dtype == torch.float32
    want = jops.matmul_int8(j["xq"], j["wq"], j["xs"], j["ws"], bias=jb,
                            activation=act, residual=jr, impl="interpret")
    _close(port, want)
    oracle = jref.matmul_int8_ref(j["xq"], j["wq"], j["xs"].reshape(-1, 1),
                                  j["ws"], bias=jb, activation=act)
    if jr is not None:
        oracle = oracle + jr
    _close(port, oracle)
    # the port's own oracle, and its impl="ref" route
    _close(ref.matmul_int8_ref(p["xq"], p["wq"], p["xs"], p["ws"], bias=pb,
                               activation=act), np.asarray(
        jref.matmul_int8_ref(j["xq"], j["wq"], j["xs"].reshape(-1, 1),
                             j["ws"], bias=jb, activation=act)))
    _close(ops.matmul_int8(p["xq"], p["wq"], p["xs"], p["ws"], bias=pb,
                           activation=act, residual=pr, impl="ref"), oracle)


def test_matmul_int8_wide_n_concatenated_scales():
    """Wide-N int8: weights AND per-channel scales concatenated along N
    (as a quantized fused [wq | wk | wv] leaf stores them), leading dims
    flattened, ``wide_n=True``."""
    rng = _rng("wide")
    x = _np(rng, (2, 9, 64))
    parts = [_np(rng, (64, n), 0.125) for n in (32, 32, 64)]
    jxq, jxs = jquant.quantize_per_row(jnp.asarray(x))
    qs = [jquant.quantize_per_channel(jnp.asarray(w)) for w in parts]
    jwq = jnp.concatenate([q for q, _ in qs], axis=1)
    jws = jnp.concatenate([s for _, s in qs], axis=1)
    # the fused leaf quantizes to the same panel and scales
    fq, fs = quant.quantize_per_channel(
        torch.from_numpy(np.concatenate(parts, axis=1)))
    _bitwise(fq, jwq)
    _bitwise(fs, jws)
    port = ops.matmul_int8(*(torch.from_numpy(np.array(a))
                             for a in (jxq, jwq, jxs, jws)), wide_n=True)
    want = jops.matmul_int8(jxq, jwq, jxs, jws, wide_n=True,
                            impl="interpret")
    assert port.shape == (2, 9, 128)
    _close(port, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_int8_matches_jax(act):
    """Gated epilogue under W8A8 (as ``tests/test_fusion.py`` holds the
    JAX kernel): per-weight dequant scales, the gate's own bias."""
    rng = _rng(f"gated-{act}")
    d, f, m = 64, 48, 24
    x, wg, wi = _np(rng, (m, d)), _np(rng, (d, f)), _np(rng, (d, f))
    bg, bi = _np(rng, (f,), 0.1), _np(rng, (f,), 0.1)
    xq, xs = jquant.quantize_per_row(jnp.asarray(x))
    wgq, wgs = jquant.quantize_per_channel(jnp.asarray(wg))
    wiq, wis = jquant.quantize_per_channel(jnp.asarray(wi))
    want = jmatmul(xq, wiq, x_scale=xs.reshape(-1, 1), w_scale=wis,
                   w_gate=wgq, wg_scale=wgs, bias=jnp.asarray(bi),
                   bias_gate=jnp.asarray(bg), activation=act,
                   interpret=True)
    t = {key: torch.from_numpy(np.array(v)) for key, v in dict(
        xq=xq, xs=xs.reshape(-1, 1), wgq=wgq, wgs=wgs, wiq=wiq, wis=wis,
        bg=bg, bi=bi).items()}
    port = rowwise_matmul_p(t["xq"], t["wiq"], x_scale=t["xs"],
                            w_scale=t["wis"], w_gate=t["wgq"],
                            wg_scale=t["wgs"], bias=t["bi"],
                            bias_gate=t["bg"], activation=act)
    assert port.dtype == torch.float32
    _close(port, want)


def test_int8_out_dtype_and_residual_dtype():
    """bf16 output and a bf16 residual in the int8 mode, against JAX,
    within one bf16 step (2^-8 relative): an fp32 difference of an ulp
    may round the other way."""
    j, p = _int8_inputs("bf16-out", 16, 64, 32)
    res16 = j["res"].astype(jnp.bfloat16)
    want = jmatmul(j["xq"], j["wq"], x_scale=j["xs"].reshape(-1, 1),
                   w_scale=j["ws"], residual=res16, out_dtype=jnp.bfloat16,
                   interpret=True)
    port = rowwise_matmul_p(p["xq"], p["wq"], x_scale=p["xs"],
                            w_scale=p["ws"],
                            residual=p["res"].to(torch.bfloat16),
                            out_dtype=torch.bfloat16)
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(np.asarray(port.float()),
                               np.asarray(want, np.float32), rtol=1e-2,
                               atol=1e-2)


# ------------------- weight-only int8 LM trees ---------------------------


BF16_TOL = 3e-2


def _lm_trees(arch):
    """A reduced arch's fp32 JAX tree quantized by JAX's ``quantize_tree``
    with ``lm_weight_predicate``, and the same through the port's
    converter, whose int8 leaves cross as they are."""
    from repro.configs import REDUCED
    from repro.models import lm as jlm
    from repro_torch.configs import get_reduced
    from repro_torch.convert import from_jax_params
    jcfg, tcfg = REDUCED[arch](), get_reduced(arch)
    params, _ = jlm.init_lm(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    jq = jquant.quantize_tree(params, jquant.lm_weight_predicate)
    tq = from_jax_params(jax.tree_util.tree_map(np.asarray, jq), tcfg,
                         device="cpu")
    return jcfg, tcfg, jq, tq


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-20b"])
def test_int8_lm_tree_forward_and_greedy_match_jax(arch):
    """A weight-only int8 tree (deepseek-7b reduced: untied head;
    granite-20b reduced: the head tied to the int8 embedding) runs
    through ``lm.forward`` and ``lm.greedy``: the embedding gathers int8
    rows and dequantizes only them (bitwise JAX's ``embed``), the tied
    head resolves the table before its transpose. Logits within the
    bf16 tolerance (the tree dequantizes to the config's bf16), greedy
    streams equal to ``manual_greedy`` on JAX's tree."""
    from conftest import manual_greedy

    from repro.core import runtime as jruntime
    from repro.models import lm as jlm
    from repro_torch.models import lm
    jcfg, tcfg, jq, tq = _lm_trees(arch)
    assert quant.is_quantized(tq["embed"])
    assert tcfg.tie_embeddings == (arch == "granite-20b")
    toks = np.random.default_rng(3).integers(0, 256, (2, 21)).astype(
        np.int32)
    emb = lm.embed(tq, torch.from_numpy(toks).long(), tcfg)
    jemb = jlm.embed(jq, jnp.asarray(toks), jcfg)
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(),
                                  np.asarray(jemb, np.float32))
    with jruntime.use_impl("ref"):
        want, _ = jlm.forward(jq, jnp.asarray(toks), jcfg, remat=False)
    got, aux = lm.forward(tq, torch.from_numpy(toks).long(), tcfg)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    for seed, s in ((5, 5), (9, 9)):
        prompt = np.random.default_rng(seed).integers(0, 256, (s,)).astype(
            np.int32)
        with jruntime.use_impl("ref"):
            stream = manual_greedy(jq, jcfg, jnp.asarray(prompt), 6, s + 6)
        got = lm.greedy(tq, torch.from_numpy(prompt).long()[None], tcfg, 6)
        assert got[0].tolist() == stream
