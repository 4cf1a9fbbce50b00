"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips. On a machine with one
(the JAX package is not needed, so the JAX-importing conftest is left
out):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

fp32 tolerance 1e-4 against max(1, max|plain|): only the order of the
fp32 sums differs (the SSD scan: its 64-row tiles, the causal blocks and
the state carried at chunk ends, every decay factor at most 1; held to
the per-step scan in float64 and to the chunked scan in fp32). bf16: 3e-2, the output (and the WKV y) is rounded to
bf16 (8-bit mantissa) where the plain version keeps fp32 (attention also
rounds its probabilities to bf16 before the PV product, as JAX does). int8: 1e-5,
the int32 sums are exact (the plain version multiplies in float64 on
the card), so only the fp32 dequant and activations differ.
"""
import math

import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.swin_t import reduced
from repro_torch.core import quant, runtime, trace
from repro_torch.kernels import layernorm as ln
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels import rowwise_matmul as rm
from repro_torch.kernels import ssd
from repro_torch.kernels import wkv as wk
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.kernels.wkv import wkv_p
from repro_torch.models import lm, mamba2, rwkv6, vision

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _recording():
    """Every test runs inside the port's trace.recording(): the launch
    counters the tests read move."""
    with trace.recording():
        yield


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts(kernels):
    """The launches counted of each kernel."""
    return [trace.launches(k) for k in kernels]


def _since(kernels, before):
    """The launches of each kernel since ``before`` (:func:`_counts`)."""
    return [trace.launches(k) - b for k, b in zip(kernels, before)]


def _close(got, want, tol=1e-4):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("mode", [
    dict(), dict(prologue="layer", beta=True), dict(prologue="rms"),
    dict(activation="gelu"), dict(activation="silu", gated=True),
    dict(activation="relu2", residual=True)], ids=str)
@pytest.mark.parametrize("shape", [(49, 48, 96), (8, 768, 1000),
                                   (130, 200, 70)])
def test_matmul_kernel(dev, mode, shape):
    m, k, n = shape
    g = torch.Generator(device="cpu").manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dev)
    mode = dict(mode)
    kw = dict(bias=r(n, scale=0.1), activation=mode.pop("activation", None),
              prologue=mode.pop("prologue", None))
    if kw["prologue"]:
        kw["gamma"] = 1 + r(k, scale=0.1)
        kw["pbeta"] = r(k, scale=0.1) if mode.pop("beta", False) else None
    if mode.pop("gated", False):
        kw.update(w_gate=r(k, n, scale=k ** -0.5), bias_gate=r(n, scale=0.1))
    if mode.pop("residual", False):
        kw["residual"] = r(m, n)
    x, w = r(m, k), r(k, n, scale=k ** -0.5)
    before = trace.launches("rowwise_matmul")
    got = rowwise_matmul_p(x, w, **kw)
    assert trace.launches("rowwise_matmul") == before + 1
    want = ref.pipeline_ref(x, w, norm_kind=kw.pop("prologue"),
                            beta=kw.pop("pbeta", None), **kw)
    _close(got, want)


TOLS = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.int8: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [4, 2048])
def test_matmul_lm_head(dev, dtype, m):
    """deepseek-7b's head: K=4096, N=102400, fp32 out (the skinny design
    at M=4, the wide design at M=2048); and its RMS-prologue qkv panel
    (N=12288) at the same M."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(m, 4096, device=dev, generator=g).to(dtype)
    for n, kw in ((102400, dict(out_dtype=torch.float32)),
                  (12288, dict(prologue="rms", gamma=(1 + 0.1 * torch.randn(
                      4096, device=dev, generator=g)).to(dtype)))):
        w = (torch.randn(4096, n, device=dev, generator=g)
             * 4096 ** -0.5).to(dtype)
        got = rowwise_matmul_p(x, w, **kw)
        assert got.dtype == kw.get("out_dtype", dtype)
        want = ref.pipeline_ref(x.float(), w.float(),
                                norm_kind=kw.get("prologue"),
                                gamma=kw.get("gamma"),
                                out_dtype=torch.float32)
        _close(got, want, TOLS[dtype])
MODES = [dict(), dict(prologue="layer", beta=True), dict(prologue="rms"),
         dict(activation="gelu"), dict(activation="silu", gated=True),
         dict(activation="relu2", residual=True)]


def _matmul_case(dev, m, k, n, dtype, mode, *, strided=False, seed=0):
    """Operands of one matmul call and its plain version's output (fp32).
    ``strided``: w (and w_gate) are the halves of one [wg | wi] panel."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dev)
    mode = dict(mode)
    int8 = dtype == torch.int8
    vec = torch.float32 if int8 else dtype
    kw = dict(bias=r(n, scale=0.1).to(vec),
              activation=mode.pop("activation", None),
              prologue=mode.pop("prologue", None))
    gated = mode.pop("gated", False)
    if kw["prologue"]:
        kw["gamma"] = (1 + r(k, scale=0.1)).to(vec)
        kw["pbeta"] = r(k, scale=0.1).to(vec) if mode.pop("beta", False) \
            else None
    panel = r(k, 2 * n, scale=k ** -0.5)
    if int8:
        xq, xs = quant.quantize_per_row(r(m, k))
        pq, ps = quant.quantize_per_channel(panel)
        x, kw["x_scale"] = xq, xs
        w, kw["w_scale"] = pq[:, n:], ps[:, n:].contiguous()
        if gated:
            kw["w_gate"], kw["wg_scale"] = pq[:, :n], ps[:, :n].contiguous()
    else:
        x, panel = r(m, k).to(dtype), panel.to(dtype)
        w = panel[:, n:]
        if gated:
            kw["w_gate"] = panel[:, :n]
    if not strided:
        w = w.contiguous()
        if gated:
            kw["w_gate"] = kw["w_gate"].contiguous()
    if gated:
        kw["bias_gate"] = r(n, scale=0.1).to(vec)
    if mode.pop("residual", False):
        kw["residual"] = r(m, n).to(vec)
    want = ref.pipeline_ref(
        x, w, norm_kind=kw["prologue"], beta=kw.get("pbeta"),
        out_dtype=torch.float32,
        **{key: v for key, v in kw.items()
           if key not in ("prologue", "pbeta")})
    return x, w, kw, want


# M on both sides of the skinny design's pick (16 fp32, 4 bf16 and
# int8) and at prefill rows
DESIGN_SHAPES = [(m, k, n) for m in (1, 4, 5, 16, 17, 49, 130, 2048)
                 for k, n in ((48, 96), (200, 70), (768, 1000))]


@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("shape", DESIGN_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=str)
def test_matmul_designs(dev, dtype, shape, mode):
    """Every mode x dtype on both sides of the skinny threshold and at
    prefill rows, ragged K and N, against the plain version; each call
    one launch."""
    m, k, n = shape
    if dtype == torch.int8 and "prologue" in mode:
        pytest.skip("the int8 mode has no norm prologue (JAX asserts it)")
    x, w, kw, want = _matmul_case(dev, m, k, n, dtype, mode)
    before = trace.launches("rowwise_matmul")
    got = rowwise_matmul_p(x, w, **kw)
    assert trace.launches("rowwise_matmul") == before + 1
    _close(got, want, TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 16, 333, 2048])
def test_matmul_mamba_in_proj(dev, dtype, m):
    """zamba2-1.2b's in-projection: K = 2048, N = 8384 (an odd multiple
    of 64: the last tile of the wide designs is masked) on every design
    (skinny at M <= 16 fp32 / 4 bf16, then ffma or wgmma), and the
    z | x | B,C | dt column views of its output read as the mixer reads
    them; then out_proj, K = 4096 into N = 2048."""
    g = torch.Generator(device=dev).manual_seed(8)
    for k, n in ((2048, 8384), (4096, 2048)):
        x = torch.randn(m, k, device=dev, generator=g).to(dtype)
        w = (torch.randn(k, n, device=dev, generator=g)
             * k ** -0.5).to(dtype)
        got = rowwise_matmul_p(x, w)
        want = ref.pipeline_ref(x.float(), w.float(),
                                out_dtype=torch.float32)
        _close(got, want, TOLS[dtype])
        if n == 8384:
            for a, b in zip(torch.split(got, [4096, 4096, 128, 64], -1),
                            torch.split(want, [4096, 4096, 128, 64], -1)):
                _close(a, b, TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 333, 2048])
def test_layernorm_mamba_gated_rms(dev, dtype, m):
    """The Mamba2 mixer's gated RMS norm: D = 4096 rows of y * silu(z),
    cast to the block's dtype, as ``mamba2.apply`` hands them to the
    kernel."""
    g = torch.Generator(device=dev).manual_seed(9)
    y, z = (torch.randn(m, 4096, device=dev, generator=g) for _ in range(2))
    x = (y * torch.nn.functional.silu(z)).to(dtype)
    gamma = (1 + 0.1 * torch.randn(4096, device=dev, generator=g)).to(dtype)
    _ln_check(x, gamma, None, "rms")


@pytest.mark.parametrize("skinny_upto", [0, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=str)
@pytest.mark.parametrize("m", [1, 16, 130])
def test_matmul_designs_either_side(dev, monkeypatch, skinny_upto, dtype, m):
    """The skinny design and the other design of each dtype at the same
    M (the picker's threshold moved to 0 or 16 rows), gated over the
    strided halves of one [wg | wi] panel, and twice: the outputs repeat
    bitwise."""
    monkeypatch.setitem(rm.SKINNY_PICK_M, dtype, skinny_upto)
    for mode in (dict(activation="silu", gated=True),
                 dict(activation="gelu", residual=True)):
        x, w, kw, want = _matmul_case(dev, m, 1000, 200, dtype, mode,
                                      strided=True, seed=7)
        got = rowwise_matmul_p(x, w, **kw)
        again = rowwise_matmul_p(x, w, **kw)
        _close(got, want, TOLS[dtype])
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=str)
def test_matmul_split_k_repeats_bitwise(dev, dtype):
    """The skinny design at decode shapes, split over many blocks: ten
    calls give the same bits (the splits are summed in a fixed order)."""
    x, w, kw, want = _matmul_case(dev, 4, 8960, 2560, dtype,
                                  dict(activation="relu2"))
    outs = [rowwise_matmul_p(x, w, **kw) for _ in range(10)]
    _close(outs[0], want, TOLS[dtype])
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def _design(before):
    """The one design the matmul launches since ``before`` (a length of
    ``trace.records``) took."""
    designs = {r["design"] for r in trace.records[before:]
               if r["kernel"] == "rowwise_matmul"}
    assert len(designs) == 1, designs
    return designs.pop()


# deepseek-7b's prefill projections (K, N, mode): qkv, wo and down with
# a bf16 residual, gate|up gated with SiLU over the halves of its panel
LM_PROJECTIONS = {
    "qkv": (4096, 12288, dict()),
    "wo+res": (4096, 4096, dict(residual=True)),
    "gate|up+silu": (4096, 11008, dict(activation="silu", gated=True)),
    "down+res": (11008, 4096, dict(residual=True))}


@pytest.mark.parametrize("proj", list(LM_PROJECTIONS))
@pytest.mark.parametrize("m", [1628, 7084])
def test_matmul_persistent_lm(dev, m, proj):
    """The persistent design at every deepseek-7b prefill projection at
    ragged M (B=4 x 407 and x 1771 tokens: the last row panel part
    full), where the route sends them, against the plain version."""
    k, n, mode = LM_PROJECTIONS[proj]
    x, w, kw, want = _matmul_case(dev, m, k, n, torch.bfloat16, mode,
                                  strided=True, seed=5)
    before = len(trace.records)
    got = rowwise_matmul_p(x, w, **kw)
    assert _design(before) == "persistent"
    assert got.dtype == torch.bfloat16
    _close(got, want, TOLS[torch.bfloat16])


# Swin-T's projections the route sends to the persistent design, at
# B=8: (M, K, N, mode)
SWIN_PERSISTENT = [(392, 3072, 768, dict(residual=True)),
                   (392, 1536, 768, dict())]


@pytest.mark.parametrize("shape", SWIN_PERSISTENT, ids=str)
def test_matmul_persistent_swin(dev, shape):
    """A Swin-T shape the route sends to the persistent design (stage 4's
    mlp2 with its residual, stage 3's merge), against the plain
    version."""
    m, k, n, mode = shape
    assert rm.pick_design(m, torch.bfloat16, n, k) == "persistent"
    x, w, kw, want = _matmul_case(dev, m, k, n, torch.bfloat16, mode)
    before = len(trace.records)
    got = rowwise_matmul_p(x, w, **kw)
    assert _design(before) == "persistent"
    _close(got, want, TOLS[torch.bfloat16])


# (M, K, N): fewer tiles than SMs, M and N off the tiles (N = 300: the
# output's rows off 16-byte alignment), K off the 64 of a stage; N a
# multiple of 256 (the wide tile); one row
EDGE_SHAPES = [(130, 1000, 200), (300, 1000, 300), (257, 200, 512),
               (1, 1024, 256), (5, 64, 1000)]


@pytest.mark.parametrize("mode", [
    dict(), dict(activation="gelu"), dict(activation="silu", gated=True),
    dict(activation="relu2", residual=True)], ids=str)
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=str)
@pytest.mark.parametrize("route", ["persistent", "wgmma"])
def test_matmul_persistent_either_side(dev, monkeypatch, route, shape,
                                       mode):
    """The persistent and wgmma designs at one shape (the route forced
    either way, the skinny rows moved below M), the weights N-column
    views of panels whose rows TMA takes, against the plain version;
    twice: the outputs repeat bitwise (each element summed in K order by
    one block)."""
    m, k, n = shape
    monkeypatch.setattr(rm, "persistent_fits",
                        lambda m_, n_, k_: route == "persistent")
    monkeypatch.setitem(rm.SKINNY_PICK_M, torch.bfloat16, 0)
    g = torch.Generator(device="cpu").manual_seed(3)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dev, torch.bfloat16)

    def weight():
        return r(k, -(-n // 8) * 8, scale=k ** -0.5)[:, :n]
    x, kw = r(m, k), dict(bias=r(n, scale=0.1),
                          activation=mode.get("activation"))
    w = weight()
    if mode.get("gated"):
        kw.update(w_gate=weight(), bias_gate=r(n, scale=0.1))
    if mode.get("residual"):
        kw["residual"] = r(m, n)
    before = len(trace.records)
    got = rowwise_matmul_p(x, w, **kw)
    again = rowwise_matmul_p(x, w, **kw)
    assert _design(before) == route
    _close(got, ref.pipeline_ref(x, w, out_dtype=torch.float32, **kw),
           TOLS[torch.bfloat16])
    assert torch.equal(got, again)


@pytest.mark.parametrize("res_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32-res", "bf16-res"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32-out", "bf16-out"])
def test_matmul_persistent_dtypes(dev, out_dtype, res_dtype):
    """The persistent design's epilogue in every output and residual
    dtype the wrapper takes with bf16 operands, at a wide tile, a bias
    in fp32."""
    g = torch.Generator(device="cpu").manual_seed(4)
    m, k, n = 333, 1536, 768
    x = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(k, n, generator=g) * k ** -0.5).to(dev, torch.bfloat16)
    b = (torch.randn(n, generator=g) * 0.1).to(dev)
    res = torch.randn(m, n, generator=g).to(dev, res_dtype)
    before = len(trace.records)
    got = rowwise_matmul_p(x, w, bias=b, activation="gelu", residual=res,
                           out_dtype=out_dtype)
    assert _design(before) == "persistent" and got.dtype == out_dtype
    want = ref.pipeline_ref(x, w, bias=b, activation="gelu", residual=res,
                            out_dtype=torch.float32)
    _close(got, want, TOLS[torch.bfloat16])


def test_matmul_persistent_keeps_off(dev, monkeypatch):
    """What the wgmma design keeps at a shape the route sends to the
    persistent one: an operand TMA cannot take (x's rows off 16 bytes),
    a norm prologue, and int8; each against the plain version."""
    monkeypatch.setattr(rm, "persistent_fits", lambda m_, n_, k_: True)
    g = torch.Generator(device="cpu").manual_seed(6)
    m, k, n = 300, 1032, 512
    wide = torch.randn(m, k + 1, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(k, n, generator=g) * k ** -0.5).to(dev, torch.bfloat16)
    gamma = (1 + 0.1 * torch.randn(k, generator=g)).to(dev, torch.bfloat16)
    x = wide[:, :k].contiguous()
    assert rm.call_design(x, w) == "persistent"
    for xin, kw in ((wide[:, :k], {}),
                    (x, dict(prologue="rms", gamma=gamma))):
        before = len(trace.records)
        got = rowwise_matmul_p(xin, w, **kw)
        assert _design(before) == "wgmma"
        want = ref.pipeline_ref(xin, w, norm_kind=kw.get("prologue"),
                                gamma=kw.get("gamma"),
                                out_dtype=torch.float32)
        _close(got, want, TOLS[torch.bfloat16])
    xq, xs = quant.quantize_per_row(x.float())
    wq, ws = quant.quantize_per_channel(w.float())
    before = len(trace.records)
    got = rowwise_matmul_p(xq, wq, x_scale=xs, w_scale=ws)
    assert _design(before) == "wgmma"
    _close(got, ref.pipeline_ref(xq, wq, x_scale=xs, w_scale=ws),
           TOLS[torch.int8])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8], ids=str)
@pytest.mark.parametrize("m", [2, 8, 130])
@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm_prologue_either_side(dev, monkeypatch, dtype, m, kind):
    """``ops.matmul`` and ``ops.gate_up_proj`` with a norm at K = 700,
    ``SKINNY_NORM_MAX_K`` moved to either side of it: on the skinny
    design at K or above, one launch with the norm in the prologue;
    below it, and on the other designs on either side, the standalone
    norm then the matmul without one. Both against the plain pipeline
    (the norm cast to the streaming dtype before the dot)."""
    if dtype == torch.int8:
        pytest.skip("the int8 mode has no norm prologue (JAX asserts it)")
    k, n = 700, 300
    design = rm.pick_design(2 * m, dtype, n, k)
    g = torch.Generator(device="cpu").manual_seed(11)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dev, dtype)
    x, w, wgi = r(2, m, k), r(k, n, scale=k ** -0.5), r(k, 2 * n,
                                                        scale=k ** -0.5)
    norm = ops.NormSpec(kind, 1 + r(k, scale=0.1),
                        r(k, scale=0.1) if kind == "layer" else None)
    for max_k in (k, k - 1):
        monkeypatch.setattr(rm, "SKINNY_NORM_MAX_K", max_k)
        splits = 0 if design == "skinny" and max_k >= k else 1
        assert rm.norm_prologue_fits(2 * m, k, dtype) == (not splits)
        for fn in (lambda: ops.matmul(x, w, norm=norm),
                   lambda: ops.gate_up_proj(x, wgi, activation="gelu",
                                            norm=norm)):
            before = _counts(("rowwise_matmul", "layernorm"))
            got = fn()
            assert _since(("rowwise_matmul", "layernorm"), before) == [
                1, splits]
            with runtime.use_impl("ref"):
                want = fn()
            _close(got, want, TOLS[dtype])


def test_matmul_int8_op(dev):
    """``ops.matmul_int8`` with leading dims, concatenated wide-N scales
    and a residual, on the kernel against ``impl="ref"``."""
    g = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(2, 37, 384, generator=g).to(dev)
    w = torch.randn(384, 1152, generator=g).to(dev) * 0.05
    res = torch.randn(2, 37, 1152, generator=g).to(dev)
    xq, xs = quant.quantize_per_row(x)
    wq, ws = quant.quantize_per_channel(w)
    b = torch.randn(1152, generator=g).to(dev)
    got = ops.matmul_int8(xq, wq, xs, ws, bias=b, activation="gelu",
                          residual=res, wide_n=True)
    want = ops.matmul_int8(xq, wq, xs, ws, bias=b, activation="gelu",
                           residual=res, impl="ref")
    _close(got, want, 1e-5)


ATTN_CASES = {
    "swin-bias": dict(b=4, hq=3, hkv=3, sq=49, skv=49, nb=2, causal=False,
                      hd=32),
    "lm": dict(b=2, hq=8, hkv=2, sq=70, skv=200, causal=True, window=64,
               q_offset=130, hd=128),
    "vit": dict(b=2, hq=12, hkv=12, sq=197, skv=197, causal=False, hd=64),
    # Swin's windows: one bias for every window, and one per window
    # position (shifted blocks); a bias kept in bf16; every head dim
    "t49-nb1": dict(b=6, hq=3, hkv=3, sq=49, skv=49, nb=1, causal=False,
                    hd=32),
    "t49-nb4": dict(b=8, hq=6, hkv=6, sq=49, skv=49, nb=4, causal=False,
                    hd=32),
    "t49-bf16-bias": dict(b=4, hq=3, hkv=3, sq=49, skv=49, nb=2,
                          causal=False, hd=32, bias_dtype=torch.bfloat16),
    "t49-hd16": dict(b=3, hq=2, hkv=2, sq=49, skv=49, nb=1, causal=False,
                     hd=16),
    "t49-hd64": dict(b=3, hq=2, hkv=2, sq=49, skv=49, nb=3, causal=False,
                     hd=64),
    "t49-hd128": dict(b=3, hq=2, hkv=1, sq=49, skv=49, nb=1, causal=False,
                      hd=128),
    # keys past Skv in a partial tile, a causal offset past the keys, a
    # window alone
    "causal-short": dict(b=1, hq=4, hkv=4, sq=33, skv=20, causal=True,
                         hd=64),
    "window-only": dict(b=2, hq=2, hkv=1, sq=150, skv=150, causal=False,
                        window=40, hd=32),
    # a bias over several query and key tiles (read from device memory,
    # not cached), with causal + window and GQA
    "bias-tiles": dict(b=2, hq=2, hkv=2, sq=100, skv=130, nb=1,
                       causal=False, hd=64),
    "bias-causal-window": dict(b=2, hq=4, hkv=2, sq=70, skv=70, nb=2,
                               causal=True, window=30, hd=32,
                               bias_dtype=torch.bfloat16),
    # the dense LM prefill: causal, no window, S=512, head dim 128
    # (deepseek-7b at B=4: 32 heads), and GQA / MQA at S=333
    "prefill-512": dict(b=4, hq=32, hkv=32, sq=512, skv=512, causal=True,
                        hd=128),
    "prefill-333-gqa": dict(b=1, hq=8, hkv=2, sq=333, skv=333, causal=True,
                            hd=128),
    "prefill-333-mqa": dict(b=2, hq=4, hkv=1, sq=333, skv=333, causal=True,
                            hd=128),
    # gemma3-27b's prefill at B=2 x 2048: GQA 32 over 16, head dim 128,
    # the local layers' 1024-token window and the global layers
    "gemma-window": dict(b=2, hq=32, hkv=16, sq=2048, skv=2048, causal=True,
                         window=1024, hd=128),
    "gemma-global": dict(b=2, hq=32, hkv=16, sq=2048, skv=2048, causal=True,
                         hd=128),
    # whisper-base: its encoder's 1500 frames (ragged against the 64-row
    # query tile) at head dim 64, causal as the JAX encoder runs them and
    # non-causal; cross-attention of 64 and of 17 prompt tokens to them
    "whisper-enc-causal": dict(b=4, hq=8, hkv=8, sq=1500, skv=1500,
                               causal=True, hd=64),
    "whisper-enc": dict(b=4, hq=8, hkv=8, sq=1500, skv=1500, causal=False,
                        hd=64),
    "whisper-cross": dict(b=4, hq=8, hkv=8, sq=64, skv=1500, causal=False,
                          hd=64),
    "whisper-cross-17": dict(b=1, hq=8, hkv=8, sq=17, skv=1500,
                             causal=False, hd=64),
    # zamba2-1.2b's shared block: 32 heads of 64, causal, S 512 and 333;
    # phi3.5-moe's GQA 32 over 8 at head dim 128
    "zamba2-512": dict(b=4, hq=32, hkv=32, sq=512, skv=512, causal=True,
                       hd=64),
    "zamba2-333": dict(b=1, hq=32, hkv=32, sq=333, skv=333, causal=True,
                       hd=64),
    "phi35-gqa": dict(b=4, hq=32, hkv=8, sq=512, skv=512, causal=True,
                      hd=128),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_kernel(dev, name, dtype):
    """Each case against the plain version on the same inputs (fp32
    copies for bf16), one launch each."""
    case = dict(ATTN_CASES[name])
    b, hq, hkv, sq, skv, hd = (case.pop(k) for k in
                               ("b", "hq", "hkv", "sq", "skv", "hd"))
    nb = case.pop("nb", 0)
    bias_dtype = case.pop("bias_dtype", torch.float32)
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn(b, hq, sq, hd, generator=g).to(dev, dtype)
    k = torch.randn(b, hkv, skv, hd, generator=g).to(dev, dtype)
    v = torch.randn(b, hkv, skv, hd, generator=g).to(dev, dtype)
    bias = (torch.randn(nb, hq, sq, skv, generator=g).to(dev, bias_dtype)
            if nb else None)
    before = trace.launches("flash_attention")
    got = flash_attention_p(q, k, v, bias=bias, **case)
    assert trace.launches("flash_attention") == before + 1
    assert got.dtype == dtype
    want = ref.attention_ref(q.float(), k.float(), v.float(), bias=bias,
                             **case)
    _close(got, want, TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attention_reads_views_in_place(dev, dtype):
    """q/k/v as head views of one fused qkv output and the bias as the
    permuted view of a (t, t, heads) table, as the Swin block gives
    them: read through their strides."""
    nw, t, heads, hd = 16, 49, 3, 32
    g = torch.Generator(device="cpu").manual_seed(6)
    qkv = torch.randn(nw, t, 3 * heads * hd, generator=g).to(dev, dtype)
    q, k, v = (z.reshape(nw, t, heads, hd).permute(0, 2, 1, 3)
               for z in torch.split(qkv, heads * hd, dim=-1))
    table = torch.randn(t, t, heads, generator=g).to(dev, dtype)
    bias = table.permute(2, 0, 1)[None]
    assert not bias.is_contiguous() and not q.is_contiguous()
    got = flash_attention_p(q, k, v, bias=bias, causal=False)
    want = ref.attention_ref(q.float(), k.float(), v.float(), bias=bias,
                             causal=False)
    _close(got, want, TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attention_dense_prefill_views(dev, dtype):
    """q and k RoPE'd (new tensors), v a head view of the fused qkv
    panel (row stride 3 H hd), as ``attention.apply`` hands them to the
    kernel at S=512, causal, head dim 128."""
    from repro_torch.models import rope
    b, s, h, hd = 2, 512, 8, 128
    g = torch.Generator(device="cpu").manual_seed(7)
    qkv = torch.randn(b, s, 3 * h * hd, generator=g).to(dev, dtype)
    q, k, v = (z.reshape(b, s, h, hd) for z in
               torch.split(qkv, h * hd, dim=-1))
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    q, k = rope.apply_rope(q, pos), rope.apply_rope(k, pos)
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))
    assert v.stride(2) == 3 * h * hd
    got = flash_attention_p(q, k, v, causal=True)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True)
    _close(got, want, TOLS[dtype])


@pytest.mark.parametrize("heads", [(32, 32), (8, 2), (8, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("chunk", [1024, 128])
def test_decode_attention_bf16_products(dev, heads, chunk):
    """Decode attention in torch ops on a bf16 dense cache (B, alloc,
    Hkv, hd) at a per-row ``kv_len``: its bf16 products with fp32
    outputs on the card against the same scan on the CPU, where the
    operands are widened to fp32 first (the same products, exact in
    fp32). Only the order of the fp32 sums differs, and the bf16
    output's rounding: within two bf16 steps of max(1, max|out|)."""
    from repro_torch.models import attention
    hq, hkv = heads
    b, alloc, hd = 4, 544, 128
    g = torch.Generator(device="cpu").manual_seed(8)
    q = torch.randn(b, hq, 1, hd, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, alloc, hkv, hd, generator=g).to(torch.bfloat16)
            for _ in range(2))
    kv_len = torch.tensor([544, 513, 300, 1], dtype=torch.int32)

    def run(d):
        return attention.chunked_attention(
            q.to(d), k.to(d).transpose(1, 2), v.to(d).transpose(1, 2),
            causal=False, kv_len=kv_len.to(d), chunk=chunk)
    got, want = run(dev), run("cpu")
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, 1, hd)
    _close(got.cpu(), want, 2 ** -7)


def test_attention_refuses_unaligned_rows(dev):
    """The kernel copies q/k/v rows 16 bytes at a time: rows that are not
    16-byte aligned raise rather than run anything else."""
    x = torch.randn(1, 2, 10, 17 * 16, device=dev)[..., 1:17]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_p(x, x, x, causal=False)


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_layernorm_kernel(dev, kind):
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(300, 768, generator=g).to(dev) * 3 + 1
    gamma = (1 + 0.1 * torch.randn(768, generator=g)).to(dev)
    beta = (0.1 * torch.randn(768, generator=g)).to(dev)
    _close(layernorm_p(x, gamma, beta, kind=kind),
           ref.layernorm_ref(x, gamma, beta, kind=kind))


LN_TOLS = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the rows design takes rows of up to ROWS_MAX_D; wider ones go to cta
LN_SHAPES = [(m, d) for m in (1, 3, 4, 5, 131, 300, 2048)
             for d in (96, 333, 768, 2560, 5376, 20000)] + [
    (m, 60000) for m in (1, 4, 131)]
# (kind, beta, gamma/beta dtype: None for x's)
LN_MODES = [("layer", True, None), ("layer", False, torch.float32),
            ("rms", False, torch.bfloat16), ("rms", True, torch.float32)]


def _ln_inputs(dev, m, d, dtype, vec_dtype, beta, *, strided=False,
               seed=2):
    """x (where ``strided``, a view one element into rows of an odd
    count of elements: neither its base nor its row stride 16-byte
    aligned), gamma and beta; x at an offset, x * 3 + 1."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ld = d + (3 if d % 2 == 0 else 2) if strided else d
    x = (torch.randn(m, ld, generator=g) * 3 + 1).to(dev, dtype)
    if strided:
        x = x[:, 1:d + 1]
    vec = vec_dtype or dtype
    gamma = (1 + 0.1 * torch.randn(d, generator=g)).to(dev, vec)
    b = (0.1 * torch.randn(d, generator=g)).to(dev, vec) if beta else None
    return x, gamma, b


def _ln_check(x, gamma, beta, kind):
    """The kernel against the plain version, and again: the same bits."""
    got = layernorm_p(x, gamma, beta, kind=kind)
    again = layernorm_p(x, gamma, beta, kind=kind)
    want = ref.layernorm_ref(x.float(), gamma, beta, kind=kind)
    _close(got, want, LN_TOLS[x.dtype])
    assert got.dtype == x.dtype and got.is_contiguous()
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("design", ["cta", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", LN_SHAPES, ids=str)
def test_layernorm_designs(dev, monkeypatch, design, dtype, shape):
    """Each design (the picker's threshold moved past M or to 0) at
    every mode: LayerNorm and RMSNorm, with and without beta, gamma and
    beta in fp32 or bf16. Rows wider than ``ROWS_MAX_D`` take the cta
    design (registers, shared memory, or L2 re-reads past 227 KB)."""
    m, d = shape
    monkeypatch.setitem(ln.CTA_PICK_M, dtype, 1 << 30 if design == "cta"
                        else 0)
    assert ln.pick_design(m, d, dtype) == (
        "cta" if design == "cta" or d > ln.ROWS_MAX_D[dtype] else "rows")
    for kind, with_beta, vec in LN_MODES:
        before = trace.launches("layernorm")
        _ln_check(*_ln_inputs(dev, m, d, dtype, vec, with_beta), kind)
        assert trace.launches("layernorm") == before + 2


@pytest.mark.parametrize("design", ["cta", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 96), (5, 333), (131, 768),
                                   (300, 2560), (4, 20000), (1, 60000)],
                         ids=str)
def test_layernorm_unaligned_rows(dev, monkeypatch, design, dtype, shape):
    """A strided view whose base and row stride are not 16-byte aligned
    runs in the kernel (element-wise loads), as aligned rows do."""
    monkeypatch.setitem(ln.CTA_PICK_M, dtype, 1 << 30 if design == "cta"
                        else 0)
    x, gamma, beta = _ln_inputs(dev, *shape, dtype, None, True,
                                strided=True)
    assert x.data_ptr() % 16 and (x.stride(0) * x.element_size()) % 16
    _ln_check(x, gamma, beta, "layer")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 64, 65, 131, 264])
@pytest.mark.parametrize("d", [96, 768, 2560])
def test_layernorm_designs_either_side(dev, monkeypatch, dtype, m, d):
    """The cta and the rows design at the same M (the picker's threshold
    moved to M and to M - 1) agree with each other within tolerance."""
    x, gamma, beta = _ln_inputs(dev, m, d, dtype, None, True, seed=5)
    outs = {}
    for pick in (m, m - 1):
        monkeypatch.setitem(ln.CTA_PICK_M, dtype, pick)
        outs[ln.pick_design(m, d, dtype)] = _ln_check(x, gamma, beta,
                                                      "layer")
    assert set(outs) == {"cta", "rows"}
    _close(outs["cta"], outs["rows"], LN_TOLS[dtype])


def test_layernorm_refuses_operands_on_two_devices(dev):
    x = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError, match="tensors on"):
        layernorm_p(x, torch.ones(8))
    with pytest.raises(ValueError, match="tensors on"):
        layernorm_p(x, torch.ones(8, device=dev), torch.ones(8))


@pytest.mark.parametrize("fuse", [True, False])
def test_swin_forward_on_kernels(dev, fuse):
    cfg = reduced()
    model = vision.SwinTransformer(cfg, device=dev)
    x = torch.randn(2, 56, 56, 3, generator=torch.Generator().manual_seed(3))
    x = x.to(dev)
    with torch.no_grad(), runtime.use_pipeline_fusion(fuse):
        got = model(x)
        with runtime.use_impl("ref"):
            want = model(x)
    _close(got, want, 1e-3)


def _wkv_inputs(dev, shape, dtype, with_s0, seed=4):
    b, s, h, p = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, p, generator=g).to(dev, dtype)
               for _ in range(3))
    lw = torch.clamp(-torch.exp(2 * torch.randn(b, s, h, p, generator=g)),
                     -rwkv6.CLAMP, -1e-6).to(dev, dtype)
    u = torch.randn(h, p, generator=g).to(dev)
    s0 = (torch.randn(b, h, p, p, generator=g).to(dev) if with_s0
          else None)
    return r, k, v, lw, u, s0


def _wkv_check(dev, shape, dtype, with_s0):
    r, k, v, lw, u, s0 = _wkv_inputs(dev, shape, dtype, with_s0)
    before = trace.launches("wkv")
    y, s_fin = wkv_p(r, k, v, lw, u, s0=s0)
    assert trace.launches("wkv") == before + 1
    assert y.dtype == dtype and s_fin.dtype == torch.float32
    want_y, want_s = rwkv6.wkv_chunked(*(t.float() for t in (r, k, v, lw)),
                                       u, s0=s0)
    _close(y, want_y, TOLS[dtype])
    _close(s_fin, want_s, 1e-4)
    return y, s_fin


# S = 1 and 2 (step design), 15, 16, 17 (a chunk's edges), the ragged 333;
# B=1 at RWKV6-3B's 40 heads; head dims 16, 32, 64
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("shape", [(2, 45, 3, 16), (1, 7, 2, 64),
                                   (4, 1, 40, 64), (1, 333, 4, 64),
                                   (2, 17, 2, 32), (1, 1, 40, 64),
                                   (1, 2, 40, 64), (1, 15, 40, 64),
                                   (1, 16, 40, 64), (1, 17, 40, 64),
                                   (1, 333, 40, 64), (3, 16, 2, 16),
                                   (2, 2, 3, 32)], ids=str)
def test_wkv_kernel(dev, shape, with_s0, dtype):
    _wkv_check(dev, shape, dtype, with_s0)


@pytest.mark.parametrize("step_upto", [0, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 1, 40, 64), (2, 16, 3, 32),
                                   (1, 45, 2, 64), (2, 5, 2, 16)], ids=str)
def test_wkv_designs_either_side(dev, monkeypatch, shape, dtype,
                                 step_upto):
    """The chunk and the step design at the same S (the picker's
    threshold moved to 0 or past S), with a starting state, each against
    the plain scan; each repeats bitwise."""
    monkeypatch.setattr(wk, "STEP_PICK_S", step_upto)
    assert wk.pick_design(shape[1]) == ("step" if step_upto else "chunk")
    y, s_fin = _wkv_check(dev, shape, dtype, True)
    *args, s0 = _wkv_inputs(dev, shape, dtype, True)
    again = wkv_p(*args, s0=s0)
    assert torch.equal(y, again[0]) and torch.equal(s_fin, again[1])


def test_wkv_chunk_refuses_unaligned_rows(dev, monkeypatch):
    """The chunk design copies 16-byte rows: a misaligned head dim offset
    raises rather than run anything else."""
    monkeypatch.setattr(wk, "STEP_PICK_S", 0)
    x = (-torch.rand(1, 40, 2, 65, device=dev))[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        wkv_p(x, x, x, x, torch.ones(2, 64, device=dev))


def _ssd_inputs(dev, shape, *, with_s0, strong=False, seed=6):
    """x, B and C as the mixer hands them over: column views of one conv
    output (silu applied); dt log-uniform over [1e-3, 0.1] and A_log
    uniform over [0, log 16] (Mamba2's own init), or with ``strong`` dt
    = softplus(N(1, 1)), decays to e^-70 a token."""
    b, s, h, p, n, _chunk = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    d_in = h * p
    conv = torch.nn.functional.silu(
        torch.randn(b, s, d_in + 2 * n, generator=g)).to(dev)
    xh = conv[..., :d_in].view(b, s, h, p)
    B, C = conv[..., d_in:d_in + n], conv[..., d_in + n:]
    if strong:
        dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g)
                                          + 1)
    else:
        dt = torch.exp(math.log(1e-3) + torch.rand(b, s, h, generator=g)
                       * math.log(100))
    a = -torch.exp(torch.rand(h, generator=g) * math.log(16))
    D = torch.randn(h, generator=g)
    s0 = torch.randn(b, h, p, n, generator=g) if with_s0 else None
    return [xh, dt.to(dev), a.to(dev), B, C, D.to(dev),
            None if s0 is None else s0.to(dev)]


def _ssd_check(dev, shape, *, with_s0, strong=False):
    """The kernel (two launches) against the per-step scan in float64 and
    the chunked scan in fp32, y and the final state each."""
    chunk = shape[-1]
    xh, dt, a, B, C, D, s0 = _ssd_inputs(dev, shape, with_s0=with_s0,
                                         strong=strong)
    before = trace.launches("ssd")
    y, st = ssd.ssd_p(xh, dt, a, B, C, D, chunk=chunk, s0=s0)
    assert trace.launches("ssd") == before + 2
    assert y.dtype == st.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    f64 = [None if t is None else t.double()
           for t in (xh, dt, a, B, C, s0)]
    ry, rs = mamba2.ssd_ref(*f64[:5], s0=f64[5])
    _close(y, ry + D.double()[None, None, :, None] * xh.double())
    _close(st, rs)
    py, ps = ssd.ssd_plain(xh, dt, a, B, C, D, chunk=chunk, s0=s0)
    _close(y, py)
    _close(st, ps)
    return (xh, dt, a, B, C, D, s0), (y, st)


# (B, S, H, P, N, chunk): granite-4.0-h-small's mixer at the benchmark
# mix's least and longest B=8 batches, zamba2-1.2b's at B=4 x 512 and a
# ragged 1 x 333, their reduced configs (P 16, N 16, chunk 8; P 32, N
# 16), a decode step (S = 1) of each full config, and the other (P, N)
SSD_SHAPES = [(8, 407, 128, 64, 128, 256), (8, 5526, 128, 64, 128, 256),
              (4, 512, 64, 64, 64, 128), (1, 333, 64, 64, 64, 128),
              (2, 45, 8, 16, 16, 8), (2, 21, 4, 32, 16, 128),
              (8, 1, 128, 64, 128, 256), (4, 1, 64, 64, 64, 128),
              (2, 70, 3, 16, 64, 128), (2, 130, 2, 16, 128, 128),
              (2, 300, 3, 32, 64, 256), (1, 257, 2, 32, 128, 256),
              (2, 200, 2, 64, 16, 256), (1, 9, 2, 16, 16, 8)]


@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_kernel(dev, shape, with_s0):
    _ssd_check(dev, shape, with_s0=with_s0)


@pytest.mark.parametrize("shape", [(8, 407, 128, 64, 128, 256),
                                   (2, 300, 3, 32, 64, 128),
                                   (2, 45, 8, 16, 16, 8)], ids=str)
def test_ssd_kernel_strong_decay(dev, shape):
    """Decays down to e^-70 a token (log decays summed to -10^4 over a
    chunk): every factor the kernel takes stays at most 1, so nothing
    overflows, and the scan holds to the float64 one."""
    _ssd_check(dev, shape, with_s0=True, strong=True)


def test_ssd_kernel_views_copies_and_repeats(dev):
    """The conv output's column views and contiguous copies of them give
    the same bits, and a call repeats bitwise."""
    shape = (2, 300, 4, 64, 128, 256)
    args, (y, st) = _ssd_check(dev, shape, with_s0=True)
    copies = [t if t is None else t.contiguous() for t in args]
    for again in (ssd.ssd_p(*copies[:6], chunk=256, s0=copies[6]),
                  ssd.ssd_p(*args[:6], chunk=256, s0=args[6])):
        assert torch.equal(again[0], y) and torch.equal(again[1], st)


@pytest.mark.parametrize("split", [1, 200, 256, 333])
def test_ssd_kernel_state_continues(dev, split):
    """A prefix, then the rest (a decode step at split 333) from the
    prefix's final state, equals the scan over the whole."""
    shape = (2, 334, 4, 64, 128, 256)
    xh, dt, a, B, C, D, s0 = _ssd_inputs(dev, shape, with_s0=True)
    y, st = ssd.ssd_p(xh, dt, a, B, C, D, chunk=256, s0=s0)
    y1, s1 = ssd.ssd_p(xh[:, :split], dt[:, :split], a, B[:, :split],
                       C[:, :split], D, chunk=256, s0=s0)
    y2, s2 = ssd.ssd_p(xh[:, split:], dt[:, split:], a, B[:, split:],
                       C[:, split:], D, chunk=256, s0=s1)
    _close(torch.cat([y1, y2], 1), y)
    _close(s2, st)


def test_ssd_kernel_refuses_unaligned_rows(dev):
    """x, B and C are read 16 bytes at a time: a view off that alignment
    raises rather than run anything else."""
    xh, dt, a, B, C, D, _ = _ssd_inputs(dev, (1, 40, 2, 16, 16, 8),
                                        with_s0=False)
    off = torch.randn(1, 40, 17, device=dev)[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        ssd.ssd_p(xh, dt, a, off, C, D, chunk=8)


def test_rwkv_prefill_and_decode_on_kernels(dev):
    """Reduced RWKV6 with its decay LoRA, token-shift mixes and ``w0``
    spread (some channels clamp at -3.5, some at -1e-6): a ragged
    prefill and three decode steps on the kernels against the plain
    path on the card, teacher-forced on the same tokens."""
    cfg = get_reduced("rwkv6-3b")
    g = torch.Generator(device="cpu").manual_seed(5)
    model = lm.LanguageModel(cfg, device=dev, dtype=torch.float32,
                             generator=g)
    with torch.no_grad():
        for blk in model.params.tree()["stages"][0]["stacked"].values():
            tmix, ffn = blk["tmix"], blk["ffn"]
            tmix["w0"].copy_(torch.rand(tmix["w0"].shape, generator=g) * 18
                             - 16)
            tmix["w_lora_b"].copy_(
                0.1 * torch.randn(tmix["w_lora_b"].shape, generator=g))
            for t in (tmix["mu"], ffn["mu_k"], ffn["mu_r"]):
                t.copy_(torch.rand(t.shape, generator=g))
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g).to(dev)
    with torch.no_grad():
        got, cache = model.prefill(toks[:, :21])
        with runtime.use_impl("ref"):
            want, want_cache = model.prefill(toks[:, :21])
        _close(got, want, 1e-3)
        lengths = torch.full((2,), 21, dtype=torch.int32, device=dev)
        for t in range(21, 24):
            before = trace.launches("wkv")
            got, cache = model.decode_step(cache, toks[:, t:t + 1], lengths)
            assert trace.launches("wkv") == before + cfg.n_layers
            with runtime.use_impl("ref"):
                want, want_cache = model.decode_step(
                    want_cache, toks[:, t:t + 1], lengths)
            _close(got, want, 1e-3)
            lengths = lengths + 1
        _close(cache[0]["0"]["rwkv_t"]["wkv"],
               want_cache[0]["0"]["rwkv_t"]["wkv"], 1e-3)


@pytest.mark.parametrize("arch", ["deepseek-7b", "internlm2-20b",
                                  "granite-20b"])
def test_dense_prefill_and_decode_on_kernels(dev, arch):
    """The reduced dense LMs (internlm2 with a head dim of 16, the
    kernel's least) with jittered norms: a ragged prefill into a cache
    of 24 and three decode steps on the kernels against the plain path
    on the card, teacher-forced on the same tokens, each path with its
    own cache; launches per prefill and per step 4 L + 1 matmuls (qkv,
    wo, the gated or plain first MLP matmul, the second; the head), 1
    norm (and 2 L more at prefill, whose 42 rows take the ffma design:
    its prologue panels split; the 2 rows of a step keep theirs on the
    skinny design), and L attention at prefill (decode attends in torch
    ops)."""
    import dataclasses
    cfg = get_reduced(arch)
    if cfg.head_dim < 16:
        cfg = dataclasses.replace(cfg, head_dim=16)
    g = torch.Generator(device="cpu").manual_seed(5)
    model = lm.LanguageModel(cfg, device=dev, dtype=torch.float32,
                             generator=g)
    with torch.no_grad():
        tree = model.params.tree()
        for norm in [blk[n] for blk in tree["stages"][0]["stacked"].values()
                     for n in ("norm1", "norm2")] + [tree["final_norm"]]:
            for t in norm.values():
                t.add_(0.1 * torch.randn(t.shape, generator=g).to(dev))
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g).to(dev)
    counts = ("rowwise_matmul", "flash_attention", "layernorm")
    with torch.no_grad():
        before = _counts(counts)
        got, cache = model.prefill(toks[:, :21], alloc=24)
        assert _since(counts, before) == [
            4 * cfg.n_layers + 1, cfg.n_layers, 1 + 2 * cfg.n_layers]
        with runtime.use_impl("ref"):
            want, want_cache = model.prefill(toks[:, :21], alloc=24)
        _close(got, want, 1e-3)
        lengths = torch.full((2,), 21, dtype=torch.int32, device=dev)
        for t in range(21, 24):
            before = _counts(counts)
            got, cache = model.decode_step(cache, toks[:, t:t + 1], lengths)
            assert _since(counts, before) == [
                4 * cfg.n_layers + 1, 0, 1]
            with runtime.use_impl("ref"):
                want, want_cache = model.decode_step(
                    want_cache, toks[:, t:t + 1], lengths)
            _close(got, want, 1e-3)
            lengths = lengths + 1
        for a, b in zip(cache[0]["0"]["kv"], want_cache[0]["0"]["kv"]):
            _close(a, b, 1e-3)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-moe-a2.7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_hybrid_and_moe_on_kernels(dev, arch):
    """The reduced Mamba2 hybrid and MoE LMs (jittered norms and Mamba
    vectors) on the kernels against the plain path on the card: a
    ragged prefill into a cache of 24 and three decode steps,
    teacher-forced, each path with its own cache; the final caches
    (every Mamba ``conv`` and ``ssm``, the KV) agree. Launches a call:
    zamba2 2 matmuls and 2 norms a Mamba layer, 4, 1 attention at
    prefill and 2 norms (split or kept: ``norm_prologue_fits``) a
    shared-block repeat, and the SSD scan's 2 a Mamba layer (prefill
    and step); MoE 2 matmuls, 2 norms (1 where the qkv norm stays in the
    prologue) and 1 attention at prefill a layer; the head and the final
    norm."""
    cfg = get_reduced(arch)
    g = torch.Generator(device="cpu").manual_seed(5)
    model = lm.LanguageModel(cfg, device=dev, dtype=torch.float32,
                             generator=g)
    with torch.no_grad():
        tree = model.params.tree()
        for stage in tree["stages"]:
            for blk in [*stage["stacked"].values(), *stage["shared"].values()]:
                vecs = [t for n in ("norm1", "norm2") if n in blk
                        for t in blk[n].values()]
                if "mamba" in blk:
                    vecs += [blk["mamba"][k] for k in ("A_log", "dt_bias",
                                                       "D", "conv_b",
                                                       "norm_g")]
                for t in vecs:
                    t.add_(0.3 * torch.randn(t.shape, generator=g).to(dev))
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g).to(dev)
    counts = ("rowwise_matmul", "flash_attention", "layernorm", "ssd")
    d, L = cfg.d_model, cfg.n_layers

    def want(rows, prefill):
        split = 0 if rm.norm_prologue_fits(rows, d, torch.float32) else 1
        if cfg.moe is not None:
            return [2 * L + 1, L if prefill else 0, L * (1 + split) + 1, 0]
        attn = sum(st.repeat for st in cfg.stages()
                   for b in st.body if b.mixer == "attn")
        mamba = L - attn
        return [2 * mamba + 4 * attn + 1, attn if prefill else 0,
                2 * mamba + 2 * split * attn + 1, 2 * mamba]
    with torch.no_grad():
        before = _counts(counts)
        got, cache = model.prefill(toks[:, :21], alloc=24)
        assert _since(counts, before) == want(
            42, True)
        with runtime.use_impl("ref"):
            want_lg, want_cache = model.prefill(toks[:, :21], alloc=24)
        _close(got, want_lg, 1e-3)
        lengths = torch.full((2,), 21, dtype=torch.int32, device=dev)
        for t in range(21, 24):
            before = _counts(counts)
            got, cache = model.decode_step(cache, toks[:, t:t + 1], lengths)
            assert _since(counts, before) == want(
                2, False)
            with runtime.use_impl("ref"):
                want_lg, want_cache = model.decode_step(
                    want_cache, toks[:, t:t + 1], lengths)
            _close(got, want_lg, 1e-3)
            lengths = lengths + 1
        leaves = torch.utils._pytree.tree_leaves
        for a, b in zip(leaves(cache), leaves(want_cache)):
            _close(a, b, 1e-3)


@pytest.mark.parametrize("arch", ["gemma3-27b", "whisper-base"])
def test_window_and_encdec_on_kernels(dev, arch):
    """gemma3-smoke (16-token window, prompts past it, decode across the
    ring's wrap) and whisper-smoke (encoder, cross-attention; frames of
    cross_len) on the kernels against the plain path on the card,
    teacher-forced, each path with its own cache; launches per prefill
    and per step: gemma3 4 L + 1 matmuls, L attention at prefill, 1 norm
    (+ 2 L where the prologue splits); whisper 4 matmuls and 1 attention
    an encoder layer, 7 matmuls (qkv, wo, wq, wkv, cross wo, mlp1, mlp2;
    6 at decode: no wkv) and 2 attention a decoder layer at prefill, the
    cross norm each layer and the final norms; + 2 norms a layer at
    prefill, whose rows (42, and the encoder's 2 x cross_len) take the
    ffma design and split its prologue panels, none at a step of 2 rows
    (skinny: the prologue stays, d_model <= SKINNY_NORM_MAX_K)."""
    cfg = get_reduced(arch)
    g = torch.Generator(device="cpu").manual_seed(12)
    model = lm.LanguageModel(cfg, device=dev, dtype=torch.float32,
                             generator=g)
    with torch.no_grad():
        tree = model.params.tree()
        for t in [t for tr in (tree, tree.get("enc", {})) for stage in
                  tr.get("stages", []) for blk in stage["stacked"].values()
                  for n in ("norm1", "norm2", "norm_x") if n in blk
                  for t in blk[n].values()]:
            t.add_(0.1 * torch.randn(t.shape, generator=g).to(dev))
    s, steps, b = 21, 6, 2
    toks = torch.randint(0, cfg.vocab, (b, s + steps), generator=g).to(dev)
    extra = ({"frames": torch.randn(b, cfg.cross_len, cfg.d_model,
                                    generator=g).to(dev)}
             if cfg.encdec else None)
    L = cfg.n_layers
    if cfg.encdec:
        enc = cfg.n_enc_layers
        pre = [4 * enc + 7 * L + 1, enc + 2 * L, 2 + L + 2 * enc + 2 * L]
        step = [6 * L + 1, 0, 1 + L]
    else:
        pre = [4 * L + 1, L, 1 + 2 * L]
        step = [4 * L + 1, 0, 1]
    counts = ("rowwise_matmul", "flash_attention", "layernorm")
    with torch.no_grad():
        before = _counts(counts)
        got, cache = model.prefill(toks[:, :s], alloc=s + steps, extra=extra)
        assert _since(counts, before) == pre
        with runtime.use_impl("ref"):
            want, want_cache = model.prefill(toks[:, :s], alloc=s + steps,
                                             extra=extra)
        _close(got, want, 1e-3)
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        for t in range(s, s + steps):
            before = _counts(counts)
            got, cache = model.decode_step(cache, toks[:, t:t + 1], lengths)
            assert _since(counts, before) == step
            with runtime.use_impl("ref"):
                want, want_cache = model.decode_step(
                    want_cache, toks[:, t:t + 1], lengths)
            _close(got, want, 1e-3)
            lengths = lengths + 1
        for a, w in zip(_tensors(cache), _tensors(want_cache)):
            _close(a, w, 1e-3)


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tensors(t)]
    return [tree]


def _paged_schedule(model, toks, dev):
    """A fixed paged schedule on the card: a bucketed prefill of 11
    tokens (bucket 16) + ``insert_prefill`` into slot 0; 37 tokens of
    slot 1 in chunks of 16 (past gemma3-smoke's 16-token window: its ring
    wraps mid-prompt); three lockstep decode steps; a verify panel of 4
    with 3 and 2 rows kept; a copy-on-write of slot 0's second page into
    a free page, remapped; two more steps. Teacher-forced on ``toks``.
    Returns the logits of every call, its launches (matmul, attention,
    layernorm) by kind and the cache."""
    cfg, tree = model.cfg, model.params.tree()
    ps = 4
    cache = lm.init_paged_cache(cfg, 2, 64, page_size=ps, n_pages=40,
                                dtype=torch.float32, device=dev)
    tables = torch.arange(32, dtype=torch.int32, device=dev).reshape(2, 16)
    kernels = ("rowwise_matmul", "flash_attention", "layernorm")
    out, counts = [], []

    def run(kind, fn):
        before = _counts(kernels)
        lg, cache = fn()
        torch.cuda.synchronize()
        counts.append((kind, _since(kernels, before)))
        out.append(lg)
        return cache

    def admit():
        t = torch.zeros(1, 16, dtype=torch.long, device=dev)
        t[0, :11] = toks[0, :11]
        lg, st = lm.prefill_states(tree, t, cfg, last_pos=11)
        return lg, lm.insert_prefill(cfg, cache, st, slot=0,
                                     pages=tables[0], plen=11, page_size=ps)
    cache = run("prefill", admit)
    for off, clen in ((0, 16), (16, 16), (32, 5)):
        t = torch.zeros(1, 16, dtype=torch.long, device=dev)
        t[0, :clen] = toks[1, off:off + clen]
        cache = run("chunk", lambda t=t, off=off, clen=clen: lm.prefill_chunk(
            tree, cache, t, cfg, offset=off, chunk_len=clen,
            pages=tables[1:2]))
    lengths = torch.tensor([11, 37], dtype=torch.int32, device=dev)
    for i in range(3):
        cache = run("step", lambda i=i: lm.decode_step(
            tree, cache, toks[:, 40 + i:41 + i], lengths + i, cfg,
            pages=tables))
    lengths = lengths + 3
    panel = toks[:, 50:54]
    clen = torch.full((2,), 4, dtype=torch.int32, device=dev)
    lg, st = lm.verify_states(tree, cache, panel, cfg, offset=lengths,
                              chunk_len=clen, pages=tables)
    out.append(lg)
    cache = lm.insert_verify(cfg, cache, st, pages=tables, offset=lengths,
                             n_keep=torch.tensor([3, 2], device=dev))
    lengths = lengths + torch.tensor([3, 2], dtype=torch.int32, device=dev)
    cache = lm.cow_copy(cache, 1, 35)
    tables[0, 1] = 35
    for i in range(2):
        cache = run("step", lambda i=i: lm.decode_step(
            tree, cache, toks[:, 60 + i:61 + i], lengths + i, cfg,
            pages=tables))
    return out, counts, cache


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-27b"])
def test_paged_serving_on_kernels(dev, arch):
    """The paged serving core on the reduced configs (norm gains
    jittered) on the kernels against the plain path on the card, each
    with its own cache, on the schedule of :func:`_paged_schedule`: the
    logits of every call within 1e-3 and every pool leaf after it; the
    bucketed prefill launches what a dense prefill of its 16 rows does
    (4 L + 1 matmuls, L attention), a chunk and a step no attention, the
    norms split where their design drops the prologue."""
    cfg = get_reduced(arch)
    g = torch.Generator(device="cpu").manual_seed(9)
    model = lm.LanguageModel(cfg, device=dev, dtype=torch.float32,
                             generator=g)
    with torch.no_grad():
        tree = model.params.tree()
        for norm in [blk[n] for stage in tree["stages"]
                     for blk in stage["stacked"].values()
                     for n in ("norm1", "norm2")] + [tree["final_norm"]]:
            for t in norm.values():
                t.add_(0.1 * torch.randn(t.shape, generator=g).to(dev))
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=g).to(dev)
    with torch.no_grad():
        got, counts, cache = _paged_schedule(model, toks, dev)
        with runtime.use_impl("ref"):
            want, _, want_cache = _paged_schedule(model, toks, dev)
    for a, b in zip(got, want):
        _close(a, b, 1e-3)
    for a, b in zip(_tensors(cache), _tensors(want_cache)):
        _close(a, b, 1e-3)
    L = cfg.n_layers

    def norms(rows):
        return 1 + (0 if rm.norm_prologue_fits(rows, cfg.d_model,
                                               torch.float32) else 2 * L)
    want_counts = {"prefill": [4 * L + 1, L, norms(16)],
                   "chunk": [4 * L + 1, 0, norms(16)],
                   "step": [4 * L + 1, 0, norms(2)]}
    for kind, c in counts:
        assert c == want_counts[kind], (kind, c)


def _engine_run(tree, cfg, device, prompts):
    """The reduced engine of :func:`test_engine_on_kernels` on
    ``device``: its completions and its device reads a call."""
    from repro_torch.core.types import PagingConfig
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paging import supports_bucketing
    bucketing = supports_bucketing(cfg)
    eng = Engine(tree, cfg, n_slots=2, max_len=64, eos_id=-1, device=device,
                 paging=PagingConfig(page_size=8,
                                     prefill_chunk=16 if bucketing else 0,
                                     prefix_cache=bucketing,
                                     speculate_k=3 if bucketing else 0))
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=8))
    done = sorted(eng.run(), key=lambda c: c.rid)
    eng.pool.check_conservation()
    assert not eng.errors, eng.errors
    return done, eng


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-27b", "rwkv6-3b",
                                  "zamba2-1.2b", "qwen2-moe-a2.7b"])
def test_engine_on_kernels(dev, arch):
    """The serving engine at a reduced size on the card (the kernels)
    against the same engine on the CPU (the plain path), on the same
    weights and requests (chunked, a prefix hit, speculation; rwkv6 at
    exact lengths): every status ok on both, every greedy stream equal up
    to the first near-tie (a top-2 gap of the CPU's dense logits within
    1e-3 x max(1, max|logit|) at the first differing token)."""
    cfg = get_reduced(arch)
    tree = lm.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu",
                      dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    base = torch.randint(0, cfg.vocab, (40,), generator=g)
    prompts = [base, torch.randint(0, cfg.vocab, (9,), generator=g),
               torch.randint(0, cfg.vocab, (3,), generator=g).repeat(11),
               base.clone()]
    want, _ = _engine_run(tree, cfg, "cpu", prompts)
    on_card = lm._tree_map(lambda t: t.to(dev), tree)
    got, eng = _engine_run(on_card, cfg, dev, prompts)
    assert eng.device_reads > 0
    for c, w, p in zip(got, want, prompts):
        assert c.status == w.status == "ok"
        if c.tokens == w.tokens:
            continue
        j = next(i for i, (a, b) in enumerate(zip(c.tokens, w.tokens))
                 if a != b)
        with torch.no_grad():
            stream = torch.cat([p, torch.tensor(w.tokens[:j])])[None]
            logits = lm.forward(tree, stream, cfg)[0][0, -1, :cfg.vocab]
        top2 = logits.topk(2).values
        assert top2[0] - top2[1] <= 1e-3 * max(1.0, logits.abs().max()), (
            c.rid, j)


# ------------------- gradients through the kernel path ------------------


def _grads(call, inputs, impl):
    """The gradients of sum(call() * r) with respect to ``inputs`` under
    ``impl`` (the kernel path "auto" or the plain path "ref")."""
    with runtime.use_impl(impl):
        out = call()
        outs = out if isinstance(out, tuple) else (out,)
        g = torch.Generator(device="cuda").manual_seed(99)
        loss = sum((o.float() * torch.randn(o.shape, generator=g,
                                            device="cuda")).sum()
                   for o in outs)
        return torch.autograd.grad(loss, inputs)


def _leaves_on(dev, dtype, seed, *shapes, scale=0.3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [(torch.randn(*s, generator=g) * scale).to(dev, dtype)
            .requires_grad_(True) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("k", [64, 1536])
def test_matmul_grads_on_kernels(dev, dtype, k):
    """``ops.matmul`` (bias, residual, a norm in the prologue at K = 64
    on the skinny rows, split at K = 1536) and ``ops.gate_up_proj`` over
    one ``wgi`` leaf: every input's gradient on the kernel path against
    the plain path's, the kernels launched once each forward."""
    tol = TOLS[dtype]
    x, w, bias, res, gamma, wgi, bgi = _leaves_on(
        dev, dtype, 0, (2, 3, k), (k, 96), (96,), (2, 3, 96), (k,),
        (k, 192), (192,))
    norm = ops.NormSpec("rms", gamma)
    before = trace.launches("rowwise_matmul")
    for call, ins in (
            (lambda: ops.matmul(x, w, bias=bias, residual=res, norm=norm),
             [x, w, bias, res, gamma]),
            (lambda: ops.gate_up_proj(x, wgi, activation="silu", bias=bgi,
                                      norm=norm), [x, wgi, bgi, gamma]),
            (lambda: ops.gate_up_proj(x, wgi, activation="gelu", bias=bgi),
             [x, wgi, bgi])):
        got = _grads(call, ins, "auto")
        want = _grads(call, ins, "ref")
        for a, b in zip(got, want):
            _close(a, b, tol)
    assert trace.launches("rowwise_matmul") == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [0, 100])
def test_attention_group6_on_kernels(dev, dtype, window):
    """Attention at qwen2-vl-2b's heads (12 over 2: a group of 6) and
    head dim 128, causal, with and without a window: the kernel's output
    against the plain version, and its gradients (the flash backward)
    against the plain path's."""
    tol = TOLS[dtype]
    q, k, v = _leaves_on(dev, dtype, 1, (2, 12, 333, 128), (2, 2, 333, 128),
                         (2, 2, 333, 128), scale=1.0)
    before = trace.launches("flash_attention")
    with torch.no_grad():
        got = flash_attention_p(q, k, v, causal=True, window=window)
        want = ref.attention_ref(q, k, v, causal=True, window=window)
    assert trace.launches("flash_attention") == before + 1
    _close(got, want, tol)

    def call():
        return ops.attention(q, k, v, causal=True, window=window)
    for a, b in zip(_grads(call, [q, k, v], "auto"),
                    _grads(call, [q, k, v], "ref")):
        _close(a, b, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_layernorm_and_wkv_grads_on_kernels(dev, dtype):
    """``ops.layernorm`` (RMS, and LayerNorm with beta, at D = 1536) and
    ``ops.wkv`` (RWKV6-3B's heads of 64): gradients on the kernel path
    against the plain path's."""
    tol = TOLS[dtype]
    x, gamma, beta = _leaves_on(dev, dtype, 2, (4, 9, 1536), (1536,),
                                (1536,))
    for kind, b in (("rms", None), ("layer", beta)):
        ins = [x, gamma] + ([b] if b is not None else [])
        call = (lambda b=b, kind=kind:
                ops.layernorm(x, gamma, b, kind=kind))
        for a, w in zip(_grads(call, ins, "auto"), _grads(call, ins, "ref")):
            _close(a, w, tol)
    r, k, v, u = _leaves_on(dev, dtype, 3, (2, 40, 4, 64), (2, 40, 4, 64),
                            (2, 40, 4, 64), (4, 64))
    lw = (-torch.rand(2, 40, 4, 64, device=dev) - 0.1).to(dtype) \
        .requires_grad_(True)
    before = trace.launches("wkv")
    got = _grads(lambda: ops.wkv(r, k, v, lw, u), [r, k, v, lw, u], "auto")
    assert trace.launches("wkv") == before + 1
    want = _grads(lambda: ops.wkv(r.float(), k.float(), v.float(),
                                  lw.float(), u.float()),
                  [r, k, v, lw, u], "ref")
    for a, w in zip(got, want):
        _close(a, w, tol)
