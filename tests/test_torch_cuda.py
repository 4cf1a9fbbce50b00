"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips. On a machine with one
(the JAX package is not needed, so the JAX-importing conftest is left
out):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

fp32 tolerance 1e-4 against max(1, max|plain|): only the order of the
fp32 sums differs. bf16: 3e-2, the output (and the WKV y) is rounded to
bf16 (8-bit mantissa) where the plain version keeps fp32 (attention also
rounds its probabilities to bf16 before the PV product, as JAX does). int8: 1e-5,
the int32 sums are exact (the plain version multiplies in float64 on
the card), so only the fp32 dequant and activations differ.
"""
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.swin_t import reduced
from repro_torch.core import quant, runtime
from repro_torch.kernels import layernorm as ln
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels import rowwise_matmul as rm
from repro_torch.kernels import wkv as wk
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.kernels.wkv import wkv_p
from repro_torch.models import lm, rwkv6, vision

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    before = rowwise_matmul_p.launches
    got = rowwise_matmul_p(x, w, **kw)
    assert rowwise_matmul_p.launches == before + 1
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
    before = rowwise_matmul_p.launches
    got = rowwise_matmul_p(x, w, **kw)
    assert rowwise_matmul_p.launches == before + 1
    _close(got, want, TOLS[dtype])


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
    design = rm.pick_design(2 * m, dtype)
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
            before = (rowwise_matmul_p.launches, layernorm_p.launches)
            got = fn()
            assert (rowwise_matmul_p.launches - before[0],
                    layernorm_p.launches - before[1]) == (1, splits)
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
    before = flash_attention_p.launches
    got = flash_attention_p(q, k, v, bias=bias, **case)
    assert flash_attention_p.launches == before + 1 and got.dtype == dtype
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
        before = layernorm_p.launches
        _ln_check(*_ln_inputs(dev, m, d, dtype, vec, with_beta), kind)
        assert layernorm_p.launches == before + 2


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
    before = wkv_p.launches
    y, s_fin = wkv_p(r, k, v, lw, u, s0=s0)
    assert wkv_p.launches == before + 1
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
            before = wkv_p.launches
            got, cache = model.decode_step(cache, toks[:, t:t + 1], lengths)
            assert wkv_p.launches == before + cfg.n_layers
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
    counts = (rowwise_matmul_p, flash_attention_p, layernorm_p)
    with torch.no_grad():
        before = [k.launches for k in counts]
        got, cache = model.prefill(toks[:, :21], alloc=24)
        assert [k.launches - b for k, b in zip(counts, before)] == [
            4 * cfg.n_layers + 1, cfg.n_layers, 1 + 2 * cfg.n_layers]
        with runtime.use_impl("ref"):
            want, want_cache = model.prefill(toks[:, :21], alloc=24)
        _close(got, want, 1e-3)
        lengths = torch.full((2,), 21, dtype=torch.int32, device=dev)
        for t in range(21, 24):
            before = [k.launches for k in counts]
            got, cache = model.decode_step(cache, toks[:, t:t + 1], lengths)
            assert [k.launches - b for k, b in zip(counts, before)] == [
                4 * cfg.n_layers + 1, 0, 1]
            with runtime.use_impl("ref"):
                want, want_cache = model.decode_step(
                    want_cache, toks[:, t:t + 1], lengths)
            _close(got, want, 1e-3)
            lengths = lengths + 1
        for a, b in zip(cache[0]["0"]["kv"], want_cache[0]["0"]["kv"]):
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
    counts = (rowwise_matmul_p, flash_attention_p, layernorm_p)
    with torch.no_grad():
        before = [k.launches for k in counts]
        got, cache = model.prefill(toks[:, :s], alloc=s + steps, extra=extra)
        assert [k.launches - n for k, n in zip(counts, before)] == pre
        with runtime.use_impl("ref"):
            want, want_cache = model.prefill(toks[:, :s], alloc=s + steps,
                                             extra=extra)
        _close(got, want, 1e-3)
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
        for t in range(s, s + steps):
            before = [k.launches for k in counts]
            got, cache = model.decode_step(cache, toks[:, t:t + 1], lengths)
            assert [k.launches - n for k, n in zip(counts, before)] == step
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
    kernels = (rowwise_matmul_p, flash_attention_p, layernorm_p)
    out, counts = [], []

    def run(kind, fn):
        before = [k.launches for k in kernels]
        lg, cache = fn()
        torch.cuda.synchronize()
        counts.append((kind, [k.launches - b for k, b in zip(kernels,
                                                            before)]))
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
