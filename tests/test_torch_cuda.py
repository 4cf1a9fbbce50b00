"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips. On a machine with one
(the JAX package is not needed, so the JAX-importing conftest is left
out):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

fp32 tolerance 1e-4 against max(1, max|plain|): only the order of the
fp32 sums differs. bf16 WKV inputs: 3e-2, y is rounded to bf16 (8-bit
mantissa) where the plain version keeps fp32.
"""
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.swin_t import reduced
from repro_torch.core import runtime
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
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


@pytest.mark.parametrize("case", [
    dict(b=4, hq=3, hkv=3, sq=49, skv=49, nb=2, causal=False, hd=32),
    dict(b=2, hq=8, hkv=2, sq=70, skv=200, causal=True, window=64,
         q_offset=130, hd=128),
    dict(b=2, hq=12, hkv=12, sq=197, skv=197, causal=False, hd=64)],
    ids=["swin-bias", "lm", "vit"])
def test_attention_kernel(dev, case):
    case = dict(case)
    b, hq, hkv, sq, skv, hd = (case.pop(k) for k in
                               ("b", "hq", "hkv", "sq", "skv", "hd"))
    nb = case.pop("nb", 0)
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn(b, hq, sq, hd, generator=g).to(dev)
    k = torch.randn(b, hkv, skv, hd, generator=g).to(dev)
    v = torch.randn(b, hkv, skv, hd, generator=g).to(dev)
    bias = torch.randn(nb, hq, sq, skv, generator=g).to(dev) if nb else None
    got = flash_attention_p(q, k, v, bias=bias, **case)
    _close(got, ref.attention_ref(q, k, v, bias=bias, **case))


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_layernorm_kernel(dev, kind):
    g = torch.Generator(device="cpu").manual_seed(2)
    x = torch.randn(300, 768, generator=g).to(dev) * 3 + 1
    gamma = (1 + 0.1 * torch.randn(768, generator=g)).to(dev)
    beta = (0.1 * torch.randn(768, generator=g)).to(dev)
    _close(layernorm_p(x, gamma, beta, kind=kind),
           ref.layernorm_ref(x, gamma, beta, kind=kind))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("shape", [(2, 45, 3, 16), (1, 7, 2, 64),
                                   (4, 1, 40, 64), (1, 333, 4, 64),
                                   (2, 17, 2, 32)], ids=str)
def test_wkv_kernel(dev, shape, with_s0, dtype):
    b, s, h, p = shape
    g = torch.Generator(device="cpu").manual_seed(4)
    r, k, v = (torch.randn(b, s, h, p, generator=g).to(dev, dtype)
               for _ in range(3))
    lw = torch.clamp(-torch.exp(2 * torch.randn(b, s, h, p, generator=g)),
                     -rwkv6.CLAMP, -1e-6).to(dev, dtype)
    u = torch.randn(h, p, generator=g).to(dev)
    s0 = (torch.randn(b, h, p, p, generator=g).to(dev) if with_s0
          else None)
    before = wkv_p.launches
    y, s_fin = wkv_p(r, k, v, lw, u, s0=s0)
    assert wkv_p.launches == before + 1
    assert y.dtype == dtype and s_fin.dtype == torch.float32
    want_y, want_s = rwkv6.wkv_chunked(*(t.float() for t in (r, k, v, lw)),
                                       u, s0=s0)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    _close(y, want_y, tol)
    _close(s_fin, want_s, 1e-4)


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
