"""What the plain references share: fp32 products with TF32 off, and the
control's precision.

The control of a configuration stated in bf16 is its reference computed
one precision lower: fp8 (e4m3) W8A8. Every projection's input rows and
weight columns are rounded to fp8 with one scale a row (a column) set by
its largest magnitude, then multiplied with fp32 accumulation, as an
fp8 GEMM with per-row and per-column scales computes; the norms, the
attention and the softmax stay in fp32.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "fp8")
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """fp32 products in full fp32 (a card may otherwise use TF32)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (fp32) rounded to e4m3 with one scale per slice along
    ``dim`` (the scale maps the slice's largest magnitude to 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(FP8).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str = "fp32",
           bias=None) -> torch.Tensor:
    """x (..., K) @ w (K, N) in fp32 (``precision`` "fp32"), or with both
    operands rounded to fp8 first ("fp8": the control)."""
    xf = x.to(torch.float32)
    wf = w.to(torch.float32)
    if precision == "fp8":
        xf = fp8_round(xf, -1)
        wf = fp8_round(wf, 0)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    y = xf @ wf
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        0.7978845608028654 * (x + 0.044715 * x * x * x)))


def layer_norm(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * g.float()
