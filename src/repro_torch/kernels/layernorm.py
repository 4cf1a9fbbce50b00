"""Row-wise normalization — the paper's post-processing unit.

LayerNorm / RMSNorm over the channel dim with fp32 statistics whatever
the input dtype. ``layernorm_p`` launches ``csrc/layernorm.cu`` for a
CUDA tensor and runs the plain :func:`rownorm` for a CPU tensor. The
device side of ``rownorm`` lives in ``csrc/common.cuh``, shared with the
matmul kernel's norm prologue, as the TPU kernels share it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KINDS = {"layer": 1, "rms": 2}

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def rownorm(x, gamma, beta=None, *, kind: str, eps: float):
    """fp32 LayerNorm/RMSNorm of the rows of ``x`` (..., D): the plain
    version of the norm math shared by the standalone kernel and the
    matmul kernel's prologue. Returns fp32."""
    xf = x.to(torch.float32)
    if kind == "layer":
        xf = xf - xf.mean(-1, keepdim=True)
    var = torch.square(xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)
    if beta is not None:
        y = y + beta.to(torch.float32)
    return y


def layernorm_p(x: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor = None, *, eps: float = 1e-6,
                kind: str = "layer") -> torch.Tensor:
    """x: (M, D) with unit column stride; gamma/beta: (D,).
    kind: 'layer' | 'rms'. Returns (M, D) in x's dtype."""
    if kind not in KINDS:
        raise ValueError(f"kind must be 'layer' or 'rms', not {kind!r}")
    if x.device.type == "cpu":
        return rownorm(x, gamma, beta, kind=kind, eps=eps).to(x.dtype)
    dev = _build.check_cuda("layernorm_p", x, gamma, beta)
    m, d = x.shape
    if x.stride(1) != 1 or gamma.shape != (d,) or (
            beta is not None and beta.shape != (d,)):
        raise ValueError(f"layernorm_p: x {tuple(x.shape)} strides "
                         f"{x.stride()}, gamma {tuple(gamma.shape)}")
    dt = _build.dtype_code("layernorm_p", x.dtype)
    g, b = _build.f32(gamma), _build.f32(beta)
    out = torch.empty((m, d), dtype=x.dtype, device=dev)
    if m:
        err = _build.function("rk_layernorm", _ARGTYPES)(
            x.data_ptr(), x.stride(0), g.data_ptr(), _build.ptr(b),
            out.data_ptr(), m, d, KINDS[kind], eps, dt, _build.stream(dev))
        _build.check(err, "layernorm_p")
        layernorm_p.launches += 1
    return out


layernorm_p.launches = 0
