"""Row-wise matmul — the paper's dot-product primitive as one kernel.

``rowwise_matmul_p`` runs the whole fused pipeline of a transformer
sublayer in one launch of ``csrc/rowwise_matmul.cu``: optional
LayerNorm/RMSNorm prologue on the activation rows (fp32 statistics over
the true K, the normed value cast back to the streaming dtype before the
dot), ``x @ w`` accumulated in fp32 over the whole K inside the block,
then the post-processing epilogue — bias, activation or the gated
``act(x@wg + bg) * (x@w + b)``, residual add, cast to ``out_dtype``.

For a CPU tensor it runs the plain :func:`ref.pipeline_ref`. Operands
are taken with their row strides (unit column stride), so the halves of
a pre-fused weight panel need no copy. The int8 W8A8 mode of the JAX
kernel is not ported yet and raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.layernorm import KINDS

ACTIVATIONS = {None: 0, "gelu": 1, "silu": 2, "relu": 3, "relu2": 4}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P,      # x w wg b bg res g be out
             _LL, _LL, _LL, _LL, _LL,                 # ld x w wg res out
             _I, _I, _I, _I, _I, _I, _I,              # m n k norm act res32 out32
             ctypes.c_float, _I, _P)                  # eps dtype stream


def _rows(name, t, shape):
    if t is None:
        return
    if tuple(t.shape) != shape or (t.numel() and t.stride(-1) != 1):
        raise ValueError(f"rowwise_matmul_p: {name} {tuple(t.shape)} "
                         f"strides {t.stride()}, want {shape} with unit "
                         "column stride")


def rowwise_matmul_p(x: torch.Tensor, w: torch.Tensor, *,
                     bias: Optional[torch.Tensor] = None,
                     x_scale: Optional[torch.Tensor] = None,
                     w_scale: Optional[torch.Tensor] = None,
                     activation: Optional[str] = None,
                     w_gate: Optional[torch.Tensor] = None,
                     bias_gate: Optional[torch.Tensor] = None,
                     wg_scale: Optional[torch.Tensor] = None,
                     residual: Optional[torch.Tensor] = None,
                     prologue: Optional[str] = None,
                     gamma: Optional[torch.Tensor] = None,
                     pbeta: Optional[torch.Tensor] = None,
                     eps: float = 1e-6,
                     out_dtype=None) -> torch.Tensor:
    """x: (M, K); w: (K, N); bias: (N,) -> (M, N).

    w_gate: (K, N) second weight — gated mode, out = act(x@wg) * (x@w).
    residual: (M, N) added after activation/gating, before the cast.
    prologue: 'layer' | 'rms' — normalize the x rows in-kernel
    (gamma/pbeta: (K,)).
    """
    if x_scale is not None or w_scale is not None or wg_scale is not None:
        raise NotImplementedError(
            "rowwise_matmul_p: the int8 W8A8 mode is not ported yet")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if prologue is not None and (prologue not in KINDS or gamma is None):
        raise ValueError(f"prologue {prologue!r} needs 'layer' or 'rms' "
                         "and gamma")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return ref.pipeline_ref(
            x, w, bias=bias, activation=activation, w_gate=w_gate,
            bias_gate=bias_gate, residual=residual, norm_kind=prologue,
            gamma=gamma, beta=pbeta, eps=eps, out_dtype=out_dtype)

    dev = _build.check_cuda("rowwise_matmul_p", x, w, w_gate, bias,
                            bias_gate, residual, gamma, pbeta)
    m, k = x.shape
    n = w.shape[1]
    _rows("x", x, (m, k))
    _rows("w", w, (k, n))
    _rows("w_gate", w_gate, (k, n))
    _rows("residual", residual, (m, n))
    dt = _build.dtype_code("rowwise_matmul_p", x.dtype)
    for name, t in (("w", w), ("w_gate", w_gate)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"rowwise_matmul_p: {name} is {t.dtype}, "
                            f"x is {x.dtype}")
    if residual is not None and residual.dtype not in (x.dtype,
                                                       torch.float32):
        raise TypeError(f"rowwise_matmul_p: residual is {residual.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"rowwise_matmul_p: out_dtype {out_dtype}")

    def f32(t, size):
        if t is not None and tuple(t.shape) != (size,):
            raise ValueError(f"rowwise_matmul_p: vector {tuple(t.shape)}, "
                             f"want ({size},)")
        return _build.f32(t)

    b, bg = f32(bias, n), f32(bias_gate, n)
    g, be = f32(gamma, k), f32(pbeta, k)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m and n:
        err = _build.function("rk_rowwise_matmul", _ARGTYPES)(
            x.data_ptr(), w.data_ptr(), _build.ptr(w_gate), _build.ptr(b),
            _build.ptr(bg), _build.ptr(residual), _build.ptr(g),
            _build.ptr(be), out.data_ptr(),
            x.stride(0), w.stride(0),
            w_gate.stride(0) if w_gate is not None else 0,
            residual.stride(0) if residual is not None else 0, out.stride(0),
            m, n, k, KINDS.get(prologue, 0), ACTIVATIONS[activation],
            int(residual is not None and residual.dtype == torch.float32),
            int(out_dtype == torch.float32), eps, dt, _build.stream(dev))
        _build.check(err, "rowwise_matmul_p")
        rowwise_matmul_p.launches += 1
    return out


rowwise_matmul_p.launches = 0
