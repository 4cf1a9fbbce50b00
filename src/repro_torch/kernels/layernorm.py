"""Row-wise normalization — the paper's post-processing unit.

LayerNorm / RMSNorm over the channel dim with fp32 statistics whatever
the input dtype. ``layernorm_p`` launches ``csrc/layernorm.cu`` for a
CUDA tensor and runs the plain :func:`rownorm` for a CPU tensor; a
``meta`` tensor is checked and gets the empty output. Two
designs, picked by :func:`pick_design` from M, D and the dtype:

* ``cta`` (M <= :data:`CTA_PICK_M` of the dtype, and every row too wide
  for ``rows``):
  one CTA per row, the row in the registers of up to 1024 threads, so a
  few rows (a decode step) still spread over many threads; rows past the
  registers are staged in shared memory, or re-read from L2;
* ``rows`` (more rows, D <= :data:`ROWS_MAX_D`): a power-of-two group of
  lanes per row, several rows a CTA, each lane holding one to four
  16-byte slots of its row in registers.

Both read the row once with 16-byte loads, take the two-pass statistics
from registers and write with 16-byte stores; unaligned rows and ragged
D run in the same kernels. The matmul kernel's norm prologue keeps its
own device code (``csrc/common.cuh``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import trace
from repro_torch.kernels import _build

KINDS = {"layer": 1, "rms": 2}
# rk_layernorm's flags beside the kind (csrc/layernorm.cu)
_F_BF16, _F_GAMMA_F32, _F_BETA_F32, _F_ROWS = 4, 8, 16, 32
# pick_design sends calls of up to CTA_PICK_M rows of each dtype to the
# cta design: on the H100 the largest M of chip_smoke.py's layernorm
# threshold line at which cta is at or ahead of rows at every width it
# times (D = 96 .. 2560; in fp32 but D = 192, where the two lie within
# 0.05 µs). The crossover moves with D (in bf16 M = 528 at D = 2560,
# 1056 .. 1568 at D = 768); one M a dtype keeps every call of the
# Swin-T, ViT-B/16 and RWKV6-3B paths on the faster design (PERF.md)
CTA_PICK_M = {torch.float32: 132, torch.bfloat16: 528}
# the widest row the rows design takes: 256 lanes of four 16-byte slots
ROWS_MAX_D = {torch.float32: 4096, torch.bfloat16: 8192}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, ctypes.c_longlong, _P, _P, _P,      # x ldx gamma beta out
             _I, _I, _I, ctypes.c_float, _P)         # m d flags eps stream
_VECTOR_DTYPES = (torch.float32, torch.bfloat16)
_launcher = None


def _launch(*args) -> int:
    """rk_layernorm, resolved from the library at first use."""
    global _launcher
    if _launcher is None:
        _launcher = _build.function("rk_layernorm", _ARGTYPES)
    return _launcher(*args)


def pick_design(m: int, d: int, dtype: torch.dtype) -> str:
    """The design a call over M rows of D takes (either dtype)."""
    if m <= CTA_PICK_M[dtype] or d > ROWS_MAX_D[dtype]:
        return "cta"
    return "rows"


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


@trace.traced("kernel.layernorm")
def layernorm_p(x: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor = None, *, eps: float = 1e-6,
                kind: str = "layer") -> torch.Tensor:
    """x: (M, D) with unit column stride; gamma/beta: (D,).
    kind: 'layer' | 'rms'. Returns (M, D) in x's dtype. The design is
    :func:`pick_design`'s for M, D and the dtype."""
    flags = KINDS.get(kind)
    if flags is None:
        raise ValueError(f"kind must be 'layer' or 'rms', not {kind!r}")

    def note():
        """The call's record and counts (``trace.note``)."""
        trace.note("layernorm", pick_design(*x.shape, x.dtype),
                   dict(x=x, gamma=gamma, beta=beta, out=out), out.device)

    if x.is_cpu:
        with trace.plain_call():
            out = rownorm(x, gamma, beta, kind=kind, eps=eps).to(x.dtype)
        if trace.records is not None and x.dim() == 2 and x.dtype in (
                torch.float32, torch.bfloat16):
            note()
        return out
    # shape, dtype and gradient first, so that they hold on any device
    shape, sx = x.shape, x.stride()
    if len(shape) != 2 or sx[1] != 1 or gamma.shape != shape[1:] or (
            beta is not None and beta.shape != shape[1:]):
        raise ValueError(f"layernorm_p: x {tuple(shape)} strides {sx}, "
                         f"gamma {tuple(gamma.shape)}")
    m, d = shape
    if x.dtype is torch.bfloat16:
        flags |= _F_BF16
    elif x.dtype is not torch.float32:
        raise TypeError(f"layernorm_p: no kernel for {x.dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or (beta is not None
                                        and beta.requires_grad)):
        raise NotImplementedError("layernorm_p: the kernel has no backward")
    if x.is_meta:
        # shapes alone: the dry run's call, checked and noted, no launch
        for t in (gamma, beta):
            if t is not None and not t.is_meta:
                raise ValueError(f"layernorm_p: tensors on {t.device} and "
                                 f"{x.device}")
        out = torch.empty((m, d), dtype=x.dtype, device="meta")
        if m and trace.active():
            note()
        return out
    if not x.is_cuda:
        raise ValueError(f"layernorm_p: no kernel for a tensor on {x.device}")
    idx = x.get_device()
    if gamma.get_device() != idx or (beta is not None
                                     and beta.get_device() != idx):
        other = gamma if gamma.get_device() != idx else beta
        raise ValueError(f"layernorm_p: tensors on {other.device} and "
                         f"{x.device}")
    if idx != _build.current_device():
        raise ValueError(f"layernorm_p: tensor on {x.device}, current "
                         f"device is cuda:{_build.current_device()}")
    # gamma and beta are read as stored, fp32 or bf16, with unit stride
    if gamma.dtype not in _VECTOR_DTYPES or not gamma.is_contiguous():
        gamma = _build.vector(gamma)
    if gamma.dtype is torch.float32:
        flags |= _F_GAMMA_F32
    bptr = 0
    if beta is not None:
        if beta.dtype not in _VECTOR_DTYPES or not beta.is_contiguous():
            beta = _build.vector(beta)
        if beta.dtype is torch.float32:
            flags |= _F_BETA_F32
        bptr = beta.data_ptr()
    design = pick_design(m, d, x.dtype)
    if design == "rows":
        flags |= _F_ROWS
    out = torch.empty_like(x) if sx[0] == d else x.new_empty((m, d))
    if m:
        err = _launch(x.data_ptr(), sx[0], gamma.data_ptr(), bptr,
                      out.data_ptr(), m, d, flags, eps,
                      _build.raw_stream(idx))
        if err:
            _build.check(err, "layernorm_p")
        if trace.active():
            note()
    return out
