"""Mamba2's SSD scan as a kernel, with the skip term.

``ssd_p`` launches ``csrc/ssd.cu`` for CUDA tensors: y = SSD(x, dt, a,
B, C; s0) + D x, the contract of ``models.mamba2.ssd_chunked`` plus the
mixer's skip, in fp32, and the final state. The kernel replaces no TPU
kernel (the JAX package scans in jnp): it was added because the chunk
loop in torch ops was the largest device cost of the Mamba2 layers. Two
launches a call, each counted as a design of ``launch.ssd.*``:

* ``cb``: each chunk's C Bᵀ (its lower triangle, in 64 x 64 tiles),
  once for all heads (one group);
* ``scan``: one CTA per (batch row, head) walks the chunks in order with
  the state on chip: the intra-chunk term from ``cb`` with the decays
  and dt applied on chip, the inter-chunk term from the carried state,
  the skip, then the state update.

One algorithm for every caller: it reads P, N, the chunk and S from its
operands (a decode step is a chunk of one token with ``s0``). The chunk
runs as ``min(chunk, S)``, as the plain scan cuts it. x, B and C may be
strided views (the mixer's columns of the conv output) with unit stride
on their last dim and 16-byte aligned rows; dt any strides.

For CPU tensors it runs the plain :func:`ssd_plain`; for ``meta``
tensors it checks the call and returns the empty outputs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import trace
from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 64, 128)
CHUNKS = (8, 128, 256)
# the launches of a call, in order (trace designs)
LAUNCHES = ("cb", "scan")
# the side of the C Bᵀ tiles, to which the scratch is padded (csrc/ssd.cu
# RT)
TILE = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # x dt a d B C s0 cb y s
             ctypes.POINTER(ctypes.c_longlong),       # 10 strides
             _I, _I, _I, _I, _I, _I, _P)              # b s h p n l stream


def ssd_plain(xh, dt, a, B, C, D, *, chunk: int, s0=None):
    """The plain version: ``models.mamba2.ssd_chunked`` and the skip term
    ``D x``, as the mixer computed them in torch ops."""
    from repro_torch.models.mamba2 import ssd_chunked
    y, s_fin = ssd_chunked(xh, dt, a, B, C, chunk=chunk, s0=s0)
    return y + D[None, None, :, None] * xh, s_fin


def cb_shape(b: int, s: int, chunk: int) -> tuple:
    """The scratch of the ``cb`` launch: each chunk's C Bᵀ, its side the
    chunk as run rounded up to a tile."""
    ln = min(chunk, s)
    side = -(-ln // TILE) * TILE
    return (b, -(-s // ln), side, side)


@trace.traced("kernel.ssd")
def ssd_p(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
          B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
          chunk: int, s0: Optional[torch.Tensor] = None):
    """xh: (B, S, H, P); dt: (B, S, H); a, D: (H,); B, C: (B, S, N);
    s0: (B, H, P, N) or None (zeros); all fp32. Returns (y (B, S, H, P),
    final state (B, H, P, N)), both fp32."""
    bsz, s, h, p = xh.shape
    n = B.shape[-1]

    def note(cb):
        """The two launches' records and counts (``trace.note``)."""
        ln = min(chunk, s)
        trace.note("ssd", "cb", dict(B=B, C=C, cb=cb), y.device, chunk=ln)
        trace.note("ssd", "scan", dict(x=xh, dt=dt, a=a, D=D, B=B, C=C,
                                       cb=cb, s0=s0, y=y, s_fin=s_fin),
                   y.device, chunk=ln)

    if xh.device.type == "cpu":
        with trace.plain_call():
            y, s_fin = ssd_plain(xh, dt, a, B, C, D, chunk=chunk, s0=s0)
        if trace.records is not None:
            note(torch.empty(cb_shape(bsz, s, chunk), device="meta"))
        return y, s_fin
    dev = _build.check_cuda("ssd_p", xh, dt, a, B, C, D, s0)
    for name, t in (("xh", xh), ("dt", dt), ("a", a), ("B", B), ("C", C),
                    ("D", D), ("s0", s0)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_p: {name} is {t.dtype}; the kernel "
                            "takes fp32")
    want = {"dt": (bsz, s, h), "a": (h,), "D": (h,), "B": (bsz, s, n),
            "C": (bsz, s, n), "s0": (bsz, h, p, n)}
    for name, t in (("dt", dt), ("a", a), ("D", D), ("B", B), ("C", C),
                    ("s0", s0)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_p: {name} {tuple(t.shape)}, want "
                             f"{want[name]}")
    if p not in HEAD_DIMS or n not in STATE_DIMS or chunk not in CHUNKS:
        raise ValueError(f"ssd_p: (P, N, chunk) = {(p, n, chunk)}; the "
                         f"kernel takes P in {HEAD_DIMS}, N in "
                         f"{STATE_DIMS}, chunk in {CHUNKS}")
    for name, t in (("xh", xh), ("B", B), ("C", C)):
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"ssd_p: {name} strides {t.stride()}: the "
                             "last dim needs unit stride")
    if xh.numel():
        _build.check_rows16("ssd_p", "the kernel reads 16-byte aligned "
                            "rows", xh=xh, B=B, C=C)
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=dev)
    s_fin = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    if s == 0 or bsz * h == 0:
        if s0 is None:
            s_fin.zero_()
        else:
            s_fin.copy_(s0)
        return y, s_fin
    cb = torch.empty(cb_shape(bsz, s, chunk), dtype=torch.float32,
                     device=dev)
    if dev.type == "cuda":
        s0c, af, df = _build.f32(s0), _build.f32(a), _build.f32(D)
        strides = (ctypes.c_longlong * 10)(
            *xh.stride()[:3], *dt.stride(), *B.stride()[:2],
            *C.stride()[:2])
        err = _build.function("rk_ssd", _ARGTYPES)(
            xh.data_ptr(), dt.data_ptr(), af.data_ptr(), df.data_ptr(),
            B.data_ptr(), C.data_ptr(), _build.ptr(s0c), cb.data_ptr(),
            y.data_ptr(), s_fin.data_ptr(), strides, bsz, s, h, p, n,
            min(chunk, s), _build.stream(dev))
        _build.check(err, "ssd_p")
    # a meta tensor (the dry run's shapes) is checked as for a launch and
    # noted, with no launch
    if trace.active():
        note(cb)
    return y, s_fin
