"""WKV6 — the RWKV6 recurrence as one kernel per layer.

``wkv_p`` launches ``csrc/wkv.cu`` for CUDA tensors, with the per-(b, h)
state held on chip across the whole sequence, optionally starting from a
state ``s0`` (the decode step's cache). Two designs, picked by
:func:`pick_design` from the sequence length S:

* ``step`` (S <= :data:`STEP_PICK_S`): the recurrence one token at a
  time, one bytes-bound pass over the state — the decode step;
* ``chunk`` (longer): 16-token chunks on a cluster of P/16 CTAs per
  (b, h), each owning 16 channels (their decays, their part of A and
  their rows of the state) and the cluster summing y through distributed
  shared memory — prefill. It reads r, k, v, lw with 16-byte copies, so
  it needs them 16-byte aligned, strides included; other operands raise.

For CPU tensors it runs the plain ``models.rwkv6.wkv_chunked`` in fp32
and casts y back, as the kernel computes in fp32 and writes y in the
input dtype.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

CHUNK = 16
HEAD_DIMS = (16, 32, 64)
# pick_design sends sequences of up to STEP_PICK_S tokens to the step
# design, where it beats the chunk design: on the H100 at B=4 x 40 heads
# of 64 with a starting state, 7.00 µs against 8.04 at S=8, but 11.36
# against 8.66 at S=16 (chip_smoke.py's wkv threshold line; PERF.md)
STEP_PICK_S = 8
DESIGNS = {"chunk": 0, "step": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P,          # r k v lw u s0 y s_fin
             ctypes.POINTER(ctypes.c_longlong),        # (B, S, H) strides x4
             _I, _I, _I, _I, _I, _I, _P)       # b s h p dt design stream


def pick_design(s: int) -> str:
    """The design a call over S tokens takes."""
    return "step" if s <= STEP_PICK_S else "chunk"


def wkv_p(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          lw: torch.Tensor, u: torch.Tensor, *,
          s0: Optional[torch.Tensor] = None, chunk: int = CHUNK):
    """r/k/v/lw: (B, S, H, P) with unit stride on P; lw the log decays
    (< 0); u: (H, P); s0: (B, H, P, P) fp32 or None (zeros). Returns
    (y (B, S, H, P) in r's dtype, final state (B, H, P, P) fp32). The
    design is :func:`pick_design`'s for S."""
    if r.device.type == "cpu":
        from repro_torch.models.rwkv6 import wkv_chunked
        f = [t.to(torch.float32) for t in (r, k, v, lw, u)]
        y, s_fin = wkv_chunked(*f, chunk=chunk, s0=None if s0 is None
                               else s0.to(torch.float32))
        return y.to(r.dtype), s_fin
    dev = _build.check_cuda("wkv_p", r, k, v, lw, u, s0)
    if chunk != CHUNK:
        raise ValueError(f"wkv_p: the kernel runs {CHUNK}-token chunks, "
                         f"not {chunk}")
    b, s, h, p = r.shape
    dt = _build.dtype_code("wkv_p", r.dtype)
    for name, t in (("k", k), ("v", v), ("lw", lw)):
        if t.shape != r.shape or t.dtype != r.dtype:
            raise ValueError(f"wkv_p: {name} {tuple(t.shape)} {t.dtype}, "
                             f"r {tuple(r.shape)} {r.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        if t.numel() and t.stride(3) != 1:
            raise ValueError(f"wkv_p: {name} strides {t.stride()}: the "
                             "head dim needs unit stride")
    if p not in HEAD_DIMS:
        raise ValueError(f"wkv_p: head dim {p}; the kernel takes "
                         f"{HEAD_DIMS}")
    if u.shape != (h, p):
        raise ValueError(f"wkv_p: u {tuple(u.shape)}, want {(h, p)}")
    if s0 is not None and (s0.shape != (b, h, p, p)
                           or s0.dtype != torch.float32
                           or not s0.is_contiguous()):
        raise ValueError(f"wkv_p: s0 {tuple(s0.shape)} {s0.dtype}, want a "
                         f"contiguous fp32 {(b, h, p, p)}")
    design = pick_design(s)
    if design == "chunk":
        _build.check_rows16("wkv_p", "the chunk design reads 16-byte "
                            "aligned rows", r=r, k=k, v=v, lw=lw)
    uf = _build.f32(u)
    y = torch.empty((b, s, h, p), dtype=r.dtype, device=dev)
    s_fin = torch.empty((b, h, p, p), dtype=torch.float32, device=dev)
    if s == 0 or b * h == 0:
        if s0 is None:
            s_fin.zero_()
        else:
            s_fin.copy_(s0)
        return y, s_fin
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (r, k, v, lw) for st in t.stride()[:3]))
    err = _build.function("rk_wkv", _ARGTYPES)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
        uf.data_ptr(), _build.ptr(s0), y.data_ptr(), s_fin.data_ptr(),
        strides, b, s, h, p, dt, DESIGNS[design], _build.stream(dev))
    _build.check(err, "wkv_p")
    wkv_p.launches += 1
    return y, s_fin


wkv_p.launches = 0
