"""Row-wise attention (flash-style online softmax).

``flash_attention_p`` launches ``csrc/flash_attention.cu``: a tile of
64 query rows is held stationary while K/V tiles of 64 keys stream past
it, and the softmax runs between the two products through the running
max / running sum recurrence, so the Sq x Skv score matrix never reaches
device memory. It supports causal masking, a sliding window, GQA/MQA, a
query offset, and an additive score bias (nb, Hq, Sq, Skv) that batch b
reads at row b % nb — the relative-position bias and shift masks of
Swin's window attention — read in its stored dtype (fp32 or bf16; others
are converted to fp32). q/k/v and the bias are taken with their strides,
so the head views of a fused qkv output need no copy; q/k/v rows must be
16-byte aligned (the kernel copies them 16 bytes at a time).

One design per dtype (:func:`pick_design`), both persistent CTAs that
walk many (batch, head, query tile) items, so Swin's 49-token windows
pack many to a CTA: ``mma`` (bf16, tensor cores: ``mma.sync``) and
``ffma`` (fp32, exact FFMA).

For a CPU tensor it runs the plain :func:`ref.attention_ref`; for a
``meta`` tensor it checks the call and returns the empty output.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import trace
from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
DESIGNS = {torch.float32: "ffma", torch.bfloat16: "mma"}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _P, _P, _I, _P,          # q k v bias bias_f32 out
             _P,                              # host int64 dims/strides
             ctypes.c_float, _I, _I, _I, _I, _P)  # scale causal win qoff dt stream


def pick_design(dtype: torch.dtype) -> str:
    """The design a call in ``dtype`` takes."""
    if dtype not in DESIGNS:
        raise TypeError(f"flash_attention_p: no kernel for {dtype}")
    return DESIGNS[dtype]


@trace.traced("kernel.flash_attention")
def flash_attention_p(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      bias: Optional[torch.Tensor] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd).

    ``q_offset``: absolute position of q[..., 0, :] (chunked prefill).
    ``bias``: (nb, Hq, Sq, Skv) additive score bias; batch index b uses
    bias row b % nb (nb must divide B).
    """
    b, hq, sq, hd = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention_p: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bias is not None and (bias.shape[1:] != (hq, sq, skv)
                             or b % bias.shape[0]):
        raise ValueError(f"flash_attention_p: bias {tuple(bias.shape)} "
                         f"for q {tuple(q.shape)}, k {tuple(k.shape)}")
    scale = hd ** -0.5 if scale is None else scale

    def note():
        """The call's record and counts (``trace.note``)."""
        trace.note("flash_attention", DESIGNS[q.dtype],
                   dict(q=q, k=k, v=v, bias=bias, out=out), out.device,
                   causal=bool(causal), window=int(window),
                   q_offset=int(q_offset))

    if q.device.type == "cpu":
        with trace.plain_call():
            out = ref.attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset,
                                    bias=bias)
        if trace.records is not None and q.dtype in DESIGNS:
            note()
        return out

    dev = _build.check_cuda("flash_attention_p", q, k, v, bias)
    dt = _build.dtype_code("flash_attention_p", q.dtype)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_p: q, k and v differ in dtype")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_p: head dim {hd} (kernels for {HEAD_DIMS})")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention_p: q/k/v need unit stride "
                         "along the head dim")
    _build.check_rows16("flash_attention_p", "rows must be 16-byte aligned",
                        q=q, k=k, v=v)
    nb = 0
    if bias is not None:
        nb = bias.shape[0]
        if bias.dtype not in (torch.float32, torch.bfloat16):
            bias = bias.to(torch.float32)
    out = torch.empty((b, hq, sq, hd), dtype=q.dtype, device=dev)
    if not out.numel():
        return out
    if dev.type == "cuda":
        bias_strides = bias.stride() if bias is not None else (0, 0, 0, 0)
        dims = (b, hq, hkv, sq, skv, nb,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *bias_strides, hd)
        arr = (ctypes.c_longlong * len(dims))(*dims)
        err = _build.function("rk_flash_attention", _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(bias),
            int(bias is None or bias.dtype == torch.float32), out.data_ptr(),
            ctypes.addressof(arr), scale, int(causal), window, q_offset, dt,
            _build.stream(dev))
        _build.check(err, "flash_attention_p")
    # a meta tensor (the dry run's shapes) is checked as for a launch and
    # noted, with no launch
    if trace.active():
        note()
    return out


def mode_of(causal: bool, window: int, sq: int, skv: int) -> str:
    """A launch's mode: 'causal' or 'full', '+window' with a window,
    ' Sq!=Skv' where the queries and keys differ in length
    (cross-attention)."""
    return (("causal" if causal else "full") + ("+window" if window else "")
            + ("" if sq == skv else " Sq!=Skv"))
