"""Public wrappers over the kernels.

Every dense op funnels through :func:`matmul` — the paper's "single
dot-product primitive for a unified execution". The wrapper flattens
leading batch dims and picks the implementation: under
``runtime.use_impl("ref")`` the plain versions of ``ref.py``, otherwise
the kernel wrapper, which launches the CUDA kernel for a CUDA tensor and
runs the plain version for a CPU tensor.

The fusion between the ops of a transformer sublayer:

  * ``matmul(norm=...)``     — pre-norm runs as the kernel prologue;
  * ``matmul(residual=...)`` — the residual add rides the epilogue;
  * :func:`qkv_proj`         — one stored [wq | wk | wv] panel, one
                               launch, outputs sliced per projection;
  * :func:`gate_up_proj`     — the stored [wg | wi] panel streams
                               through one launch whose epilogue
                               computes ``act(g) * h``.

The CUDA matmul takes the norm prologue at any K (it takes the row
statistics in a pass of its own), so the JAX package's fallback to the
standalone norm kernel for K beyond one VMEM panel has no counterpart.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import quant, runtime
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import rowwise_matmul_p
from repro_torch.kernels.wkv import wkv_p


class NormSpec(NamedTuple):
    """A pre-norm to fuse into a matmul's prologue."""
    kind: str                       # 'layer' | 'rms'
    gamma: torch.Tensor
    beta: Optional[torch.Tensor] = None
    eps: float = 1e-6


def _flatten_leading(x):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    return x2, lead


def _pipeline(x2, w, impl, *, norm: Optional[NormSpec] = None, **kw):
    kind, gamma, beta, eps = norm or (None, None, None, 1e-6)
    if impl == "ref":
        return ref.pipeline_ref(x2, w, norm_kind=kind, gamma=gamma,
                                beta=beta, eps=eps, **kw)
    return rowwise_matmul_p(x2, w, prologue=kind, gamma=gamma, pbeta=beta,
                            eps=eps, **kw)


def matmul(x: torch.Tensor, w, *,
           bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None,
           residual: Optional[torch.Tensor] = None,
           norm: Optional[NormSpec] = None,
           impl: Optional[str] = None,
           out_dtype=None) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) -> (..., N) with fused bias/activation.

    ``norm``: pre-normalize x in the kernel prologue.
    ``residual``: (..., N) added after the activation, in the epilogue.
    """
    impl = impl or runtime.resolve_impl()
    w = quant.resolve_weight(w, x.dtype)
    x2, lead = _flatten_leading(x)
    n = w.shape[1]
    res2 = None if residual is None else _flatten_leading(residual)[0]
    out = _pipeline(x2, w, impl, norm=norm, bias=bias, activation=activation,
                    residual=res2, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def qkv_proj(x: torch.Tensor, w, splits: Sequence[int], *,
             bias: Optional[torch.Tensor] = None,
             norm: Optional[NormSpec] = None,
             impl: Optional[str] = None):
    """Multi-output wide-N projection over a PRE-FUSED weight panel
    ``w`` = [wq | wk | wv] of shape (K, sum(splits)): one launch, one
    read of the activation rows for every projection. Returns one view
    of the output per entry of ``splits``."""
    w = quant.resolve_weight(w, x.dtype)
    if sum(splits) != w.shape[-1]:
        raise ValueError(f"splits {tuple(splits)} for a panel {w.shape}")
    out = matmul(x, w, bias=bias, norm=norm, impl=impl)
    return tuple(torch.split(out, list(splits), dim=-1))


def gate_up_proj(x: torch.Tensor, w, *, activation: str,
                 bias: Optional[torch.Tensor] = None,
                 norm: Optional[NormSpec] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Gated FFN front half as ONE kernel: ``act(x@wg) * (x@wi)`` with
    optional fused pre-norm. ``w`` is the pre-fused [wg | wi] panel
    (K, 2F); its halves are read in place with the panel's row stride."""
    impl = impl or runtime.resolve_impl()
    w = quant.resolve_weight(w, x.dtype)
    f = w.shape[-1] // 2
    if w.shape[-1] != 2 * f:
        raise ValueError(f"gated panel {tuple(w.shape)} has an odd width")
    w_gate, w_in = w[..., :f], w[..., f:]
    bias_gate = bias_in = None
    if bias is not None:
        bias_gate, bias_in = bias[..., :f], bias[..., f:]
    x2, lead = _flatten_leading(x)
    out = _pipeline(x2, w_in, impl, norm=norm, bias=bias_in,
                    activation=activation, w_gate=w_gate,
                    bias_gate=bias_gate)
    return out.reshape(*lead, f)


def attention(q, k, v, *, causal=True, window: int = 0, scale=None,
              q_offset: int = 0, bias=None, impl: Optional[str] = None):
    impl = impl or runtime.resolve_impl()
    fn = ref.attention_ref if impl == "ref" else flash_attention_p
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              q_offset=q_offset, bias=bias)


def layernorm(x, gamma, beta=None, *, eps=1e-6, kind="layer",
              impl: Optional[str] = None):
    impl = impl or runtime.resolve_impl()
    x2, lead = _flatten_leading(x)
    fn = ref.layernorm_ref if impl == "ref" else layernorm_p
    out = fn(x2, gamma, beta, eps=eps, kind=kind)
    return out.reshape(*lead, x.shape[-1])


def wkv(r, k, v, lw, u, *, s0=None, chunk: int = 16,
        impl: Optional[str] = None):
    """RWKV6 recurrence -> (y, final state). Under ``use_impl("ref")``
    or for CPU tensors the plain chunked scan ``rwkv6.wkv_chunked``; for
    CUDA tensors the kernel, with or without a starting state ``s0``
    (the JAX package takes its kernel only without ``s0``; here every
    decode step runs on the kernel too)."""
    impl = impl or runtime.resolve_impl()
    if impl == "ref" or r.device.type == "cpu":
        from repro_torch.models.rwkv6 import wkv_chunked
        return wkv_chunked(r, k, v, lw, u, chunk=chunk, s0=s0)
    return wkv_p(r, k, v, lw, u, s0=s0, chunk=chunk)


def patch_embed(img, w, b=None, *, patch: int = 4,
                impl: Optional[str] = None):
    """4x4/stride-4 conv as space-to-depth + the SAME matmul primitive —
    the paper's unification of conv onto the dot-product PE (Sec. IV-C)."""
    return matmul(ref.space_to_depth(img, patch), w, bias=b, impl=impl)
