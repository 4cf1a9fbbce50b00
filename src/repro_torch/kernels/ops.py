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
                               computes ``act(g) * h``;
  * :func:`matmul_int8`      — the W8A8 leg: int8 operands, int32
                               accumulation, dequant in the epilogue.

A norm the matmul design cannot carry well at this K
(``rowwise_matmul.norm_prologue_fits``) runs as the standalone norm
kernel before a prologue-free matmul: the counterpart of the JAX
package's fallback for K beyond one VMEM panel. The plain path keeps
the norm inside ``pipeline_ref``; both cast the normed rows to the
streaming dtype before the dot.

Gradients. The kernels have no backward, and their raw wrappers refuse
a tensor that wants a gradient. On the kernel path (:func:`kernel_path`)
an op whose tensor operands want a gradient runs through
:class:`KernelOp`: its forward launches the kernels exactly as a
serving call does, and its backward is the gradient of the op's plain
version, recomputed in torch ops from the saved inputs (the function
the JAX package differentiates, at the kernel path's inputs).
Attention without a bias takes the flash backward instead
(``attention.flash_backward``, the port of the JAX package's
``_flash_bwd``). Calls without a gradient (every serving call) launch
as before.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core import quant, runtime
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_p
from repro_torch.kernels.layernorm import layernorm_p
from repro_torch.kernels.rowwise_matmul import (norm_prologue_fits,
                                                rowwise_matmul_groups_p,
                                                rowwise_matmul_p)
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


def kernel_path(x: torch.Tensor) -> bool:
    """Whether an op on ``x`` takes the kernel branch: a tensor off the
    CPU (a kernel wrapper runs a CPU tensor's plain version whole, and
    that is differentiable as it is)."""
    return x.device.type != "cpu"


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class KernelOp(torch.autograd.Function):
    """One op of the kernel path, differentiable: ``kernel(*tensors)``
    runs the kernels (grad mode is off inside ``forward``, so the raw
    wrappers take the tensors); ``backward`` calls ``grad(tensors,
    outputs, grad_outputs)``, by default the gradient of
    ``plain(*tensors)`` recomputed under ``torch.enable_grad()`` on
    detached copies of the saved inputs. Every tensor operand is in
    ``tensors`` (None where absent): one closed over would get no
    gradient."""

    @staticmethod
    def forward(ctx, kernel, plain, grad, *tensors):
        ctx.plain, ctx.grad = plain, grad
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, *grad_outputs):
        inputs = [None if t is None else
                  t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[3:])]
        grads = (ctx.grad or _plain_grad)(ctx.plain, inputs, grad_outputs)
        return (None, None, None, *grads)


def _plain_grad(plain, inputs, grad_outputs):
    """The gradient of ``plain(*inputs)`` with respect to every input
    that requires one (None for the others)."""
    with torch.enable_grad():
        outs = plain(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wrt = [t for t in inputs if t is not None and t.requires_grad]
    pairs = [(o, g) for o, g in zip(outs, grad_outputs)
             if o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wrt, [g for _, g in pairs],
                                   allow_unused=True))
    return [next(got) if t is not None and t.requires_grad else None
            for t in inputs]


def _dispatch(impl, kernel, plain, *tensors, grad=None):
    """``plain(*tensors)`` under ``ref``; else ``kernel(*tensors)`` (the
    kernel wrapper, which runs a CPU tensor's plain version), through
    :class:`KernelOp` on the kernel path where an operand wants a
    gradient."""
    if impl == "ref":
        return plain(*tensors)
    if kernel_path(tensors[0]) and _wants_grad(*tensors):
        return KernelOp.apply(kernel, plain, grad, *tensors)
    return kernel(*tensors)


def _pipeline(x2, w, impl, *, norm: Optional[NormSpec] = None, bias=None,
              w_gate=None, bias_gate=None, residual=None, **kw):
    """The one matmul dispatch: the plain pipeline under ``ref``, else the
    kernel wrapper, with the norm moved to ``layernorm_p`` on the kernel
    path where the prologue does not fit. ``kw``: the non-tensor
    options (activation, out_dtype)."""
    kind, gamma, beta, eps = norm or (None, None, None, 1e-6)

    def plain(x2, w, bias, w_gate, bias_gate, residual, gamma, beta):
        return ref.pipeline_ref(x2, w, bias=bias, w_gate=w_gate,
                                bias_gate=bias_gate, residual=residual,
                                norm_kind=kind, gamma=gamma, beta=beta,
                                eps=eps, **kw)

    def kernel(x2, w, bias, w_gate, bias_gate, residual, gamma, beta):
        prologue = kind
        if (kind is not None and kernel_path(x2)
                and not norm_prologue_fits(*x2.shape, x2.dtype)):
            x2 = layernorm_p(x2, gamma, beta, eps=eps, kind=kind)
            prologue = gamma = beta = None
        return rowwise_matmul_p(x2, w, bias=bias, w_gate=w_gate,
                                bias_gate=bias_gate, residual=residual,
                                prologue=prologue, gamma=gamma, pbeta=beta,
                                eps=eps, **kw)
    return _dispatch(impl, kernel, plain, x2, w, bias, w_gate, bias_gate,
                     residual, gamma, beta)


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


def matmul_groups(x: torch.Tensor, w: torch.Tensor, sizes: Sequence[int], *,
                  activation: Optional[str] = None, gated: bool = False,
                  out: Optional[torch.Tensor] = None,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Consecutive row groups of ``x`` (R, K), each times its own
    weight: group g, its ``sizes[g]`` rows, @ ``w[g]`` (w: (G, K, N));
    with ``gated`` each ``w[g]`` is a [gate | up] panel (K, 2F) and the
    rows get ``act(x wg) * (x wi)``, as in :func:`gate_up_proj`. ->
    (R, N or F) (``out`` when given), one launch a non-empty group, each
    writing its rows of the output in place. The dispatch is decided
    once for all the groups: the dropless expert layer's calls, whose
    host time bounds the layer."""
    impl = impl or runtime.resolve_impl()
    f = w.shape[-1] // 2 if gated else w.shape[-1]
    if out is None:
        out = x.new_empty((x.shape[0], f))
    if impl == "ref" or (kernel_path(x) and _wants_grad(x, w)):
        # the general dispatch, a group at a time
        start = 0
        for g, m in enumerate(sizes):
            if m:
                xg = x[start:start + m]
                out[start:start + m] = (
                    gate_up_proj(xg, w[g], activation=activation, impl=impl)
                    if gated else
                    matmul(xg, w[g], activation=activation, impl=impl))
            start += m
        return out
    return rowwise_matmul_groups_p(x, w, sizes, gated=gated,
                                   activation=activation, out=out)


def matmul_int8(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                activation: Optional[str] = None,
                residual: Optional[torch.Tensor] = None,
                wide_n: bool = False, impl: Optional[str] = None,
                out_dtype=torch.float32) -> torch.Tensor:
    """W8A8 path: int8 xq (..., K) x int8 wq (K, N) -> int32 accumulation
    -> dequant by ``x_scale`` (..., 1) per row and ``w_scale`` (1, N) per
    channel -> bias -> activation -> ``residual`` -> ``out_dtype``.

    Wide-N works by concatenating weights AND per-channel scales along N.
    ``wide_n`` is accepted for the JAX signature and changes nothing
    here: the JAX package uses it only to plan the TPU's VMEM, and the
    CUDA kernel picks its own tiles. Under ``impl="ref"`` the plain
    :func:`ref.matmul_int8_ref`, then the residual add, as in JAX.
    """
    del wide_n
    impl = impl or runtime.resolve_impl()
    x2, lead = _flatten_leading(xq)
    n = wq.shape[1]
    s2 = x_scale.reshape(-1, 1)
    res2 = None if residual is None else residual.reshape(-1, n)
    if impl == "ref":
        out = ref.matmul_int8_ref(x2, wq, s2, w_scale, bias=bias,
                                  activation=activation, out_dtype=out_dtype)
        if res2 is not None:
            out = (out.to(torch.float32)
                   + res2.to(torch.float32)).to(out_dtype)
    else:
        out = rowwise_matmul_p(x2, wq, x_scale=s2, w_scale=w_scale,
                               bias=bias, activation=activation,
                               residual=res2, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def attention(q, k, v, *, causal=True, window: int = 0, scale=None,
              q_offset: int = 0, bias=None, impl: Optional[str] = None):
    impl = impl or runtime.resolve_impl()
    opts = dict(causal=causal, window=window, scale=scale,
                q_offset=q_offset)

    def kernel(q, k, v, bias):
        return flash_attention_p(q, k, v, bias=bias, **opts)

    def plain(q, k, v, bias):
        return ref.attention_ref(q, k, v, bias=bias, **opts)

    grad = None
    if bias is None and (scale is None or scale == q.shape[-1] ** -0.5):
        def grad(_plain, inputs, grad_outputs):
            from repro_torch.models.attention import flash_backward
            q, k, v, _ = inputs
            return (*flash_backward(q, k, v, grad_outputs[0],
                                    causal=causal, window=window,
                                    q_offset=q_offset), None)
    return _dispatch(impl, kernel, plain, q, k, v, bias, grad=grad)


def layernorm(x, gamma, beta=None, *, eps=1e-6, kind="layer",
              impl: Optional[str] = None):
    impl = impl or runtime.resolve_impl()
    x2, lead = _flatten_leading(x)

    def plain(x2, gamma, beta):
        return ref.layernorm_ref(x2, gamma, beta, eps=eps, kind=kind)

    def kernel(x2, gamma, beta):
        return layernorm_p(x2, gamma, beta, eps=eps, kind=kind)

    out = _dispatch(impl, kernel, plain, x2, gamma, beta)
    return out.reshape(*lead, x.shape[-1])


def wkv(r, k, v, lw, u, *, s0=None, chunk: int = 16,
        impl: Optional[str] = None):
    """RWKV6 recurrence -> (y, final state). Under ``use_impl("ref")``
    or for CPU tensors the plain chunked scan ``rwkv6.wkv_chunked``; for
    CUDA tensors the kernel, with or without a starting state ``s0``
    (the JAX package takes its kernel only without ``s0``; here every
    decode step runs on the kernel too). Its gradient on the kernel
    path is the scan's, recomputed in fp32 as the wrapper's plain
    version runs it."""
    from repro_torch.models.rwkv6 import wkv_chunked
    impl = impl or runtime.resolve_impl()
    if impl == "ref" or not kernel_path(r):
        return wkv_chunked(r, k, v, lw, u, chunk=chunk, s0=s0)

    def kernel(r, k, v, lw, u, s0):
        return wkv_p(r, k, v, lw, u, s0=s0, chunk=chunk)

    def plain(r, k, v, lw, u, s0):
        f = [t.to(torch.float32) for t in (r, k, v, lw, u)]
        y, s_fin = wkv_chunked(*f, chunk=chunk, s0=None if s0 is None
                               else s0.to(torch.float32))
        return y.to(r.dtype), s_fin
    return _dispatch(impl, kernel, plain, r, k, v, lw, u, s0)


def patch_embed(img, w, b=None, *, patch: int = 4,
                impl: Optional[str] = None):
    """4x4/stride-4 conv as space-to-depth + the SAME matmul primitive —
    the paper's unification of conv onto the dot-product PE (Sec. IV-C)."""
    return matmul(ref.space_to_depth(img, patch), w, bias=b, impl=impl)
