"""Int8 quantization — the paper uses 8-bit weights AND activations.

Symmetric int8: per-output-channel scales for weights (computed offline),
per-row dynamic scales for activations (computed on the fly, the way the
ASIC quantizes between layers). The int8 W8A8 mode of the row-wise
matmul (``ops.matmul_int8``) takes both; a weight-only leaf
``{"q": int8 (K, N), "s": fp32 (1, N)}`` dequantizes for a float matmul.

The arithmetic and its order are the JAX package's (``repro.core.quant``):
``max(amax, 1e-8) / 127`` in the input's dtype, then round half to even
(``torch.round``, like ``jnp.round``), then clip to ±127 — so both give
the same bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

INT8_MAX = 127.0


def _quantize(t: torch.Tensor, dim: int):
    amax = t.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / INT8_MAX
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_per_channel(w: torch.Tensor, axis: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize weights per output channel. Returns (int8 w, fp32 scale).

    ``axis`` is the *contraction* axis; scales are per remaining channel
    ((1, N) for a (K, N) weight).
    """
    return _quantize(w, axis)


def quantize_per_row(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row activation quantization (rows = last-but-one dim):
    scales (..., M, 1)."""
    return _quantize(x, -1)


def dequantize(acc_i32: torch.Tensor, x_scale: torch.Tensor,
               w_scale: torch.Tensor) -> torch.Tensor:
    return acc_i32.to(torch.float32) * x_scale * w_scale


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def quantize_tree(params, predicate=None):
    """Weight-only quantize every >=2D tensor leaf of a param tree (nested
    dicts and lists). Matmul weights become ``{"q": int8, "s": scale}``
    leaves; other leaves pass through. ``predicate(path, leaf)``, where
    ``path`` is the tuple of dict keys and list indices down to the leaf,
    picks the leaves to quantize.

    Scales are per output channel, so quantizing a *fused* projection
    leaf (wq|wk|wv or wg|wi stored pre-concatenated) yields exactly the
    concatenation of the per-part scales.
    """
    def q(path, leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
                and (predicate is None or predicate(path, leaf))):
            qw, s = quantize_per_channel(leaf, axis=leaf.dim() - 2)
            return {"q": qw, "s": s}
        return leaf

    return _walk(params, q)


LM_WEIGHT_KEYS = frozenset({
    "embed", "lm_head", "wqkv", "wkv", "wq", "wk", "wv", "wgi", "wg",
    "wi", "wo"})


def lm_weight_predicate(path, leaf) -> bool:
    """Predicate for :func:`quantize_tree` on LM trees: quantize only
    the matmul projection / embedding leaves. Scan-stacked norm gains
    are (R, d) and pass the >=2D check, but they are not weight
    matrices — quantizing them breaks both accuracy and the stacked
    leading axis. A path entry is a key, or (as JAX's key paths give
    it) an object with a ``key``."""
    last = path[-1]
    return getattr(last, "key", last) in LM_WEIGHT_KEYS


def is_quantized(leaf) -> bool:
    """True for a weight-only int8 ``{"q", "s"}`` leaf."""
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


def resolve_weight(w, dtype=None):
    """Materialize a weight leaf for a float matmul: tensors pass
    through; weight-only int8 ``{"q", "s"}`` leaves dequantize to
    ``dtype`` (exact: the scales are the ones the quantizer chose)."""
    if is_quantized(w):
        out = w["q"].to(torch.float32) * w["s"]
        return out.to(dtype) if dtype is not None else out
    return w
