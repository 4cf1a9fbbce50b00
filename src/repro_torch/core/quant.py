"""Weight-only int8 leaves, as far as ``ops.matmul`` reads them.

A leaf ``{"q": int8 (K, N), "s": fp32 (1, N)}`` holds a weight quantized
per output channel. The int8 kernel mode and the quantizers arrive with
the slice that runs them.
"""
from __future__ import annotations

import torch


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
