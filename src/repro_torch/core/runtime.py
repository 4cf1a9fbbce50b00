"""Process-wide switches the models read.

The implementation switch:

  * 'auto' — the tensor's device decides: a CPU tensor takes each
             kernel's plain PyTorch version, a CUDA tensor the kernel
             written by hand for Hopper (default)
  * 'ref'  — the plain PyTorch versions everywhere, on the card too:
             the whole-forward reference a kernel run is held against

The **pipeline-fusion** switch: when on (default), the models fuse the
pre-norm prologue, multi-head projections and residual/gating
epilogues into single row-wise kernel launches; when off they compose
the per-op kernels (separate norms, dense window scores).

And the device rules of the entry points: :func:`resolve_device` (the
card unless the caller asks for the CPU) and :func:`to_device` (host
values onto the card without waiting for it).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

_IMPL = "auto"
_FUSE_PIPELINE = True


def resolve_impl() -> str:
    return _IMPL


def set_impl(impl: str) -> None:
    global _IMPL
    if impl not in ("auto", "ref"):
        raise ValueError(f"impl must be 'auto' or 'ref', not {impl!r}")
    _IMPL = impl


@contextlib.contextmanager
def use_impl(impl: str):
    global _IMPL
    prev = _IMPL
    set_impl(impl)
    try:
        yield
    finally:
        _IMPL = prev


def pipeline_fusion() -> bool:
    return _FUSE_PIPELINE


def set_pipeline_fusion(on: bool) -> None:
    global _FUSE_PIPELINE
    _FUSE_PIPELINE = bool(on)


@contextlib.contextmanager
def use_pipeline_fusion(on: bool):
    global _FUSE_PIPELINE
    prev = _FUSE_PIPELINE
    _FUSE_PIPELINE = bool(on)
    try:
        yield
    finally:
        _FUSE_PIPELINE = prev


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device with no card
    present raises: the port never carries on on the CPU unless the
    caller asked for it with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return device


def to_device(value, device) -> torch.Tensor:
    """``value`` as a tensor on ``device``. A tensor moves as ``.to``
    moves it; a host value (an int, a sequence, a numpy array) is
    copied once into pinned memory and sent with a non-blocking copy on
    a CUDA device, so the call never waits for the card (a plain
    ``torch.as_tensor(value, device="cuda")`` synchronises)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    host = torch.from_numpy(np.array(value))
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host
