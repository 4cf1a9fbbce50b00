"""Architecture registry of the port: ``--arch <id>`` resolves through
``ARCHS``, in the JAX package's order, with its shape cells.

The JAX package's registry names ten architectures; the port runs all
ten. ``PORT_ONLY`` names the architectures the port runs beyond them
(outside ``ARCHS``, which the dry run walks over JAX's shape cells):
``get_config`` and ``get_reduced`` resolve them too. ``PENDING`` names any architecture a later item of ``ROADMAP.md``
may add before its slice lands: asked for, it raises with a pointer to
that item.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_7b, gemma3_27b, granite_4_h_small,
                                 granite_20b, internlm2_20b, phi35_moe,
                                 qwen2_moe, qwen2_vl, rwkv6_3b, whisper_base,
                                 zamba2)
from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES
from repro_torch.core.types import ModelConfig

_MODULES = {
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "qwen2-moe-a2.7b": qwen2_moe,
    "zamba2-1.2b": zamba2,
    "qwen2-vl-2b": qwen2_vl,
    "granite-20b": granite_20b,
    "deepseek-7b": deepseek_7b,
    "gemma3-27b": gemma3_27b,
    "internlm2-20b": internlm2_20b,
    "whisper-base": whisper_base,
    "rwkv6-3b": rwkv6_3b,
}

ARCHS = {name: mod.CONFIG for name, mod in _MODULES.items()}

# the port's own architectures (the JAX package has no counterpart)
PORT_ONLY = {"granite-4.0-h-small": granite_4_h_small}
REDUCED = {name: mod.reduced for name, mod in _MODULES.items()}

# architectures not ported yet, with the ROADMAP item that ports each
PENDING: dict = {}

# Shape-cell applicability (the JAX package's, DESIGN.md section 5):
#  - long_500k only for sub-quadratic archs
#  - (no encoder-only archs in this pool, so no decode skips)


def cell_applicable(arch: str, shape: str) -> bool:
    cfg = ARCHS[arch]
    if shape == "long_500k" and not cfg.subquadratic:
        return False
    return True


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in PORT_ONLY:
        return PORT_ONLY[arch]
    if arch in PENDING:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: ROADMAP.md {PENDING[arch]}")
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted([*_MODULES, *PORT_ONLY, *PENDING])}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def all_cells(include_skipped: bool = False):
    for arch in ARCHS:
        for shape in SHAPES:
            if include_skipped or cell_applicable(arch, shape):
                yield arch, shape


__all__ = ["ARCHS", "PENDING", "PORT_ONLY", "REDUCED", "SHAPES", "SMOKE_SHAPES",
           "all_cells", "cell_applicable", "get_config", "get_reduced"]
