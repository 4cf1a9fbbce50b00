"""Architecture registry of the port: the language models it runs.

The JAX package's registry names ten architectures; the port runs all
ten. ``PENDING`` names any architecture a later item of ``ROADMAP.md``
may add before its slice lands: asked for, it raises with a pointer to
that item.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_7b, gemma3_27b, granite_20b,
                                 internlm2_20b, phi35_moe, qwen2_moe,
                                 qwen2_vl, rwkv6_3b, whisper_base, zamba2)
from repro_torch.core.types import ModelConfig

_MODULES = {
    "deepseek-7b": deepseek_7b,
    "gemma3-27b": gemma3_27b,
    "granite-20b": granite_20b,
    "internlm2-20b": internlm2_20b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "qwen2-moe-a2.7b": qwen2_moe,
    "qwen2-vl-2b": qwen2_vl,
    "rwkv6-3b": rwkv6_3b,
    "whisper-base": whisper_base,
    "zamba2-1.2b": zamba2,
}

# architectures not ported yet, with the ROADMAP item that ports each
PENDING: dict = {}


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in PENDING:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: ROADMAP.md {PENDING[arch]}")
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted([*_MODULES, *PENDING])}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


__all__ = ["PENDING", "get_config", "get_reduced"]
