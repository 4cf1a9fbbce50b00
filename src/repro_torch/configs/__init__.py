"""Architecture registry of the port: the language models it runs.

The JAX package's registry names ten architectures; the port runs those
whose slice has landed and raises on the others with a pointer to the
queue of ``ROADMAP.md`` that owes them.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_7b, gemma3_27b, granite_20b,
                                 internlm2_20b, rwkv6_3b, whisper_base)
from repro_torch.core.types import ModelConfig

_MODULES = {
    "deepseek-7b": deepseek_7b,
    "gemma3-27b": gemma3_27b,
    "granite-20b": granite_20b,
    "internlm2-20b": internlm2_20b,
    "rwkv6-3b": rwkv6_3b,
    "whisper-base": whisper_base,
}

# every other architecture of the JAX package, with the ROADMAP item
# that ports it
PENDING = {
    "qwen2-vl-2b": "queue 1 item 8 (mrope, vision frontend)",
    "phi3.5-moe-42b-a6.6b": "queue 1 item 8 (MoE)",
    "qwen2-moe-a2.7b": "queue 1 item 8 (MoE)",
    "zamba2-1.2b": "queue 1 item 8 (mamba2 hybrid)",
}


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
