"""Swin-T — the paper's own target model (plus ViT-B for reference).

The port's own copy of the configuration dataclasses: the port imports
nothing of the JAX package, so these mirror it field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    name: str = "swin-t"
    img_size: int = 224
    patch: int = 4                     # 4x4 stride-4 patch-embed conv
    in_chans: int = 3
    embed_dim: int = 96                # doubles per stage
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    qkv_bias: bool = True


CONFIG = SwinConfig()


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str = "vit-b16"
    img_size: int = 224
    patch: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 1000


VIT_CONFIG = ViTConfig()


def reduced() -> SwinConfig:
    return SwinConfig(name="swin-smoke", img_size=56, patch=4, embed_dim=32,
                      depths=(1, 1), num_heads=(2, 4), window=7,
                      num_classes=10)
