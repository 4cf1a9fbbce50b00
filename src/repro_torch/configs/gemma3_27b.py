"""gemma3-27b [hf:google/gemma-3 family] — 5:1 local:global attention.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144. Local layers
use a 1024-token sliding window (a ring-buffer KV cache at decode);
every 6th layer is global. The port's own copy of the JAX package's
``configs/gemma3_27b.py``.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    act="geglu",
    norm="rms",
    pattern_local=5,
    pattern_global=1,
    local_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=True,  # 5:1 sliding window => sub-quadratic in practice
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
        act="gelu", norm="rms", pattern_local=2, pattern_global=1,
        local_window=16, subquadratic=True,
    )
