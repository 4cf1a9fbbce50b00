"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) d_ff=1408 vocab=151936, MoE 60 routed top-4
+ 4 shared experts.
The port's own copy of the JAX package's ``configs/qwen2_moe.py``.
"""
from repro_torch.core.types import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    act="silu",
    norm="rms",
    moe=MoEConfig(n_experts=60, top_k=4, d_ff=1408, n_shared=4),
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=48, vocab=256, act="silu", norm="rms",
        moe=MoEConfig(n_experts=6, top_k=2, d_ff=48, n_shared=1,
                      capacity_factor=4.0),
        tie_embeddings=False,
    )
