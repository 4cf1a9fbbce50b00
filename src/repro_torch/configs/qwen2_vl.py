"""qwen2-vl-2b [arXiv:2409.12191] — M-RoPE, dynamic-resolution VLM.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The vision
frontend is a stub: the caller passes precomputed patch embeddings
(``extra["vis_embeds"]``) and their (t, h, w) positions
(``extra["positions3"]``); the backbone applies M-RoPE over (t, h, w)
sections. The port's own copy of the JAX package's
``configs/qwen2_vl.py``.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    act="silu",
    norm="rms",
    rope="mrope",
    frontend="vision",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, act="silu", norm="rms",
        rope="mrope", frontend="vision",
    )
