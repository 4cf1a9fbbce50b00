"""deepseek-7b [arXiv:2401.02954] — llama-arch dense.

30L d_model=4096 32H (kv=32) d_ff=11008 vocab=102400. The port's own
copy of the JAX package's ``configs/deepseek_7b.py``.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    act="silu",
    norm="rms",
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=172, vocab=256, act="silu", norm="rms",
        tie_embeddings=False,
    )
