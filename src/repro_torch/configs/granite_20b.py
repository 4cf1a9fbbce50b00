"""granite-20b [arXiv:2405.04324] — llama-arch code model, MQA (kv=1).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
GPT-BigCode-style: MQA + GELU MLP + layernorm. The port's own
copy of the JAX package's ``configs/granite_20b.py``.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="gelu",
    norm="layer",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, d_ff=256, vocab=256, act="gelu", norm="layer",
    )
