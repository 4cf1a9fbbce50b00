"""internlm2-20b [arXiv:2403.17297] — dense GQA.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544. The port's own
copy of the JAX package's ``configs/internlm2_20b.py``.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    act="silu",
    norm="rms",
    tie_embeddings=False,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=192, vocab=256, act="silu", norm="rms",
        tie_embeddings=False,
    )
