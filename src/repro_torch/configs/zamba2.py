"""zamba2-1.2b [arXiv:2411.15242] — hybrid Mamba2 + shared attention blocks.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
The shared transformer block (full attention + MLP, single weight copy)
is applied every 6th layer, per the Zamba2 shared-block design.
The port's own copy of the JAX package's ``configs/zamba2.py``.
"""
from repro_torch.core.types import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    act="gelu",
    norm="rms",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    hybrid_period=6,
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, act="gelu", norm="rms",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32),
        hybrid_period=3, subquadratic=True,
    )
