"""rwkv6-3b "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536. No attention heads; the WKV6
recurrence uses 64-dim heads (2560/64 = 40 heads). The port's own copy
of the JAX package's ``configs/rwkv6_3b.py``.
"""
from repro_torch.core.types import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # wkv heads = d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    act="relu",            # rwkv channel-mix uses relu^2
    norm="layer",
    rope="none",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    tie_embeddings=False,
    subquadratic=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, act="relu",
        norm="layer", rope="none",
        rwkv=RWKVConfig(head_dim=16, decay_lora=16, tokenshift_lora=8),
        tie_embeddings=False, subquadratic=True,
    )
