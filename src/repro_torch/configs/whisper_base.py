"""whisper-base [arXiv:2212.04356] — encoder-decoder, conv frontend stub.

6L (enc) + 6L (dec), d_model=512 8H (kv=8) d_ff=2048 vocab=51865. The
audio conv frontend is a stub: the encoder takes precomputed frame
embeddings (B, 1500, 512), and cross-attention reads its 1500 frames.
The port's own copy of the JAX package's ``configs/whisper_base.py``.
"""
from repro_torch.core.types import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    act="gelu",
    norm="layer",
    rope="none",           # whisper uses learned/sinusoidal abs positions
    encdec=True,
    n_enc_layers=6,
    cross_len=1500,
    frontend="audio",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, act="gelu",
        norm="layer", rope="none", encdec=True, n_enc_layers=2,
        cross_len=30, frontend="audio",
    )
