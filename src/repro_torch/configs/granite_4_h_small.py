"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small, config.json]:
IBM Granite 4.0-H Small, 32B-A9B.

40L d_model=4096, vocab=100352 (tied). A period of 10 layers, nine
Mamba2 (128 heads of 64, d_state 128, one group, conv 4 with bias,
chunk 256) and one attention layer (GQA 32/8, head_dim 128, no position
embedding), at layers 5, 15, 25 and 35; every layer's FFN a dropless MoE
of 72 experts of width 768, top-10 (softmax over the top-k logits), plus
one ungated shared SwiGLU of width 1536. muP: the embedding times 12,
every mixer and FFN output times 0.22 before the residual, the softmax
scale 1/128, the logits over 16; RMS eps 1e-5.

A port-only architecture (the JAX package's registry lacks it).
``CONFIG`` holds all 72 experts; a device of an expert-parallel
deployment holds its range (``MoEConfig.held``).
"""
from repro_torch.core.types import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,
    vocab=100352,
    head_dim=128,
    act="silu",
    norm="rms",
    rope="nope",
    moe=MoEConfig(n_experts=72, top_k=10, d_ff=768, n_shared=1,
                  dropless=True, shared_d_ff=1536),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    layer_pattern="MMMMMAMMMM",
    norm_eps=1e-5,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-smoke", family="hybrid", n_layers=8,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=256,
        head_dim=16, act="silu", norm="rms", rope="nope",
        moe=MoEConfig(n_experts=8, top_k=3, d_ff=32, n_shared=1,
                      dropless=True, shared_d_ff=48),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk=8),
        layer_pattern="MMAM", norm_eps=1e-5, embedding_multiplier=12.0,
        residual_multiplier=0.22, attention_multiplier=1 / 16,
        logits_scaling=16.0, tie_embeddings=True,
    )
