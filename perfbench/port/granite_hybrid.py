"""The port's Mamba2 / attention hybrid with a dropless expert layer in
every block (``repro_torch.models.lm`` at ``ModelConfig.layer_pattern``)
over the harness's weights: granite-4.0-h-small's share of an
expert-parallel deployment.

The port's tree is one stage of ``n_layers / period`` repeats of the
layer pattern's period; each of its stacked leaves is a strided view of
the harness's tensor of that kind (no copy), the attention's q / k / v
concatenated into ``wqkv`` (``lm.fuse_params``). ``build`` takes the
weights over: ``lm.fold_multipliers`` folds the residual multiplier,
the softmax scale and the logit scale into them in place (the harness
drops its dict after the build and makes the weights anew for the
check), so no second copy of the expert leaves is ever held.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models import lm
from perfbench.reference.granite_4_h_small import dims

KINDS = {"mamba": "M", "attention": "A"}


def layer_pattern(types) -> str:
    """The shortest period that repeats to the whole ``layer_types``."""
    full = "".join(KINDS[t] for t in types)
    return next(full[:p] for p in range(1, len(full) + 1)
                if full[:p] * (len(full) // p) == full)


def port_config(c: dict) -> ModelConfig:
    for key, want in (("hidden_act", "silu"), ("mamba_n_groups", 1),
                      ("position_embedding_type", "nope"),
                      ("normalization_function", "rmsnorm"),
                      ("tie_word_embeddings", True),
                      ("attention_bias", False), ("mamba_proj_bias", False),
                      ("mamba_conv_bias", True)):
        if c[key] != want:
            raise ValueError(f"{c['name']}: no port of {key}={c[key]!r}")
    s = dims(c)
    if s["mh"] * s["mp"] != s["d_in"]:
        raise ValueError(f"{c['name']}: mamba heads x head size != d_in")
    first, stop = c["held_experts"]
    if stop - first != c["num_local_experts"]:
        raise ValueError(f"{c['name']}: held_experts {c['held_experts']} "
                         f"for {c['num_local_experts']} experts")
    return ModelConfig(
        name=c["name"], family="hybrid", n_layers=s["layers"],
        d_model=s["d"], n_heads=s["h"], n_kv_heads=s["hkv"], d_ff=s["f"],
        vocab=c["vocab_size"], head_dim=s["hd"], act="silu", norm="rms",
        rope="nope",
        moe=MoEConfig(n_experts=s["router"],
                      top_k=c["num_experts_per_tok"], d_ff=s["f"],
                      n_shared=1, dropless=True, held=(first, stop),
                      shared_d_ff=s["fs"]),
        ssm=SSMConfig(d_state=s["n"], d_conv=s["k_conv"],
                      expand=c["mamba_expand"], head_dim=s["mp"],
                      chunk=c["mamba_chunk_size"]),
        layer_pattern=layer_pattern(c["layer_types"]),
        norm_eps=float(c["rms_norm_eps"]),
        embedding_multiplier=float(c["embedding_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        attention_multiplier=float(c["attention_multiplier"]),
        logits_scaling=float(c["logits_scaling"]), tie_embeddings=True,
        dtype=c["dtype"])


def seed_tree(cfg: ModelConfig, w: dict) -> dict:
    """The harness's weights in the port's split ("seed") layout: body
    position i of the period takes layers i, i + period, ... of each
    per-layer tensor, and the matching layers of the Mamba or attention
    tensors, as strided views."""
    period = cfg.layer_pattern
    per_m = period.count("M")
    stacked = {}
    for i, kind in enumerate(period):
        lay = slice(i, None, len(period))
        blk = {"norm1": {"g": w["input_norm"][lay]},
               "norm2": {"g": w["post_norm"][lay]},
               "ffn": {"router": w["router"][lay], "wgi": w["e_in"][lay],
                       "wo": w["e_out"][lay], "shared_wgi": w["s_in"][lay],
                       "shared_wo": w["s_out"][lay]}}
        if kind == "M":
            mi = slice(period[:i].count("M"), None, per_m)
            blk["mamba"] = {
                "in_proj": w["m_in"][mi], "out_proj": w["m_out"][mi],
                "conv_w": w["m_conv_w"][mi], "conv_b": w["m_conv_b"][mi],
                "A_log": w["m_A_log"][mi], "dt_bias": w["m_dt_bias"][mi],
                "D": w["m_D"][mi], "norm_g": w["m_norm"][mi]}
        else:
            ai = slice(period[:i].count("A"), None, len(period) - per_m)
            blk["attn"] = {k: w[f"a_{k}"][ai] for k in ("wq", "wk", "wv",
                                                         "wo")}
        stacked[str(i)] = blk
    return {"embed": w["embed"],
            "stages": [{"stacked": stacked, "shared": {}}],
            "final_norm": {"g": w["final_norm"]}}


class System:
    def __init__(self, cfg: ModelConfig, params: dict, device):
        self.cfg, self.params, self.device = cfg, params, device

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> the last position's logits (B, vocab), fp32,
        through ``lm.prefill`` (its cache, the Mamba states and the
        attention KV, is dropped)."""
        logits, _cache = lm.prefill(self.params, tokens, self.cfg)
        return logits

    def release(self) -> None:
        self.params = None


def build(config: dict, weights: dict, device) -> System:
    cfg = port_config(config)
    params = lm.fuse_params(cfg, seed_tree(cfg, weights))
    return System(cfg, lm.fold_multipliers(cfg, params), device)
