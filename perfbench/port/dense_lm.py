"""The port's dense decoder (``repro_torch.models.lm``) and its serving
engine (``repro_torch.serve.engine.Engine``) over the harness's
weights. The port's tree is its own: ``lm.fuse_params`` concatenates
the q / k / v and gate / up matrices of the published layout into the
panels the port reads (``wqkv``, ``wgi``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import ModelConfig, PagingConfig
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, Request


def port_config(c: dict) -> ModelConfig:
    if c["hidden_act"] != "silu":
        raise ValueError(f"{c['name']}: no port of act {c['hidden_act']!r}")
    return ModelConfig(
        name=c["name"], family="dense", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], act="silu", norm="rms",
        rope_theta=float(c["rope_theta"]),
        tie_embeddings=bool(c["tie_word_embeddings"]), dtype=c["dtype"])


def seed_tree(w: dict) -> dict:
    """The harness's weights in the port's split ("seed") layout."""
    blk = {"norm1": {"g": w["attn_norm"]},
           "attn": {"wq": w["wq"], "wk": w["wk"], "wv": w["wv"],
                    "wo": w["wo"]},
           "norm2": {"g": w["mlp_norm"]},
           "ffn": {"wg": w["w_gate"], "wi": w["w_up"], "wo": w["w_down"]}}
    return {"embed": w["embed"],
            "stages": [{"stacked": {"0": blk}, "shared": {}}],
            "final_norm": {"g": w["final_norm"]}, "lm_head": w["lm_head"]}


class System:
    def __init__(self, cfg: ModelConfig, params: dict, device):
        self.cfg, self.params, self.device = cfg, params, device
        self._engine = None

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> the last position's logits (B, vocab), fp32,
        through ``lm.prefill`` (its dense cache is dropped)."""
        logits, _cache = lm.prefill(self.params, tokens, self.cfg)
        return logits

    def engine(self, *, n_slots: int, max_len: int, page_size: int,
               n_pages: int, eos_id: int) -> Engine:
        """A greedy engine with monolithic one-shot prefill, no prefix
        cache and no speculation."""
        self._engine = Engine(
            self.params, self.cfg, n_slots=n_slots, max_len=max_len,
            eos_id=eos_id, temperature=0.0,
            paging=PagingConfig(page_size=page_size, n_pages=n_pages),
            device=self.device)
        return self._engine

    @staticmethod
    def request(rid: int, prompt: np.ndarray, max_new: int) -> Request:
        return Request(rid=rid, prompt=prompt, max_new=max_new)

    def release(self) -> None:
        if self._engine is not None:
            self._engine.cache = None
            self._engine.params = None
        self._engine = None
        self.params = None


def build(config: dict, weights: dict, device) -> System:
    cfg = port_config(config)
    return System(cfg, lm.fuse_params(cfg, seed_tree(weights)), device)
