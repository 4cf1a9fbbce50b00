"""Stage-compiled language model: init / train forward / prefill / decode.

The JAX package scans each stage over its stacked layers; here a Python
loop walks the repeats and hands each block the views ``leaf[i]`` of the
stacked parameter and cache leaves. The parameter tree and the cache
keep the JAX package's layout — stacked leaves ``(R, ...)``, cache
leaves ``(R, B, ...)`` — so the two packages' trees compare leaf for
leaf (``convert.from_jax_params`` loads a JAX tree).

Serving runs as the JAX package serves recurrent archs: one-shot
:func:`prefill` at the prompts' exact lengths, then dense-cache
:func:`decode_step` with greedy picks (:func:`greedy`). This slice runs
the RWKV6 blocks; the dense, hybrid and encoder-decoder paths of the
JAX module (attention KV caches, paged serving, tied TP heads) come
with later slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn

from repro_torch.core import runtime
from repro_torch.core.params import ParamTree
from repro_torch.core.types import ModelConfig, Stage
from repro_torch.kernels import ops
from repro_torch.models import blocks, rope

NEG_INF = -1e30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of trees of one structure (dicts,
    lists, tuples)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ----------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 256 (the JAX package's
    shardable padding); the pad columns are masked in the logits."""
    return -(-cfg.vocab // 256) * 256


def _init_stage(gen, stage: Stage, cfg: ModelConfig, dtype, device):
    stacked, shared = {}, {}
    for i, blk in enumerate(stage.body):
        stack = None if blk.shared else stage.repeat
        p = blocks.init_block(gen, blk, cfg, stack, dtype, device)
        (shared if blk.shared else stacked)[str(i)] = p
    return {"stacked": stacked, "shared": shared}


def init_lm(cfg: ModelConfig, generator: torch.Generator, device="cuda",
            dtype=None) -> Dict[str, Any]:
    """Random parameters in the JAX package's tree, drawn from
    ``generator`` on the generator's own device (a CUDA generator draws
    the 3 B normals of rwkv6-3b in well under a second) and placed on
    ``device``. ``dtype``: default ``cfg.dtype``."""
    device = runtime.resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    d = cfg.d_model
    vp = padded_vocab(cfg)

    def normal(shape, scale):
        t = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32) * scale
        return t.to(dtype=dtype, device=device)

    params: Dict[str, Any] = {"embed": normal((vp, d), 0.02)}
    params["stages"] = [_init_stage(generator, stage, cfg, dtype, device)
                        for stage in cfg.stages()]
    params["final_norm"] = {"g": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layer":
        params["final_norm"]["b"] = torch.zeros((d,), dtype=dtype,
                                                device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, vp), 1 / math.sqrt(d))
    return params


# ----------------------------------------------------------------------
# Stage execution
# ----------------------------------------------------------------------


def _run_stage(stage: Stage, sp, x, *, cfg: ModelConfig, mode: str,
               cache=None):
    """Walk a stage's repeats. Returns (x, aux, states): the decode
    mode's new cache or the prefill mode's per-layer states, stacked
    over the repeats as the JAX scan stacks them (``{}`` in train)."""
    stacked, shared = sp["stacked"], sp["shared"]
    aux = 0.0
    per_layer: List[dict] = []
    for rep in range(stage.repeat):
        out_states = {}
        for i, blk in enumerate(stage.body):
            key = str(i)
            bp = (_tree_map(lambda a, r=rep: a[r], stacked[key])
                  if key in stacked else shared[key])
            csl = (_tree_map(lambda a, r=rep: a[r], cache[key])
                   if cache and key in cache else None)
            x, io = blocks.apply_block(blk, bp, x, cfg=cfg, mode=mode,
                                       cache=csl)
            aux += io.aux
            state = io.new_cache if mode == "decode" else io.prefill_state
            if state is not None:
                out_states[key] = state
        per_layer.append(out_states)
    states = ({} if not per_layer[0] else
              _tree_map(lambda *ls: torch.stack(ls), *per_layer))
    return x, aux, states


def _run_stages(stage_params, stages, x, *, cache=None, **kw):
    aux_total = 0.0
    all_states = []
    for si, (stage, sp) in enumerate(zip(stages, stage_params)):
        stage_cache = cache[si] if cache is not None else None
        x, aux, states = _run_stage(stage, sp, x, cache=stage_cache, **kw)
        aux_total += aux
        all_states.append(states)
    return x, aux_total, all_states


# ----------------------------------------------------------------------
# Embedding / logits
# ----------------------------------------------------------------------


def embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens]


def unembed(params, x, cfg: ModelConfig):
    x = ops.layernorm(x, params["final_norm"]["g"],
                      params["final_norm"].get("b"), kind=cfg.norm)
    if cfg.tie_embeddings:
        # the kernel reads weights with unit column stride: the tied
        # head multiplies by a transposed copy of the table
        w = params["embed"].t().contiguous()
    else:
        w = params["lm_head"]
    logits = ops.matmul(x, w, out_dtype=torch.float32)
    if padded_vocab(cfg) != cfg.vocab:  # mask pad columns out of softmax
        logits[..., cfg.vocab:] = NEG_INF
    return logits


def _add_positions(x, cfg: ModelConfig):
    """The sinusoidal absolute positions 0..S-1 of the position-free
    archs, in x's dtype (RoPE archs rotate inside attention instead)."""
    if cfg.rope != "none":
        return x
    pe = rope.sinusoidal_embedding(x.shape[1], cfg.d_model, x.device)
    return x + pe.to(x.dtype)[None]


def forward(params, tokens, cfg: ModelConfig):
    """Full train-mode forward -> (logits, aux_loss)."""
    x = _add_positions(embed(params, tokens, cfg), cfg)
    x, aux, _ = _run_stages(params["stages"], cfg.stages(), x, cfg=cfg,
                            mode="train")
    return unembed(params, x, cfg), torch.tensor(aux, dtype=torch.float32)


# ----------------------------------------------------------------------
# Recurrent-state cache: init, prefill conversion
# ----------------------------------------------------------------------


def _slot_cache_init(blk, cfg: ModelConfig, repeat, batch, dtype, device):
    blocks._check(blk)
    c = {}
    if blk.mixer == "rwkv6":
        r = cfg.rwkv
        h = cfg.d_model // r.head_dim
        c["rwkv_t"] = {
            "x_prev_t": torch.zeros((repeat, batch, cfg.d_model),
                                    dtype=dtype, device=device),
            "wkv": torch.zeros((repeat, batch, h, r.head_dim, r.head_dim),
                               dtype=torch.float32, device=device)}
    if blk.ffn == "rwkv6_cmix":
        c["rwkv_c"] = {"x_prev_c": torch.zeros(
            (repeat, batch, cfg.d_model), dtype=dtype, device=device)}
    return c


def _init_cache_tree(cfg: ModelConfig, batch, dtype, device):
    out = []
    for stage in cfg.stages():
        sc = {}
        for i, blk in enumerate(stage.body):
            c = _slot_cache_init(blk, cfg, stage.repeat, batch, dtype,
                                 device)
            if c:
                sc[str(i)] = c
        out.append(sc)
    return out


def init_cache(cfg: ModelConfig, batch: int, dtype=None, device="cuda"):
    """Zeroed decode cache. The recurrent state has no sequence axis; the
    KV capacity ``alloc`` of the JAX signature comes with attention."""
    device = runtime.resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    return _init_cache_tree(cfg, batch, dtype, device)


def states_to_cache(cfg: ModelConfig, all_states):
    """Prefill states -> decode cache. Recurrent state passes through;
    attention KV (padded to the cache's length in the JAX package)
    arrives with the dense slice."""
    out = []
    for states in all_states:
        sc = {}
        for key, st in states.items():
            extra = set(st) - {"rwkv_t", "rwkv_c"}
            if extra:
                raise NotImplementedError(
                    f"not ported yet: {sorted(extra)} cache leaves, "
                    "ROADMAP.md queue 1 item 4")
            sc[key] = dict(st)
        out.append(sc)
    return out


def prefill_states(params, tokens, cfg: ModelConfig, *, last_pos=None):
    """Full-sequence prefill -> (last-position logits, raw per-layer
    states). Recurrent mixers fold any padding into their state, so the
    recurrent archs prefill at exact lengths: ``last_pos`` (bucketed
    prefill of attention archs) is not taken."""
    if last_pos is not None:
        raise NotImplementedError(
            "bucketed prefill (last_pos): ROADMAP.md queue 1 item 5")
    x = _add_positions(embed(params, tokens, cfg), cfg)
    x, _, states = _run_stages(params["stages"], cfg.stages(), x, cfg=cfg,
                               mode="prefill")
    logits = unembed(params, x[:, -1:], cfg)
    return logits[:, 0], states


def prefill(params, tokens, cfg: ModelConfig):
    """Full-sequence prefill -> (last-position logits, dense cache)."""
    logits, states = prefill_states(params, tokens, cfg)
    return logits, states_to_cache(cfg, states)


def decode_step(params, cache, tokens, lengths, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); lengths: (B,) tokens in cache.
    Returns (logits (B, vocab), new_cache)."""
    x = embed(params, tokens, cfg)
    if cfg.rope == "none":
        # rows ``lengths`` of the JAX package's 65536-row table
        pe = rope.sinusoidal_rows(lengths, cfg.d_model)
        x = x + pe[:, None].to(x.dtype)
    x, _, new_cache = _run_stages(params["stages"], cfg.stages(), x,
                                  cfg=cfg, mode="decode", cache=cache)
    logits = unembed(params, x, cfg)
    return logits[:, 0], new_cache


def greedy(params, prompts, cfg: ModelConfig, n_new: int):
    """Greedy generation for a batch of equal-length prompts (B, S):
    prefill, then ``n_new - 1`` decode steps, each feeding back the
    argmax. Returns the (B, n_new) picked tokens — the stream
    ``tests/conftest.py::manual_greedy`` gives per prompt."""
    logits, cache = prefill(params, prompts, cfg)
    toks = [torch.argmax(logits, dim=-1)]
    lengths = torch.full((prompts.shape[0],), prompts.shape[1],
                         dtype=torch.int32, device=prompts.device)
    for _ in range(n_new - 1):
        logits, cache = decode_step(params, cache, toks[-1][:, None],
                                    lengths, cfg)
        toks.append(torch.argmax(logits, dim=-1))
        lengths = lengths + 1
    return torch.stack(toks, dim=1)


# --------------------------- nn.Module wrapper -------------------------


class LanguageModel(nn.Module):
    """The LM as a module over the parameter tree. ``params``: a tree as
    ``init_lm`` or ``from_jax_params`` make it; by default a random one
    drawn from ``generator`` (seed 0). Runs on the card unless
    ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, params=None, *, device="cuda",
                 dtype=None, generator=None):
        super().__init__()
        device = runtime.resolve_device(device)
        if params is None:
            params = init_lm(cfg, generator or torch.Generator()
                             .manual_seed(0), device=device, dtype=dtype)
        self.cfg = cfg
        self.params = ParamTree(params)

    def forward(self, tokens: torch.Tensor):
        return forward(self.params.tree(), tokens, self.cfg)

    def prefill(self, tokens: torch.Tensor):
        return prefill(self.params.tree(), tokens, self.cfg)

    def decode_step(self, cache, tokens: torch.Tensor, lengths: torch.Tensor):
        return decode_step(self.params.tree(), cache, tokens, lengths,
                           self.cfg)

    def greedy(self, prompts: torch.Tensor, n_new: int) -> torch.Tensor:
        return greedy(self.params.tree(), prompts, self.cfg, n_new)
