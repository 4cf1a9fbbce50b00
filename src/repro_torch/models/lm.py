"""Stage-compiled language model: init / train forward / prefill / decode.

The JAX package scans each stage over its stacked layers; here a Python
loop walks the repeats and hands each block the views ``leaf[i]`` of the
stacked parameter and cache leaves. The parameter tree and the cache
keep the JAX package's layout — stacked leaves ``(R, ...)``, cache
leaves ``(R, B, ...)`` — so the two packages' trees compare leaf for
leaf (``convert.from_jax_params`` loads a JAX tree).

Serving runs as the JAX package's dense-cache oracle does: one-shot
:func:`prefill` at the prompts' exact lengths into a cache of ``alloc``
positions, then :func:`decode_step` with greedy picks (:func:`greedy`).
The port runs the dense decoder archs (global attention + MLP: the KV
cache leaves ``(R, B, alloc, Hkv, hd)``, written in place at decode)
and RWKV6 (recurrent state); sliding windows, the hybrid and
encoder-decoder paths, paged serving and tied TP heads come with later
slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.core import runtime
from repro_torch.core.params import ParamTree
from repro_torch.core.types import ModelConfig, Stage
from repro_torch.kernels import ops
from repro_torch.models import blocks, rope
from repro_torch.models.attention import KVCache

NEG_INF = -1e30
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of trees of one structure (dicts,
    lists, tuples, named tuples)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        items = [_tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
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
               positions=None, lengths=None, cache=None):
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
                                       positions=positions, lengths=lengths,
                                       cache=csl)
            aux += io.aux
            state = io.new_cache if mode == "decode" else io.prefill_state
            if state is not None:
                out_states[key] = state
        per_layer.append(out_states)
    states = ({} if not per_layer[0] else
              _tree_map(lambda *ls: torch.stack(ls), *per_layer))
    if mode == "decode":
        # the leaves a block wrote in place (the attention KV) are not in
        # its new cache: the stage's stacked leaves hold the step already
        states = {key: {**cache[key], **states.get(key, {})}
                  for key in cache}
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


def _positions(tokens):
    """RoPE positions of a full sequence: 0..S-1 per row, (B, S)."""
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


def forward(params, tokens, cfg: ModelConfig):
    """Full train-mode forward -> (logits, aux_loss)."""
    x = _add_positions(embed(params, tokens, cfg), cfg)
    x, aux, _ = _run_stages(params["stages"], cfg.stages(), x, cfg=cfg,
                            mode="train", positions=_positions(tokens))
    return unembed(params, x, cfg), torch.tensor(aux, dtype=torch.float32)


# ----------------------------------------------------------------------
# KV / recurrent-state cache: init, prefill conversion
# ----------------------------------------------------------------------


def _slot_cache_init(blk, cfg: ModelConfig, repeat, batch, alloc, dtype,
                     device):
    blocks._check(blk)
    c = {}
    if blk.mixer == "attn":
        shape = (repeat, batch, alloc, cfg.n_kv_heads, cfg.head_dim)
        c["kv"] = KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device))
    elif blk.mixer == "rwkv6":
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


def _init_cache_tree(cfg: ModelConfig, batch, alloc, dtype, device):
    out = []
    for stage in cfg.stages():
        sc = {}
        for i, blk in enumerate(stage.body):
            c = _slot_cache_init(blk, cfg, stage.repeat, batch, alloc,
                                 dtype, device)
            if c:
                sc[str(i)] = c
        out.append(sc)
    return out


def init_cache(cfg: ModelConfig, batch: int, alloc: Optional[int] = None,
               dtype=None, device="cuda"):
    """Zeroed decode cache: KV leaves of ``alloc`` positions (required
    when the arch has attention; the recurrent state has no sequence
    axis)."""
    device = runtime.resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    if alloc is None and any(blk.mixer == "attn" for stage in cfg.stages()
                             for blk in stage.body):
        raise ValueError(f"{cfg.name}: init_cache needs alloc, the KV "
                         "positions to hold")
    return _init_cache_tree(cfg, batch, alloc, dtype, device)


def states_to_cache(cfg: ModelConfig, all_states, alloc: int):
    """Prefill states -> decode cache: attention KV padded with zeros to
    ``alloc`` positions; recurrent state passes through."""
    out = []
    for states in all_states:
        sc = {}
        for key, st in states.items():
            c = dict(st)
            if "kv" in st:
                c["kv"] = KVCache(*(_pad_seq(t, alloc) for t in st["kv"]))
            sc[key] = c
        out.append(sc)
    return out


def _pad_seq(t, alloc):
    """Stacked prefill states (R, B, S, ...) in a zeroed (R, B, alloc,
    ...) buffer."""
    if alloc < t.shape[2]:
        raise ValueError(f"alloc {alloc} is shorter than the prompt "
                         f"({t.shape[2]} tokens)")
    out = t.new_zeros(t.shape[:2] + (alloc,) + t.shape[3:])
    out[:, :, :t.shape[2]] = t
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
                               mode="prefill", positions=_positions(tokens))
    logits = unembed(params, x[:, -1:], cfg)
    return logits[:, 0], states


def prefill(params, tokens, cfg: ModelConfig, *,
            alloc: Optional[int] = None):
    """Full-sequence prefill -> (last-position logits, dense cache of
    ``alloc`` positions; default: the prompt length)."""
    logits, states = prefill_states(params, tokens, cfg)
    return logits, states_to_cache(cfg, states, alloc or tokens.shape[1])


def decode_step(params, cache, tokens, lengths, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); lengths: (B,) tokens in cache.
    Returns (logits (B, vocab), new_cache). The attention KV leaves are
    written IN PLACE at position ``lengths`` (so ``cache`` holds the
    step too, and ``new_cache`` shares those leaves): a step that copied
    them would move the whole cache, 2.1 GB for deepseek-7b at B=4 x
    544 in fp32. The recurrent leaves are new tensors."""
    x = embed(params, tokens, cfg)
    if cfg.rope == "none":
        # rows ``lengths`` of the JAX package's 65536-row table
        pe = rope.sinusoidal_rows(lengths, cfg.d_model)
        x = x + pe[:, None].to(x.dtype)
    x, _, new_cache = _run_stages(params["stages"], cfg.stages(), x,
                                  cfg=cfg, mode="decode", lengths=lengths,
                                  cache=cache)
    logits = unembed(params, x, cfg)
    return logits[:, 0], new_cache


def greedy(params, prompts, cfg: ModelConfig, n_new: int):
    """Greedy generation for a batch of equal-length prompts (B, S):
    prefill, then ``n_new - 1`` decode steps, each feeding back the
    argmax. Returns the (B, n_new) picked tokens — the stream
    ``tests/conftest.py::manual_greedy`` gives per prompt (its cache
    sized ``S + n_new``)."""
    logits, cache = prefill(params, prompts, cfg,
                            alloc=prompts.shape[1] + n_new)
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

    def prefill(self, tokens: torch.Tensor, alloc: Optional[int] = None):
        return prefill(self.params.tree(), tokens, self.cfg, alloc=alloc)

    def decode_step(self, cache, tokens: torch.Tensor, lengths: torch.Tensor):
        return decode_step(self.params.tree(), cache, tokens, lengths,
                           self.cfg)

    def greedy(self, prompts: torch.Tensor, n_new: int) -> torch.Tensor:
        return greedy(self.params.tree(), prompts, self.cfg, n_new)
