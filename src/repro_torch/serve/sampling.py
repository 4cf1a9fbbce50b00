"""Token sampling: greedy, temperature, top-k, nucleus.

The port's copy of the JAX package's ``serve/sampling.py``. The one
difference is the random source: a categorical draw takes an explicit
``torch.Generator`` from the caller (on the logits' device), never the
global RNG state, so a seeded caller replays its draws. Its streams do
not match ``jax.random``'s bitwise; they follow the same filtered
distribution.
"""
from __future__ import annotations

import torch

# Rows with temperature below this decode greedily. The per-row path
# clamps the softmax denominator to the same constant, so the greedy
# fallback must trigger at the same threshold — a row with
# 0 < t < GREEDY_EPS would otherwise sample from the clamped
# near-greedy softmax instead of decoding greedily (discontinuous at
# the boundary, and distinct from the scalar path's behaviour).
GREEDY_EPS = 1e-6


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_logits(logits: torch.Tensor, *, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Static top-k / nucleus filter over the last axis (any leading
    dims); filtered entries go to -inf. Shared by :func:`sample` and
    the speculative verify acceptance rule, which must score draft
    tokens against exactly the distribution decode would sample from.
    """
    v = logits.shape[-1]
    if top_k > 0:
        # clamp to the vocab size: top_k >= V keeps every token
        k = min(int(top_k), v)
        if k < v:
            kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
            logits = torch.where(logits < kth, -torch.inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # a cumulative sum that rounds below top_p everywhere would index
        # past the vocabulary: JAX's gather fills NaN there, which
        # filters nothing, as the smallest logit does
        cutoff_idx = torch.clamp((cum < top_p).sum(-1, keepdim=True),
                                 max=v - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return logits


def categorical(logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits) over the last axis, by the
    Gumbel-max rule (as ``jax.random.categorical``): -inf logits are
    never drawn. (..., V) -> (...) int32."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator, *,
           temperature=1.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32.

    ``temperature`` may be a python float or a per-row (B,) tensor —
    continuous batching mixes greedy and sampled requests in one
    lockstep step. Rows with temperature < ``GREEDY_EPS`` decode
    greedily (from the raw logits, so ``top_k``/``top_p`` never perturb
    a greedy row). ``generator``: the source of the draw, on the logits'
    device.
    """
    if isinstance(temperature, torch.Tensor) and temperature.ndim == 0:
        temperature = float(temperature)
    per_row = not isinstance(temperature, (int, float))
    if not per_row:
        if temperature < GREEDY_EPS:
            return greedy(logits)
        logits = logits / temperature
    else:
        t = torch.as_tensor(temperature, dtype=logits.dtype,
                            device=logits.device).expand(logits.shape[:1])
        raw = logits
        logits = logits / torch.clamp(t, min=GREEDY_EPS)[:, None]
    logits = filter_logits(logits, top_k=top_k, top_p=top_p)
    toks = categorical(logits, generator)
    if per_row:
        return torch.where(t < GREEDY_EPS, greedy(raw), toks)
    return toks
