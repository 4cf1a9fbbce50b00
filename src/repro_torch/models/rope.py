"""Position encodings: standard (neox-style, half-split) RoPE, which the
dense archs apply to q and k inside attention, and the sinusoidal
absolute embedding the recurrent and encoder-decoder archs add to x.
M-RoPE (qwen2-vl) comes with ROADMAP.md queue 1 item 7."""
from __future__ import annotations

import torch


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integers. The rotation runs in
    fp32 and returns x's dtype, as the JAX package's does."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def sinusoidal_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``positions`` (any integer shape) of the Whisper-style
    sinusoidal table, (..., d) fp32: the same formula as the whole table,
    for the rows a caller needs."""
    half = d // 2
    dev = positions.device
    # built on the positions' device: a table made on the host and
    # copied over would make every decode step wait for the card
    log_base = torch.full((), 10_000.0, dtype=torch.float32,
                          device=dev).log()
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32,
                                               device=dev) / (half - 1))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_embedding(seq_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute positions (S, d), fp32."""
    return sinusoidal_rows(torch.arange(seq_len, device=device), d)
