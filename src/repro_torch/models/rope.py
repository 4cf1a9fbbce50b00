"""Position encodings: standard (neox-style, half-split) RoPE, which the
dense archs apply to q and k inside attention; M-RoPE (qwen2-vl), which
splits the rotation frequencies into (t, h, w) sections, each rotated by
its own position stream (text tokens carry t = h = w, which reduces to
1-D RoPE; vision patch embeddings their frame, row and column); and the
sinusoidal absolute embedding the recurrent and encoder-decoder archs
add to x."""
from __future__ import annotations

from typing import Optional, Tuple

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


def mrope_sections(hd: int) -> Tuple[int, int, int]:
    """The default (t, h, w) split of the half-dim (16/24/24 at hd 128,
    qwen2-vl's)."""
    half = hd // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 10_000.0,
                sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """x: (B, S, H, hd); positions3: (3, B, S) integers for (t, h, w).
    Frequency i takes the position stream of its section; the positions
    are cast to fp32 before the product with the frequencies, and the
    rotation runs in fp32 and returns x's dtype, as in :func:`apply_rope`."""
    half = x.shape[-1] // 2
    sections = sections or mrope_sections(x.shape[-1])
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    # the section of each frequency, built on the device (no host copy)
    idx = torch.arange(half, device=x.device)
    sec = (idx >= sections[0]).long() + (idx >= sections[0] + sections[1])
    pos = positions3.to(torch.float32).index_select(0, sec)  # (half,B,S)
    ang = pos.permute(1, 2, 0) * freqs                     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _rotate(x.to(torch.float32), cos, sin).to(x.dtype)


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """Text-only M-RoPE positions: t = h = w = position, (3, ...)."""
    return positions[None].expand((3,) + tuple(positions.shape))


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
