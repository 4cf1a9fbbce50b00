"""Position encodings. This slice ports the sinusoidal absolute
embedding only (the recurrent and encoder-decoder archs add it); RoPE
and M-RoPE come with the dense LM slice (ROADMAP.md queue 1 item 4)."""
from __future__ import annotations

import torch


def sinusoidal_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``positions`` (any integer shape) of the Whisper-style
    sinusoidal table, (..., d) fp32: the same formula as the whole table,
    for the rows a caller needs."""
    half = d // 2
    log_base = torch.log(torch.tensor(10_000.0, dtype=torch.float32))
    freqs = torch.exp(-log_base * torch.arange(half, dtype=torch.float32)
                      / (half - 1)).to(positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_embedding(seq_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute positions (S, d), fp32."""
    return sinusoidal_rows(torch.arange(seq_len, device=device), d)
